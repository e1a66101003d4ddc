"""Fixed-capacity structure-of-arrays map state (port of
`corbslam_tpu/mapstate/mapstate.py`: the tables, `empty`, `insert_keyframe`,
`add_map_points`, `cull_keyframes` and `compact`).

A keyframe is a row across the `KeyFrames` tensors, a landmark a row across
`MapPoints`, and every cross-reference is an integer row. Observations live
on the keyframe side: `kf.mp_idx [N, F]` maps feature f of keyframe n to a
map-point row or `NO_MP`. `n_kf` and `n_mp` are 0-dim int32 tensors on the
map's device (allocation cursors), so inserting needs no host sync.

Where the reference donates its buffers to a jitted program, the port writes
in place: `insert_keyframe`, `add_map_points`, `cull_keyframes` and the
tracking step's counters update the tensors of the map they are given and
return a MapState that holds the same tensors: copy a map (`clone`) before
stepping it twice. `compact` returns new tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CapacityConfig

NO_MP = -1


class KeyFrames(NamedTuple):
    """SoA over keyframe slots (capacity N, features F per keyframe)."""

    Tcw: torch.Tensor        # [N, 4, 4] world->camera
    valid: torch.Tensor      # [N] slot in use
    fixed: torch.Tensor      # [N] foreign/server data
    client: torch.Tensor     # [N] i32 owning client id
    frame_id: torch.Tensor   # [N] i32 source frame number
    timestamp: torch.Tensor  # [N] f32
    xy: torch.Tensor         # [N, F, 2] undistorted pixel coords
    octave: torch.Tensor     # [N, F] i32
    angle: torch.Tensor      # [N, F] f32
    desc: torch.Tensor       # [N, F, 32] u8
    uright: torch.Tensor     # [N, F] f32 (-1 mono)
    depth: torch.Tensor      # [N, F] f32 (0 unknown)
    fvalid: torch.Tensor     # [N, F] feature slot in use
    mp_idx: torch.Tensor     # [N, F] i32 map-point row or NO_MP

    @property
    def capacity(self):
        return self.Tcw.shape[0]

    @property
    def n_features(self):
        return self.xy.shape[1]


class MapPoints(NamedTuple):
    """SoA over landmark slots (capacity M)."""

    pos: torch.Tensor        # [M, 3] world
    valid: torch.Tensor      # [M]
    fixed: torch.Tensor      # [M]
    client: torch.Tensor     # [M] i32
    desc: torch.Tensor       # [M, 32] u8 distinctive descriptor
    normal: torch.Tensor     # [M, 3] mean viewing direction (cam -> point)
    min_dist: torch.Tensor   # [M] scale-invariance band
    max_dist: torch.Tensor   # [M]
    ref_kf: torch.Tensor     # [M] i32 creating keyframe row
    first_kf: torch.Tensor   # [M] i32
    n_visible: torch.Tensor  # [M] i32 tracking statistics (IncreaseVisible)
    n_found: torch.Tensor    # [M] i32 (IncreaseFound)

    @property
    def capacity(self):
        return self.pos.shape[0]


class MapState(NamedTuple):
    kf: KeyFrames
    mp: MapPoints
    n_kf: torch.Tensor  # 0-dim i32 allocation cursor
    n_mp: torch.Tensor  # 0-dim i32


def empty(cap: CapacityConfig, device="cpu") -> MapState:
    N, F, M = cap.max_keyframes, cap.max_features, cap.max_map_points
    d = torch.device(device)
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=d)

    kf = KeyFrames(
        Tcw=torch.eye(4, dtype=f32, device=d).repeat(N, 1, 1),
        valid=z(N, dtype=torch.bool), fixed=z(N, dtype=torch.bool),
        client=z(N, dtype=i32), frame_id=z(N, dtype=i32), timestamp=z(N),
        xy=z(N, F, 2), octave=z(N, F, dtype=i32), angle=z(N, F),
        desc=z(N, F, 32, dtype=torch.uint8),
        uright=torch.full((N, F), -1.0, dtype=f32, device=d), depth=z(N, F),
        fvalid=z(N, F, dtype=torch.bool),
        mp_idx=torch.full((N, F), NO_MP, dtype=i32, device=d),
    )
    mp = MapPoints(
        pos=z(M, 3), valid=z(M, dtype=torch.bool), fixed=z(M, dtype=torch.bool),
        client=z(M, dtype=i32), desc=z(M, 32, dtype=torch.uint8), normal=z(M, 3),
        min_dist=z(M), max_dist=z(M), ref_kf=z(M, dtype=i32), first_kf=z(M, dtype=i32),
        n_visible=torch.ones(M, dtype=i32, device=d), n_found=torch.ones(M, dtype=i32, device=d),
    )
    return MapState(kf, mp, z(dtype=i32), z(dtype=i32))


def _fill(value, like: torch.Tensor, n: int) -> torch.Tensor:
    """`value` (Python scalar or tensor) as [n, *like.shape[1:]] of like's dtype."""
    v = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return v.expand(n, *like.shape[1:])


def insert_keyframe(m: MapState, Tcw, xy, octave, angle, desc, uright, depth, fvalid, mp_idx,
                    frame_id, timestamp, client: int = 0, fixed: bool = False):
    """Write one keyframe at the cursor, in place. Returns (map, kf_row).

    At capacity the write is dropped: kf_row comes back equal to the
    capacity and the cursor stays put (the reference's `mode="drop"`
    scatter), never clamped onto the last row."""
    i = m.n_kf
    N = m.kf.capacity
    keep = i < N
    row = i.clamp(max=N - 1).reshape(1).long()
    vals = dict(Tcw=Tcw, valid=True, fixed=fixed, client=client, frame_id=frame_id,
                timestamp=timestamp, xy=xy, octave=octave, angle=angle, desc=desc,
                uright=uright, depth=depth, fvalid=fvalid, mp_idx=mp_idx)
    for name, v in vals.items():
        arr = getattr(m.kf, name)
        new = _fill(v, arr, 1)
        arr.index_copy_(0, row, torch.where(keep, new, arr.index_select(0, row)))
    return m._replace(n_kf=torch.minimum(i + 1, torch.full_like(i, N))), i


def add_map_points(m: MapState, pos, desc, normal, min_dist, max_dist, ref_kf,
                   create: torch.Tensor, client: int = 0, fixed: bool = False):
    """Allocate map points at the cursor for the `create` rows, in place.

    Returns (map, rows [K] i32): the allocated row of each created entry, and
    NO_MP for skipped ones. Slots come from a masked prefix sum; allocations
    past the capacity are dropped (rows stay NO_MP, nothing is written), as
    in the reference. The K writes go to the K distinct rows
    (n_mp + j) mod M, j < K, each either a new point or its own old value, so
    no masked row lands on a live one and nothing syncs with the host."""
    K = pos.shape[0]
    M = m.mp.capacity
    if K > M:
        raise ValueError(f"add_map_points: {K} candidates exceed the capacity {M}")
    dev = pos.device
    offs = torch.cumsum(create.to(torch.int32), 0, dtype=torch.int32) - 1
    create = create & (m.n_mp + offs < M)
    rows = torch.where(create, m.n_mp + offs, torch.full_like(offs, NO_MP))
    n_new = create.sum(dtype=torch.int32)
    j = torch.arange(K, device=dev)
    src = torch.zeros(K + 1, dtype=torch.long, device=dev).scatter_(
        0, torch.where(create, offs.long(), torch.full_like(j, K)), j)[:K]
    tgt = (m.n_mp.long() + j) % M
    write = j < n_new

    vals = dict(pos=pos, valid=True, fixed=fixed, client=client, desc=desc, normal=normal,
                min_dist=min_dist, max_dist=max_dist, ref_kf=ref_kf, first_kf=ref_kf,
                n_visible=1, n_found=1)
    for name, v in vals.items():
        arr = getattr(m.mp, name)
        v = torch.as_tensor(v, device=dev)
        new = (v.to(arr.dtype)[src] if v.dim() and v.shape[0] == K else _fill(v, arr, K))
        w = write.view(K, *([1] * (arr.dim() - 1)))
        arr.index_copy_(0, tgt, torch.where(w, new, arr.index_select(0, tgt)))
    return m._replace(n_mp=m.n_mp + n_new), rows


def clone(m: MapState) -> MapState:
    """An independent copy of every table and cursor."""
    return MapState(KeyFrames(*(t.clone() for t in m.kf)), MapPoints(*(t.clone() for t in m.mp)),
                    m.n_kf.clone(), m.n_mp.clone())


def cull_keyframes(m: MapState, kill: torch.Tensor) -> MapState:
    """Invalidate the keyframes of the [N] mask `kill` (their features stop
    observing), in place."""
    m.kf.valid.logical_and_(~kill)
    m.kf.mp_idx.masked_fill_(kill[:, None], NO_MP)
    return m


class CompactResult(NamedTuple):
    m: MapState
    kf_old2new: torch.Tensor  # [N] i32 new row per old row, -1 for dropped
    mp_old2new: torch.Tensor  # [M] i32
    kf_order: torch.Tensor    # [N] old row gathered into each new row
    mp_order: torch.Tensor    # [M]


def _plan(valid: torch.Tensor):
    """Stable repack order (valid rows first), old -> new row map, count."""
    cap = valid.shape[0]
    order = torch.sort((~valid).to(torch.uint8), stable=True)[1]
    n = valid.sum(dtype=torch.int32)
    slots = torch.arange(cap, dtype=torch.int32, device=valid.device)
    new_of_old = torch.full((cap,), -1, dtype=torch.int32, device=valid.device)
    new_of_old[order] = torch.where(slots < n, slots, torch.full_like(slots, -1))
    return order, new_of_old, n


def compact(m: MapState) -> CompactResult:
    """Repack valid rows to the front, stably (surviving rows keep their
    order), and remap the cross-references: observations of dropped points
    become NO_MP, anchors of dropped keyframes become row 0. Hosts remap
    their own row references through kf_old2new / mp_old2new."""
    kf_order, kf_map, n_kf = _plan(m.kf.valid)
    mp_order, mp_map, n_mp = _plan(m.mp.valid)
    kf = KeyFrames(*(t[kf_order] for t in m.kf))
    mp = MapPoints(*(t[mp_order] for t in m.mp))
    idx = kf.mp_idx
    kf = kf._replace(mp_idx=torch.where(idx >= 0, mp_map[idx.clamp_min(0).long()],
                                        torch.full_like(idx, NO_MP)))
    mp = mp._replace(ref_kf=kf_map[mp.ref_kf.clamp_min(0).long()].clamp_min(0),
                     first_kf=kf_map[mp.first_kf.clamp_min(0).long()].clamp_min(0))
    return CompactResult(MapState(kf, mp, n_kf, n_mp), kf_map, mp_map, kf_order, mp_order)
