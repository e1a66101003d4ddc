"""Device programs of the collaboration layer: chunked map insertion, the
alignment transforms and the inter-map overlap detection (port of
`corbslam_tpu/collab/fusion_ops.py`: `insert_mp_chunk`, `insert_kf_chunk`,
`transform_poses`, `transform_map`, `OverlapResult`, `detect_overlap`, whose
matching half is `overlap_matches` here).

The compute half of the reference's collaboration stack: the
`MapFusion::insert*/update*` handlers (corbslam_server/src/
MapFusion.cpp:31-306), `insertServerMapToGlobleMap` :622 (every keyframe
pose and landmark into the global frame) and `detectKeyFrameInServerMap`
:660 (BoW candidates, SearchByBoWInServer, EPnP RANSAC). Entities arrive in
fixed-size chunks of flat arrays; insertion writes the used lanes' rows;
alignment is one Sim3 applied to a whole map; overlap detection runs the
loop closer's kernels across two maps: K7 (the candidate's covisible
window and its points), K5 (descriptor matching), K10's PnP RANSAC and its
weighted Horn (the Sim3 on the consensus pairs).

The insertions write the map they are given in place, like the port's
`mapstate` (each used lane once: `index_put_` with repeated rows has no
defined winner on CUDA); `transform_map` returns a new map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3, sim3
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..solvers import pnp as pnp_mod
from ..solvers import sim3_solver

# Wire chunk capacities (the reference streams 50 KFs / 2000 MPs per tick,
# MapFusion.cpp:403-407).
KF_CHUNK = 64
MP_CHUNK = 4096


# ---------------------------------------------------------------------------
# Chunked insertion
# ---------------------------------------------------------------------------

def _chunk_rows(n: torch.Tensor, use: torch.Tensor, capacity: int):
    """(rows [C] i32 with -1 for unused lanes, the used lanes, their rows
    under the capacity): used lane j goes to row n + (its rank among the
    used lanes); rows past the capacity are dropped, as the reference's
    scatter drops them."""
    offs = torch.cumsum(use.to(torch.int32), 0, dtype=torch.int32) - 1
    rows = torch.where(use, n + offs, torch.full_like(offs, -1))
    lanes = use.nonzero()[:, 0]
    tgt = rows[lanes]
    keep = tgt < capacity
    return rows, lanes[keep], tgt[keep].long()


def _put(table, lanes, tgt, **vals) -> None:
    for name, v in vals.items():
        arr = getattr(table, name)
        v = torch.as_tensor(v, device=arr.device)
        if v.dim() == 0:
            arr[tgt] = v.to(arr.dtype)
        else:
            arr[tgt] = v[lanes].to(arr.dtype)


def insert_mp_chunk(m: ms.MapState, pos, normal, desc, min_dist, max_dist, client, ref_kf,
                    use, fixed):
    """Append a chunk of map points (pos [C, 3], normal [C, 3], desc [C, 32]
    u8, min_dist / max_dist [C], client / ref_kf [C] i32, use / fixed [C]
    bool) at the cursor, in place. Returns (map, rows [C]) with rows = -1
    for unused lanes."""
    rows, lanes, tgt = _chunk_rows(m.n_mp, use, m.mp.capacity)
    _put(m.mp, lanes, tgt, pos=pos, valid=True, fixed=fixed, client=client, desc=desc,
         normal=normal, min_dist=min_dist, max_dist=max_dist, ref_kf=ref_kf, first_kf=ref_kf,
         n_visible=1, n_found=1)
    return m._replace(n_mp=m.n_mp + use.sum(dtype=torch.int32)), rows


def insert_kf_chunk(m: ms.MapState, Tcw, xy, octave, angle, desc, uright, depth, fvalid, mp_idx,
                    client, frame_id, timestamp, use, fixed):
    """Append a chunk of keyframes (Tcw [C, 4, 4], the [C, F] feature
    tables, mp_idx [C, F] already resolved to this map's rows, client /
    frame_id / timestamp [C], use / fixed [C]) at the cursor, in place.
    Returns (map, rows [C])."""
    rows, lanes, tgt = _chunk_rows(m.n_kf, use, m.kf.capacity)
    _put(m.kf, lanes, tgt, Tcw=Tcw, valid=True, fixed=fixed, client=client, frame_id=frame_id,
         timestamp=timestamp, xy=xy, octave=octave, angle=angle, desc=desc, uright=uright,
         depth=depth, fvalid=fvalid, mp_idx=mp_idx)
    return m._replace(n_kf=m.n_kf + use.sum(dtype=torch.int32)), rows


# ---------------------------------------------------------------------------
# Alignment transforms
# ---------------------------------------------------------------------------

def transform_poses(Tcw: torch.Tensor, S) -> torch.Tensor:
    """World->camera poses [..., 4, 4] after moving the world by the Sim3 S
    (p' = S(p)): Tcw' = Tcw o S^-1 with the scale folded into the
    translation (MapFusion.cpp:633 `Tcw * To2n`): with S^-1 = (Rs, ts, ss),
    R' = R Rs and t' = (R ts + t) / ss."""
    Rs, ts, ss = sim3.inverse(S)
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    out = torch.eye(4, dtype=Tcw.dtype, device=Tcw.device).expand(Tcw.shape).clone()
    out[..., :3, :3] = R @ Rs.expand(R.shape)
    out[..., :3, 3] = ((R @ ts[:, None])[..., 0] + t) / ss.clamp_min(1e-12)
    return out


def transform_map(m: ms.MapState, R: torch.Tensor, t: torch.Tensor, s: torch.Tensor):
    """A new map: `m` moved by the alignment Sim3 (R, t, s) (sub-world ->
    destination world): landmark positions p' = S(p), normals rotated,
    distance bands scaled, keyframe poses re-expressed
    (insertServerMapToGlobleMap, MapFusion.cpp:622-655)."""
    out = ms.clone(m)
    mp, kf = out.mp, out.kf
    v = mp.valid
    pos = sim3.transform((R, t, s), mp.pos)
    normal = mp.normal @ R.transpose(0, 1)
    mp.pos.copy_(torch.where(v[:, None], pos, mp.pos))
    mp.normal.copy_(torch.where(v[:, None], normal, mp.normal))
    mp.min_dist.copy_(torch.where(v, mp.min_dist * s, mp.min_dist))
    mp.max_dist.copy_(torch.where(v, mp.max_dist * s, mp.max_dist))
    kf.Tcw.copy_(torch.where(kf.valid[:, None, None], transform_poses(kf.Tcw, (R, t, s)), kf.Tcw))
    return out


# ---------------------------------------------------------------------------
# Inter-map overlap detection (detectKeyFrameInServerMap)
# ---------------------------------------------------------------------------

class OverlapResult(NamedTuple):
    R: torch.Tensor          # Sim3 sub-world -> global world
    t: torch.Tensor
    s: torch.Tensor
    n_matches: torch.Tensor  # descriptor matches
    n_inliers: torch.Tensor  # PnP inliers
    ok: torch.Tensor


class OverlapMatches(NamedTuple):
    hit: torch.Tensor     # [F] query feature matched
    X_glob: torch.Tensor  # [F, 3] its global landmark
    uv: torch.Tensor      # [F, 2] the query keypoints
    sigma2: torch.Tensor  # [F] octave sigma^2


def overlap_matches(gmap: ms.MapState, cand_row: int, sub: ms.MapState, query_row: int,
                    cfg: SlamConfig) -> OverlapMatches:
    """The query keyframe's features matched against the candidate's local
    map points (its covisible window): K7, then K5."""
    nb_rows, nb_ok = covis.top_covisible_of(gmap, cand_row, cfg.capacity.local_window_kfs,
                                            self_weight=covis.SELF_WEIGHT_PINNED)
    pmask = covis.local_map_mask(gmap, nb_rows, nb_ok)
    rows, rows_ok = covis.compact_indices(pmask, gmap.kf.n_features * 2)
    rows_l = rows.long()
    res = matcher.search_by_descriptor(sub.kf.desc[query_row], sub.kf.fvalid[query_row],
                                       gmap.mp.desc[rows_l], rows_ok,
                                       max_dist=cfg.matcher.th_low, ratio=0.75)
    X_glob = gmap.mp.pos[rows_l[res.idx.clamp_min(0).long()]].contiguous()
    sigma2 = (cfg.orb.scale_factor ** 2) ** sub.kf.octave[query_row].to(torch.float32)
    return OverlapMatches((res.idx >= 0).contiguous(), X_glob,
                          sub.kf.xy[query_row].contiguous(), sigma2.contiguous())


def detect_overlap(cam: cam_mod.Intrinsics, gmap: ms.MapState, cand_row: int, sub: ms.MapState,
                   query_row: int, cfg: SlamConfig, generator: Optional[torch.Generator] = None,
                   fix_scale: bool = True, idx: Optional[torch.Tensor] = None) -> OverlapResult:
    """Align a sub-map to the global map through one (query, candidate)
    keyframe pair (detectKeyFrameInServerMap, MapFusion.cpp:660): the query
    keyframe's features matched against the candidate's local map points
    (`overlap_matches`), PnP RANSAC for the query's pose in the global
    frame (`idx` [256, 6] overrides the draw from `generator`), then the
    weighted Horn Sim3 over the consensus's landmark pairs (the query's own
    points against the matched global ones), or, with fewer than 10 pairs,
    the SE3 of the PnP pose. Nothing is read back to the host."""
    mt = overlap_matches(gmap, cand_row, sub, query_row, cfg)
    n_matches = mt.hit.sum(dtype=torch.int32)
    pnp = pnp_mod.solve_pnp_ransac(cam, mt.X_glob, mt.uv, mt.hit, mt.sigma2,
                                   generator=generator, n_hyp=256,
                                   min_inliers=cfg.loop.min_sim3_inliers, idx=idx)

    mp_q = sub.kf.mp_idx[query_row]
    pair_ok = pnp.inliers & (mp_q >= 0)
    p_sub = sub.mp.pos[mp_q.clamp_min(0).long()].contiguous()
    R, t, s = sim3_solver.horn_sim3(mt.X_glob, p_sub, fix_scale, w=pair_ok.to(torch.float32))
    n_pairs = pair_ok.sum(dtype=torch.int32)

    T_align = se3.compose(se3.inverse(pnp.Tcw), sub.kf.Tcw[query_row])
    use_horn = n_pairs >= 10
    R = torch.where(use_horn, R, T_align[:3, :3])
    t = torch.where(use_horn, t, T_align[:3, 3])
    s = torch.where(use_horn, s, torch.ones_like(s))
    ok = (pnp.ok & (n_matches >= cfg.loop.min_bow_matches)
          & (pnp.n_inliers >= cfg.loop.min_sim3_inliers))
    return OverlapResult(R, t, s, n_matches, pnp.n_inliers, ok)
