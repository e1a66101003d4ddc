"""Carry-over between the JAX reference and the port: constants in, outputs out.

`params_from_numpy` turns the front end's constant tables, given as numpy
arrays (the port's own copies, or the JAX package's in a parity test), into
the `OrbParams` the port's kernels and their plain versions read: the resize
taps of every pyramid level, the orientation weights, the per-angle-bin
steered-BRIEF offsets, the level layout and the `OrbConfig` values. They are
this slice's "weights": uploaded once per (config, image size, device) and
reused by every frame.

`features_to_numpy` gives any NamedTuple of tensors (the port's `Features`,
`FrameData`) back as a dict of numpy arrays for comparison with the JAX
package's outputs.

`map_from_numpy` / `map_to_numpy` and `frame_from_numpy` carry the tracking
state across: every `KeyFrames` and `MapPoints` field plus the `n_kf` /
`n_mp` cursors, and every `FrameData` field. `problem_from_numpy` /
`problem_to_numpy` do the same for a bundle-adjustment problem (`BADense`).
`vocab_from_numpy` takes a vocabulary's unpacked centres (the reference
holds them as 0/1 bytes) and packs them LSB-first for the port;
`db_from_numpy` / `db_to_numpy` carry a keyframe database and
`loop_edges_from_numpy` the loop closer's accepted edges.
The "from" functions read any object with the same attribute names whose
leaves `np.asarray` accepts, so a map, frame or problem built by the JAX
package feeds the port directly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import OrbConfig


class OrbParams(NamedTuple):
    """Device-resident constants and layout of one (OrbConfig, H, W)."""

    cfg: OrbConfig
    shapes: tuple         # ((h_l, w_l), ...) per level
    offsets: tuple        # pixel offset of level l in the flat pyramid buffer
    total: int            # pixels of all levels
    grids: tuple          # ((gy_l, gx_l), ...) cells per level
    cell_offsets: tuple   # first cell of level l in the flat cell list
    n_cells: int          # cells of all levels
    budgets: tuple        # keypoints per level (OrbConfig.features_per_level)
    kp_offsets: tuple     # first keypoint slot of level l
    tap_offsets: tuple    # (row_tap_off, col_tap_off) of level l >= 1 (0 at l = 0)
    level_table: torch.Tensor     # [L, 8] i32: h, w, pix_off, gy, gx, cell_off, budget, kp_off
    scales: torch.Tensor          # [L] f32 scale_factor ** l
    tap_idx: torch.Tensor         # [n_taps, 2] i32 source rows/cols of each output row/col
    tap_w: torch.Tensor           # [n_taps, 2] f32 their weights
    blur_taps: torch.Tensor       # [7] f32 Gaussian blur taps
    orient_weights: torch.Tensor  # [RAW_PATCH**2, 2] f32 (m01: dy, m10: dx) over the r=15 disc
    brief_offsets: torch.Tensor   # [bins, 256, 2, 2] i8 (bin, pair, endpoint, (dy, dx))

    @property
    def n_levels(self) -> int:
        return len(self.shapes)

    @property
    def n_features(self) -> int:
        return sum(self.budgets)

    def require_device(self, device: torch.device) -> None:
        """Raise unless every table lies on `device` (a kernel would read a
        foreign pointer)."""
        for name, t in self._asdict().items():
            if isinstance(t, torch.Tensor) and t.device != device:
                raise ValueError(f"params.{name} is on {t.device}, the data on {device}")


def taps_from_matrix(R: np.ndarray):
    """[n_out, n_in] bilinear resize matrix (at most two non-zeros a row) ->
    (idx [n_out, 2] i32, w [n_out, 2] f32) with the matrix's own values, so a
    kernel's w0 * a + w1 * b uses exactly the weights of `R @ x`. A clamped
    edge row (one non-zero, the two taps summed) gets (i, i) and (w, 0)."""
    n_out = R.shape[0]
    idx = np.zeros((n_out, 2), np.int32)
    w = np.zeros((n_out, 2), np.float32)
    for r in range(n_out):
        nz = np.flatnonzero(R[r])
        if not 1 <= len(nz) <= 2:
            raise ValueError(f"row {r} of the resize matrix has {len(nz)} taps")
        idx[r] = (nz[0], nz[-1])
        w[r] = (R[r, nz[0]], R[r, nz[-1]] if len(nz) == 2 else 0.0)
    return idx, w


def params_from_numpy(
    cfg: OrbConfig,
    hw,
    *,
    shapes,
    resize_matrices,
    blur_taps: np.ndarray,
    orient_weights: np.ndarray,
    brief_offsets: np.ndarray,
    device,
) -> OrbParams:
    """Upload the front end's constants for images of size `hw` to `device`.

    shapes: per-level (h, w) (`pyramid.level_shapes`);
    resize_matrices: [(Ry_l, Rx_l) for l in 1..L-1], level l-1 -> l
        (`pyramid._resize_matrix`);
    blur_taps: [7] (`pyramid.gaussian_kernel_1d()`);
    orient_weights: [P*P, 2] (`brief._orientation_weights(RAW_PATCH)`);
    brief_offsets: [bins, 256, 2, 2] rounded, clipped steered-pattern
        offsets (`brief._brief_offsets`).
    """
    shapes = tuple((int(h), int(w)) for h, w in shapes)
    L = cfg.n_levels
    if len(shapes) != L or len(resize_matrices) != L - 1:
        raise ValueError("shapes / resize_matrices do not match cfg.n_levels")
    if tuple(shapes[0]) != tuple(hw):
        raise ValueError(f"level 0 shape {shapes[0]} != image size {tuple(hw)}")
    budgets = tuple(cfg.features_per_level())
    cell = cfg.cell_size
    offsets, grids, cell_offsets, kp_offsets = [], [], [], []
    pix = cells = kps = 0
    for (h, w), k in zip(shapes, budgets):
        offsets.append(pix)
        cell_offsets.append(cells)
        kp_offsets.append(kps)
        gy, gx = -(-h // cell), -(-w // cell)
        grids.append((gy, gx))
        pix += h * w
        cells += gy * gx
        kps += k
    idx_parts, w_parts, tap_offsets = [], [], [(0, 0)]
    n_taps = 0
    for lvl, (Ry, Rx) in enumerate(resize_matrices, start=1):
        h, w = shapes[lvl]
        hp, wp = shapes[lvl - 1]
        if Ry.shape != (h, hp) or Rx.shape != (w, wp):
            raise ValueError(f"resize matrices of level {lvl} have the wrong shape")
        ry_i, ry_w = taps_from_matrix(np.asarray(Ry))
        rx_i, rx_w = taps_from_matrix(np.asarray(Rx))
        tap_offsets.append((n_taps, n_taps + h))
        idx_parts += [ry_i, rx_i]
        w_parts += [ry_w, rx_w]
        n_taps += h + w
    table = np.array(
        [[h, w, offsets[l], grids[l][0], grids[l][1], cell_offsets[l],
          budgets[l], kp_offsets[l]] for l, (h, w) in enumerate(shapes)],
        np.int32,
    )
    dev = torch.device(device)
    tap_idx = np.concatenate(idx_parts) if idx_parts else np.zeros((0, 2), np.int32)
    tap_w = np.concatenate(w_parts) if w_parts else np.zeros((0, 2), np.float32)
    return OrbParams(
        cfg=cfg, shapes=shapes, offsets=tuple(offsets), total=pix,
        grids=tuple(grids), cell_offsets=tuple(cell_offsets), n_cells=cells,
        budgets=budgets, kp_offsets=tuple(kp_offsets), tap_offsets=tuple(tap_offsets),
        level_table=torch.from_numpy(table).to(dev),
        scales=torch.tensor(cfg.scales(), dtype=torch.float32, device=dev),
        tap_idx=torch.from_numpy(tap_idx).to(dev),
        tap_w=torch.from_numpy(tap_w).to(dev),
        blur_taps=torch.from_numpy(np.asarray(blur_taps, np.float32).copy()).to(dev),
        orient_weights=torch.from_numpy(
            np.ascontiguousarray(orient_weights, np.float32)).to(dev),
        brief_offsets=torch.from_numpy(
            np.ascontiguousarray(brief_offsets).astype(np.int8)).to(dev),
    )


def features_to_numpy(nt) -> dict:
    """NamedTuple of tensors (`Features`, `FrameData`) -> {field: numpy
    array} on the host."""
    return {
        k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
        for k, v in nt._asdict().items()
    }


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def map_from_numpy(m, device="cpu"):
    """A MapState on `device` from `map_to_numpy`'s dict or from any map with
    the port's field names (`m.kf.<field>`, `m.mp.<field>`, `m.n_kf`,
    `m.n_mp`), e.g. the JAX one."""
    from .mapstate import mapstate as ms  # ops.orb imports this module

    if isinstance(m, dict):
        kf_d, mp_d, n_kf, n_mp = m["kf"], m["mp"], m["n_kf"], m["n_mp"]
    else:
        kf_d = {f: getattr(m.kf, f) for f in ms.KeyFrames._fields}
        mp_d = {f: getattr(m.mp, f) for f in ms.MapPoints._fields}
        n_kf, n_mp = m.n_kf, m.n_mp
    kf = ms.KeyFrames(*(_tensor(kf_d[f], device) for f in ms.KeyFrames._fields))
    mp = ms.MapPoints(*(_tensor(mp_d[f], device) for f in ms.MapPoints._fields))
    cursor = lambda v: torch.tensor(int(np.asarray(v)), dtype=torch.int32, device=device)  # noqa: E731
    return ms.MapState(kf, mp, cursor(n_kf), cursor(n_mp))


def map_to_numpy(m) -> dict:
    """{"kf": {field: array}, "mp": {field: array}, "n_kf": int, "n_mp": int}."""
    return dict(kf=features_to_numpy(m.kf), mp=features_to_numpy(m.mp),
                n_kf=int(m.n_kf), n_mp=int(m.n_mp))


def frame_from_numpy(fd, device="cpu"):
    """A FrameData on `device` from any frame with its field names."""
    from .frontend.frame import FrameData  # ops.orb imports this module

    return FrameData(*(_tensor(getattr(fd, f), device) for f in FrameData._fields))


def problem_from_numpy(pb, device="cpu"):
    """A `BADense` on `device` from `problem_to_numpy`'s dict or any object
    with its field names (the JAX one); absent pm_src / pm_ok stay None."""
    from .optim.ba_dense import BADense  # ops.orb imports this module

    get = (lambda f: pb.get(f)) if isinstance(pb, dict) else (lambda f: getattr(pb, f, None))
    return BADense(*(None if get(f) is None else _tensor(get(f), device)
                     for f in BADense._fields))


def problem_to_numpy(pb) -> dict:
    """{field: numpy array or None} of a `BADense`."""
    return {k: (None if v is None else v.detach().cpu().numpy()) for k, v in pb._asdict().items()}


def vocab_from_numpy(voc, device="cpu"):
    """A port `Vocabulary` from any object with the reference's fields
    (`word_bits` [W, 256] 0/1, `idf`, optional `group_bits` / `child_idx`)."""
    from .place import vocab as vocab_mod

    get = lambda f: None if getattr(voc, f, None) is None else np.asarray(getattr(voc, f))  # noqa: E731
    return vocab_mod.from_bits(get("word_bits"), get("idf"), get("group_bits"),
                               get("child_idx"), device)


def db_from_numpy(db, device="cpu"):
    """A `BowDatabase` from `db_to_numpy`'s dict or any object with `bow`, `valid`."""
    from .place.database import BowDatabase

    get = (lambda f: db[f]) if isinstance(db, dict) else (lambda f: getattr(db, f))
    return BowDatabase(_tensor(get("bow"), device), _tensor(get("valid"), device))


def db_to_numpy(db) -> dict:
    return dict(bow=db.bow.detach().cpu().numpy(), valid=db.valid.detach().cpu().numpy())


def loop_edges_from_numpy(le, device="cpu"):
    """A `LoopEdges` from any object with its fields (the reference's)."""
    from .loop.loop_closing import LoopEdges

    return LoopEdges(*(_tensor(getattr(le, f), device) for f in LoopEdges._fields))
