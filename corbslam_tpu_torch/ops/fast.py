"""FAST-9/16 corners, 3x3 NMS and per-cell top-k selection
(port of `corbslam_tpu/ops/fast.py`).

Score = max over the 16 contiguous 9-arcs of the Bresenham ring of the arc's
weakest margin above the threshold (bright and dark), 0 when not a corner and
within 16 px of the border. NMS keeps a pixel when its score is `>=` every
neighbour's (ties survive). Selection takes each `cell` x `cell` box's best
pixel (first in row-major order on ties) and the `max_kp` best boxes, the
lower box index first on ties, as `jax.lax.top_k` orders them.

`detect_pyramid` is the wrapper of kernel K2 (`csrc/fast_cells.cu`): all
levels of both stereo images in two launches on a CUDA input (FAST, NMS and
the cell maxima over tiles of up to 64 x 32 px, then one sort a level),
`detect_pyramid_plain` on a CPU input.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..interop import OrbParams
from .pyramid import Pyramid

# Bresenham circle of radius 3 — the 16 FAST offsets (row, col), clockwise.
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # FAST-9
BORDER = 16
MAX_LEVEL_CELLS = 12288  # fast_topk keeps a level's keys and its selection in <= 224 KB
TILE_PX = (64, 32)  # the most pixels (x, y) a fast_cell_max tile spans (fast_cells.cu)


class Keypoints(NamedTuple):
    """Per-slot selection of all levels, [B, N] each (N = sum of budgets)."""

    xy: torch.Tensor       # [B, N, 2] f32 level-0 (x, y)
    resp: torch.Tensor     # [B, N] f32 FAST score after NMS
    valid: torch.Tensor    # [B, N] bool (resp > 0)
    cell_id: torch.Tensor  # [B, N] i32 cell within its level's grid
    iy: torch.Tensor       # [B, N] i32 in-cell offsets
    ix: torch.Tensor
    octave: torch.Tensor   # [B, N] i32 level


def fast_score_map(img: torch.Tensor, threshold: float, border: int = BORDER) -> torch.Tensor:
    """FAST-9 corner score per pixel, [..., H, W] f32 -> [..., H, W] f32."""
    h, w = img.shape[-2:]
    padded = F.pad(img, (3, 3, 3, 3))
    ring = torch.stack(
        [padded[..., 3 + int(dy):3 + int(dy) + h, 3 + int(dx):3 + int(dx) + w]
         for dy, dx in FAST_OFFSETS],
        dim=0,
    )  # [16, ..., H, W]
    d = ring - img[None]
    dd = torch.cat([d, d[:ARC_LEN - 1]], dim=0)  # [24, ...]
    m = dd
    m = torch.minimum(m[:-1], m[1:])   # window 2
    m = torch.minimum(m[:-2], m[2:])   # window 4
    m = torch.minimum(m[:-4], m[4:])   # window 8
    bright_min = torch.minimum(m[:16], dd[8:24])
    M = dd
    M = torch.maximum(M[:-1], M[1:])
    M = torch.maximum(M[:-2], M[2:])
    M = torch.maximum(M[:-4], M[4:])
    dark_max = torch.maximum(M[:16], dd[8:24])
    bright_score = bright_min.amax(dim=0) - threshold
    dark_score = -dark_max.amin(dim=0) - threshold
    score = torch.clamp_min(torch.maximum(bright_score, dark_score), 0.0)
    b = max(border, 3)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    return torch.where(interior, score, torch.zeros((), device=img.device))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep scores >= the max of their 3x3 neighbourhood (outside = -inf)."""
    shp = score.shape
    s4 = score.reshape(-1, 1, *shp[-2:])
    neigh = F.max_pool2d(s4, 3, stride=1, padding=1).reshape(shp)
    return torch.where(score >= neigh, score, torch.zeros((), device=score.device))


def select_keypoints_cells(score: torch.Tensor, cell: int, max_kp: int) -> dict:
    """Per-cell argmax + global top-k over cells of one [H, W] score map.
    Returns the same fields as the reference (xy in level pixels)."""
    h, w = score.shape
    ph = (cell - h % cell) % cell
    pw = (cell - w % cell) % cell
    s = F.pad(score, (0, pw, 0, ph))
    gy, gx = (h + ph) // cell, (w + pw) // cell
    tiles = s.reshape(gy, cell, gx, cell).permute(0, 2, 1, 3).reshape(gy * gx, cell * cell)
    best_val, best_in_cell = tiles.max(dim=1)
    k = min(max_kp, gy * gx)
    order = torch.sort(best_val, descending=True, stable=True).indices[:k]
    top_val = best_val[order]
    top_cell = order.to(torch.int32)
    inside = best_in_cell[order].to(torch.int32)
    iy, ix = inside // cell, inside % cell
    y = (top_cell // gx) * cell + iy
    x = (top_cell % gx) * cell + ix
    xy = torch.stack([x, y], dim=-1).to(torch.float32)
    valid = top_val > 0.0
    if k < max_kp:
        pad = max_kp - k
        z = lambda t: torch.cat([t, torch.zeros((pad, *t.shape[1:]), dtype=t.dtype, device=t.device)])
        xy, top_val, valid, top_cell, iy, ix = map(z, (xy, top_val, valid, top_cell, iy, ix))
    return {"xy": xy, "resp": top_val, "valid": valid, "cell_id": top_cell,
            "iy": iy, "ix": ix, "grid_hw": (gy, gx)}


def detect_cells(img, threshold, cell, max_kp, min_threshold=None) -> dict:
    """FAST + NMS + cell selection on one level. As in the reference, the
    score uses `min_threshold` when given and `threshold` is then unused."""
    lo = threshold if min_threshold is None else min_threshold
    return select_keypoints_cells(nms3x3(fast_score_map(img, lo)), cell, max_kp)


def detect_pyramid_plain(pyr: Pyramid, params: OrbParams) -> Keypoints:
    """Plain PyTorch version of kernel K2 over all levels of [B] images."""
    cfg = params.cfg
    B = pyr.levels.shape[0]
    per_b = []
    for b in range(B):
        fields = {k: [] for k in Keypoints._fields}
        for lvl in range(params.n_levels):
            det = detect_cells(pyr.level(lvl, b), cfg.ini_th_fast, cfg.cell_size,
                               params.budgets[lvl], cfg.min_th_fast)
            fields["xy"].append(det["xy"] * params.scales[lvl])
            fields["resp"].append(det["resp"])
            fields["valid"].append(det["valid"])
            fields["cell_id"].append(det["cell_id"])
            fields["iy"].append(det["iy"])
            fields["ix"].append(det["ix"])
            fields["octave"].append(torch.full((params.budgets[lvl],), lvl,
                                               dtype=torch.int32, device=pyr.levels.device))
        per_b.append([torch.cat(fields[k]) for k in Keypoints._fields])
    return Keypoints(*[torch.stack(f) for f in zip(*per_b)])


def _detect_pyramid_cuda(pyr: Pyramid, params: OrbParams) -> Keypoints:
    cfg = params.cfg
    if not 1 <= cfg.cell_size <= 16:
        raise ValueError(f"the fast_cells kernel takes cells of at most 16x16, not "
                         f"{cfg.cell_size}")
    dev = pyr.levels.device
    params.require_device(dev)
    B = pyr.levels.shape[0]
    kernels.check(pyr.levels, "levels", torch.float32, (B, params.total))
    N, C, L = params.n_features, params.n_cells, params.n_levels
    cell = cfg.cell_size
    tcx, tcy = TILE_PX[0] // cell, TILE_PX[1] // cell
    n_tiles = sum(-(-gx // tcx) * -(-gy // tcy) for gy, gx in params.grids)
    cell_val = torch.empty(B, C, dtype=torch.float32, device=dev)
    cell_arg = torch.empty(B, C, dtype=torch.int32, device=dev)
    P = kernels.ptr
    kernels.launch(
        "fast_cells", "fast_cell_max", P(pyr.levels), P(params.level_table),
        P(cell_val), P(cell_arg), L, B, params.total, float(cfg.min_th_fast), C, cell,
        tcx, tcy, n_tiles,
    )
    xy = torch.empty(B, N, 2, dtype=torch.float32, device=dev)
    resp = torch.empty(B, N, dtype=torch.float32, device=dev)
    valid = torch.empty(B, N, dtype=torch.bool, device=dev)
    cell_id, iy, ix, octave = (torch.empty(B, N, dtype=torch.int32, device=dev) for _ in range(4))
    max_cells = max(gy * gx for gy, gx in params.grids)
    if max_cells > MAX_LEVEL_CELLS:
        raise ValueError(f"fast_topk holds at most {MAX_LEVEL_CELLS} cells a level")
    kernels.launch(
        "fast_cells", "fast_topk", P(cell_val), P(cell_arg), P(params.level_table),
        P(params.scales), P(xy), P(resp), P(valid), P(cell_id), P(iy), P(ix), P(octave),
        L, B, C, N, max_cells, cell,
    )
    return Keypoints(xy, resp, valid, cell_id, iy, ix, octave)


def detect_pyramid(pyr: Pyramid, params: OrbParams) -> Keypoints:
    """FAST + NMS + per-cell top-k over every level of every image.
    Kernel K2 on a CUDA pyramid, the plain version on a CPU one."""
    if pyr.levels.is_cuda:
        return _detect_pyramid_cuda(pyr, params)
    if pyr.levels.device.type == "cpu":
        return detect_pyramid_plain(pyr, params)
    raise ValueError(f"unsupported device {pyr.levels.device}")
