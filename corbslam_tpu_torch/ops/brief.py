"""Keypoint orientation (intensity centroid) + steered BRIEF-256
(port of `corbslam_tpu/ops/brief.py`, patch-based forms).

The angle is atan2(m01, m10) over the radius-15 disc of the raw 32x32 patch.
Steering is quantized to 16 angle bins: bin = round_half_even((angle mod 2pi)
/ 2pi * 16) mod 16, and each bin has its own table of rounded, +-19-clipped
rotated pattern offsets. Bit i is `p0 < p1` on the blurred level, packed
LSB-first.

`BRIEF_PATTERN` is regenerated here from the same seeded numpy generator as
the reference (tests/test_torch_scaffold.py checks it is identical).

`describe` is the wrapper of kernel K3 (`csrc/orb_describe.cu`): patches,
orientation and descriptor of every keypoint of every level and image in one
launch on a CUDA input (a warp a keypoint slot; the moment weights of
`_orientation_weights` are computed in the kernel), `describe_plain` on a
CPU input.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels
from ..interop import OrbParams
from .descriptors import pack_bits
from .fast import Keypoints
from .patches import keypoint_patches
from .pyramid import Pyramid

PATCH_RADIUS = 15  # orientation disc radius (reference HALF_PATCH_SIZE)
BRIEF_RADIUS = 13  # pattern coords within +-13 before rotation
N_BITS = 256
N_ANGLE_BINS = 16  # rotated-BRIEF steering quantization (22.5 deg steps)
RAW_PATCH = 32     # raw-image patch (orientation moments + stereo SAD)
BRIEF_PATCH = 40   # blurred-image patch (rotated BRIEF sampling)

TWO_PI = 2.0 * math.pi  # as a Python float, rounded to f32 where it meets f32


def _make_pattern(seed: int = 42) -> np.ndarray:
    """[256, 2, 2] int32 (pair, point, (y, x)) ~ N(0, (r/2.5)^2), clipped."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, BRIEF_RADIUS / 2.5, size=(N_BITS, 2, 2))
    return np.clip(np.round(pts), -BRIEF_RADIUS, BRIEF_RADIUS).astype(np.int32)


BRIEF_PATTERN = _make_pattern()


def _orientation_weights(patch: int) -> np.ndarray:
    """[patch*patch, 2] moment weights (m01: dy, m10: dx) over the circular
    radius-15 patch, keypoint at (patch//2, patch//2)."""
    c = patch // 2
    ys, xs = np.mgrid[0:patch, 0:patch]
    dy = (ys - c).astype(np.float32)
    dx = (xs - c).astype(np.float32)
    mask = (dy * dy + dx * dx <= PATCH_RADIUS * PATCH_RADIUS).astype(np.float32)
    return np.stack([(dy * mask).reshape(-1), (dx * mask).reshape(-1)], axis=-1)


def _brief_offsets(patch: int, n_bins: int) -> np.ndarray:
    """[n_bins, 256, 2, 2] int32 (bin, pair, endpoint, (dy, dx)): the pattern
    rotated by 2*pi*b/n_bins, rounded half to even and clipped to
    +-(patch//2 - 1) — the reference's steered-BRIEF table."""
    pat = BRIEF_PATTERN.astype(np.float32)
    py, px = pat[..., 0], pat[..., 1]
    lim = patch // 2 - 1
    out = np.zeros((n_bins, N_BITS, 2, 2), np.int32)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        cth, sth = np.cos(th), np.sin(th)
        out[b, ..., 1] = np.clip(np.round(px * cth - py * sth), -lim, lim)
        out[b, ..., 0] = np.clip(np.round(px * sth + py * cth), -lim, lim)
    return out


def _brief_selection(patch: int, n_bins: int) -> np.ndarray:
    """[patch*patch, n_bins*512] one-hot form of `_brief_offsets` (column
    b*512 + 2*i + e selects pair i, endpoint e of bin b), as the reference
    builds it for its selection matmul."""
    c = patch // 2
    offs = _brief_offsets(patch, n_bins)
    sel = np.zeros((patch * patch, n_bins * 512), np.float32)
    for b in range(n_bins):
        lin = (c + offs[b, ..., 0]) * patch + (c + offs[b, ..., 1])  # [256, 2]
        cols = b * 512 + np.arange(256)[:, None] * 2 + np.arange(2)[None, :]
        sel[lin.reshape(-1), cols.reshape(-1)] = 1.0
    return sel


def orientation_from_patches(patches: torch.Tensor, weights: torch.Tensor | None = None) -> torch.Tensor:
    """[K, P, P] raw-image patches (keypoint centred) -> angle [K] rad."""
    K, P, _ = patches.shape
    if weights is None:
        weights = torch.from_numpy(_orientation_weights(P)).to(patches.device)
    m = patches.reshape(K, P * P) @ weights  # [K, 2] = (m01, m10)
    return torch.atan2(m[:, 0], m[:, 1])


def angle_bin(angle: torch.Tensor, n_bins: int = N_ANGLE_BINS) -> torch.Tensor:
    """round_half_even((angle mod 2pi) / 2pi * n_bins) mod n_bins, int64.
    The mod is the reference's floor-mod: fmod, plus 2pi where negative."""
    r = torch.fmod(angle, TWO_PI)
    r = torch.where(r < 0, r + TWO_PI, r)
    return torch.round(r / TWO_PI * n_bins).long() % n_bins


def brief_from_patches(patches: torch.Tensor, angle: torch.Tensor,
                       offsets: torch.Tensor | None = None) -> torch.Tensor:
    """[K, P, P] BLURRED patches + angle [K] -> packed uint8 [K, 32]."""
    K, P, _ = patches.shape
    if offsets is None:
        offsets = torch.from_numpy(_brief_offsets(P, N_ANGLE_BINS)).to(patches.device)
    c = P // 2
    o = offsets[angle_bin(angle, offsets.shape[0])].long()  # [K, 256, 2, 2]
    lin = (c + o[..., 0]) * P + (c + o[..., 1])             # [K, 256, 2]
    samp = patches.reshape(K, P * P).gather(1, lin.reshape(K, 512)).reshape(K, 256, 2)
    return pack_bits(samp[..., 0] < samp[..., 1])


def level_coords(kp: Keypoints, params: OrbParams, b: int, lvl: int):
    """Integer level coords (x, y) of level `lvl`'s slots of image b."""
    o, k = params.kp_offsets[lvl], params.budgets[lvl]
    gx = params.grids[lvl][1]
    cell = params.cfg.cell_size
    cid = kp.cell_id[b, o:o + k].long()
    return (cid % gx) * cell + kp.ix[b, o:o + k], (cid // gx) * cell + kp.iy[b, o:o + k]


def describe_plain(pyr: Pyramid, kp: Keypoints, params: OrbParams):
    """Plain PyTorch version of kernel K3 -> (patch [B, N, 32, 32] f32,
    angle [B, N] f32, desc [B, N, 32] u8)."""
    B = pyr.levels.shape[0]
    patch, angle, desc = [], [], []
    for b in range(B):
        p_b, a_b, d_b = [], [], []
        for lvl in range(params.n_levels):
            x, y = level_coords(kp, params, b, lvl)
            raw = keypoint_patches(pyr.level(lvl, b), x, y, RAW_PATCH)
            blur = keypoint_patches(pyr.blurred_level(lvl, b), x, y, BRIEF_PATCH)
            a = orientation_from_patches(raw, params.orient_weights)
            p_b.append(raw)
            a_b.append(a)
            d_b.append(brief_from_patches(blur, a, params.brief_offsets))
        patch.append(torch.cat(p_b))
        angle.append(torch.cat(a_b))
        desc.append(torch.cat(d_b))
    return torch.stack(patch), torch.stack(angle), torch.stack(desc)


def _describe_cuda(pyr: Pyramid, kp: Keypoints, params: OrbParams):
    dev = pyr.levels.device
    params.require_device(dev)
    B = pyr.levels.shape[0]
    N = params.n_features
    if tuple(params.brief_offsets.shape) != (N_ANGLE_BINS, N_BITS, 2, 2):
        raise ValueError("brief_offsets must be [16, 256, 2, 2]")
    kernels.check(pyr.levels, "levels", torch.float32, (B, params.total))
    kernels.check(pyr.blurred, "blurred", torch.float32, (B, params.total))
    for name in ("cell_id", "iy", "ix", "octave"):
        kernels.check(getattr(kp, name), name, torch.int32, (B, N))
    patch = torch.empty(B, N, RAW_PATCH, RAW_PATCH, dtype=torch.float32, device=dev)
    angle = torch.empty(B, N, dtype=torch.float32, device=dev)
    desc = torch.empty(B, N, 32, dtype=torch.uint8, device=dev)
    P = kernels.ptr
    kernels.launch(
        "orb_describe", "orb_describe", P(pyr.levels), P(pyr.blurred),
        P(params.level_table), P(params.brief_offsets),
        P(kp.cell_id), P(kp.iy), P(kp.ix), P(kp.octave),
        P(patch), P(angle), P(desc), B, N, params.total, params.cfg.cell_size,
    )
    return patch, angle, desc


def describe(pyr: Pyramid, kp: Keypoints, params: OrbParams):
    """Raw patches, orientation and steered BRIEF of every keypoint slot.
    Kernel K3 on a CUDA pyramid, the plain version on a CPU one."""
    if pyr.levels.is_cuda:
        return _describe_cuda(pyr, kp, params)
    if pyr.levels.device.type == "cpu":
        return describe_plain(pyr, kp, params)
    raise ValueError(f"unsupported device {pyr.levels.device}")
