"""Image pyramid + Gaussian blur (port of `corbslam_tpu/ops/pyramid.py`).

Level l is resized from level l-1 by half-pixel bilinear taps
(`_resize_matrix`, the exact weights of the reference) and every level gets a
7-tap sigma=2 separable blur with reflect padding. All levels of a batch of
images live in one flat f32 buffer [B, T] with a per-level pixel offset
(`Pyramid`), so the FAST and descriptor kernels address any level of either
stereo image in one launch.

`build_pyramid` is the wrapper of kernel K1 (`csrc/pyramid.cu`): a CUDA
input makes one launch that writes every level (level 0 included) and every
blurred level, a CTA per tile of the image computing the cone of pixels its
share of every level needs (`cone_plan`); a CPU input runs
`build_pyramid_plain`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..interop import OrbParams, taps_from_matrix

BLUR_SIZE = 7
BLUR_SIGMA = 2.0


class Pyramid(NamedTuple):
    levels: torch.Tensor   # [B, T] f32, level l at [:, off_l : off_l + h_l * w_l]
    blurred: torch.Tensor  # [B, T] f32, blurred levels, same layout
    shapes: tuple          # ((h_l, w_l), ...)
    offsets: tuple         # (off_l, ...)

    def level(self, lvl: int, b: int = 0) -> torch.Tensor:
        h, w = self.shapes[lvl]
        o = self.offsets[lvl]
        return self.levels[b, o:o + h * w].view(h, w)

    def blurred_level(self, lvl: int, b: int = 0) -> torch.Tensor:
        h, w = self.shapes[lvl]
        o = self.offsets[lvl]
        return self.blurred[b, o:o + h * w].view(h, w)


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (h, w) sizes, mirroring inv_scale^level."""
    out = []
    for lvl in range(n_levels):
        s = 1.0 / (scale ** lvl)
        out.append((max(int(round(h * s)), 16), max(int(round(w * s)), 16)))
    return out


@lru_cache(maxsize=None)
def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation weights (align_corners=False,
    the half-pixel convention cv::resize / jax.image.resize use)."""
    x = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    i0 = np.clip(np.floor(x).astype(np.int32), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    f = np.clip(x - i0, 0.0, 1.0).astype(np.float32)
    R = np.zeros((n_out, n_in), np.float32)
    np.add.at(R, (np.arange(n_out), i0), 1.0 - f)
    np.add.at(R, (np.arange(n_out), i1), f)
    R.flags.writeable = False
    return R


def gaussian_kernel_1d(size: int = BLUR_SIZE, sigma: float = BLUR_SIGMA) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """[..., H, W] -> [..., h, w] bilinear as Ry @ img @ Rx^T (plain)."""
    h_in, w_in = img.shape[-2:]
    h_out, w_out = out_hw
    Ry = torch.from_numpy(_resize_matrix(h_out, h_in).copy()).to(img.device)
    Rx = torch.from_numpy(_resize_matrix(w_out, w_in).copy()).to(img.device)
    return (Ry @ img) @ Rx.T


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of a length-n axis padded by `pad` on each side, mode reflect
    (edge not repeated, as jnp.pad(mode="reflect"))."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def gaussian_blur(img: torch.Tensor, size: int = BLUR_SIZE, sigma: float = BLUR_SIGMA) -> torch.Tensor:
    """Separable Gaussian blur with reflect padding over the last two axes,
    horizontal pass first, taps added in the reference's order (plain)."""
    k = [float(v) for v in gaussian_kernel_1d(size, sigma)]
    pad = size // 2
    h, w = img.shape[-2:]
    xp = img.index_select(-1, _reflect_index(w, pad, img.device))
    acc = k[0] * xp[..., :, 0:w]
    for i in range(1, size):
        acc = acc + k[i] * xp[..., :, i:i + w]
    yp = acc.index_select(-2, _reflect_index(h, pad, img.device))
    acc2 = k[0] * yp[..., 0:h, :]
    for i in range(1, size):
        acc2 = acc2 + k[i] * yp[..., i:i + h, :]
    return acc2


def build_pyramid_plain(imgs: torch.Tensor, params: OrbParams) -> Pyramid:
    """Plain PyTorch version of kernel K1 on [B, H, W] f32 images."""
    B = imgs.shape[0]
    levels = torch.empty(B, params.total, dtype=torch.float32, device=imgs.device)
    blurred = torch.empty_like(levels)
    prev = imgs
    for lvl, (h, w) in enumerate(params.shapes):
        cur = prev if lvl == 0 else resize_bilinear(prev, (h, w))
        o = params.offsets[lvl]
        levels[:, o:o + h * w] = cur.reshape(B, h * w)
        blurred[:, o:o + h * w] = gaussian_blur(cur).reshape(B, h * w)
        prev = cur
    return Pyramid(levels, blurred, params.shapes, params.offsets)


CONE_TILE = (64, 114)  # level-0 rows and columns a K1 CTA owns, about (1241x376: 6 x 11 tiles)
CONE_THREADS = 512     # threads of a K1 CTA (csrc/pyramid.cu THREADS)
CONE_HX = 3            # adjacent columns a K1 thread blurs across (csrc/pyramid.cu HX)
_PLANS: dict = {}


@lru_cache(maxsize=None)
def cone_plan(shapes) -> tuple:
    """K1's plan for levels of `shapes`: (plan [nty + ntx + 1, L, 8] int32,
    nty, ntx, cap_a, cap_b, cap_t, cap_taps).

    The image is cut into nty x ntx tiles (CONE_TILE); tile (ty, tx) owns
    at level l rows [ty h_l // nty, (ty + 1) h_l // nty) and the columns
    alike. Its CTA computes the owned rows and columns and the blur's 3-px
    halo and, at every level above the deepest, also the source rows and
    columns of the next level's taps over what that level computes
    (clamped to the level). Row ty of the plan holds per level (first,
    last, owned first, owned end) of those rows, where their taps start in
    the CTA's shared tap table and the multiplier ceil(2^21 / d) that
    divides by their count; row nty + tx the columns' (their taps after all
    rows' taps) and the multipliers that divide by the owned width's groups
    of CONE_HX columns and by the owned width; the last row the levels'
    table (h, w, pixel offset, first row tap, first column tap) as
    `interop.params_from_numpy` lays them out. cap_a / cap_b: the largest
    rectangle (floats, rows of odd stride) of an even / odd level; cap_t: a
    level's horizontal blur pass (owned rows + 6 x owned columns); each a
    multiple of 4. cap_taps: a CTA's taps of levels 1.."""
    L = len(shapes)
    h0, w0 = shapes[0]
    nty, ntx = -(-h0 // CONE_TILE[0]), -(-w0 // CONE_TILE[1])

    def axis(sizes, n_t):
        taps = [None] + [taps_from_matrix(_resize_matrix(sizes[l], sizes[l - 1]))[0]
                         for l in range(1, L)]
        out = np.zeros((n_t, L, 8), np.int32)
        for t in range(n_t):
            nxt = None
            for l in reversed(range(L)):
                n = sizes[l]
                own = (t * n // n_t, (t + 1) * n // n_t)
                lo, hi = own[0] - 3, own[1] - 1 + 3
                if nxt is not None:
                    lo, hi = min(lo, taps[l + 1][nxt[0], 0]), max(hi, taps[l + 1][nxt[1], 1])
                lo, hi = max(lo, 0), min(hi, n - 1)
                out[t, l, :4] = (lo, hi, *own)
                nxt = (lo, hi)
            span = out[t, :, 1] - out[t, :, 0] + 1
            out[t, 1:, 4] = np.cumsum(span[1:]) - span[1:]
        return out

    rows = axis([h for h, _ in shapes], nty)
    cols = axis([w for _, w in shapes], ntx)
    span = lambda a: a[..., 1] - a[..., 0] + 1  # noqa: E731
    wo = cols[..., 3] - cols[..., 2]
    mult = lambda d: np.where(d > 0, -(-(1 << 21) // np.maximum(d, 1)), 0)  # noqa: E731
    rows[..., 5] = mult(span(rows))
    cols[..., 6], cols[..., 7] = mult(-(-wo // CONE_HX)), mult(wo)
    up4 = lambda v: -(-int(v) // 4) * 4  # noqa: E731
    rect = span(rows)[:, None, :] * (span(cols) | 1)[None, :, :]  # rows of odd stride
    blur = ((rows[..., 3] - rows[..., 2] + 6)[:, None, :]
            * (cols[..., 3] - cols[..., 2])[None, :, :])
    if max(int(span(rows).max()), int(wo.max())) > CONE_THREADS:  # a thread a row / column
        raise ValueError(f"pyramid: a cone spans more than {CONE_THREADS} rows or columns")
    row_taps = int(span(rows)[:, 1:].sum(-1).max()) if L > 1 else 0
    cols[:, 1:, 4] += row_taps
    cap_taps = row_taps + (int(span(cols)[:, 1:].sum(-1).max()) if L > 1 else 0)
    table = np.zeros((1, L, 8), np.int32)
    off = n_taps = 0
    for l, (h, w) in enumerate(shapes):
        table[0, l, :5] = (h, w, off, n_taps, n_taps + h) if l else (h, w, off, 0, 0)
        off += h * w
        n_taps += (h + w) if l else 0
    return (np.concatenate([rows, cols, table]), nty, ntx, up4(rect[..., 0::2].max()),
            up4(rect[..., 1::2].max()) if L > 1 else 0, up4(blur.max()), cap_taps)


def _plan_on(shapes, device) -> torch.Tensor:
    """`cone_plan(shapes)`'s table on `device`, uploaded once."""
    key = (shapes, torch.device(device))
    if key not in _PLANS:
        _PLANS[key] = torch.from_numpy(cone_plan(shapes)[0].reshape(-1)).to(device)
    return _PLANS[key]


def _build_pyramid_cuda(imgs: torch.Tensor, params: OrbParams) -> Pyramid:
    B, H, W = imgs.shape
    dev = imgs.device
    params.require_device(dev)
    kernels.check(imgs, "imgs", torch.float32, (B, *params.shapes[0]))
    levels = torch.empty(B, params.total, dtype=torch.float32, device=dev)
    blurred = torch.empty_like(levels)
    _, nty, ntx, cap_a, cap_b, cap_t, cap_taps = cone_plan(params.shapes)
    P = kernels.ptr
    kernels.launch(
        "pyramid", "build_pyramid", P(imgs), P(levels), P(blurred), P(params.tap_idx),
        P(params.tap_w), P(params.blur_taps), P(_plan_on(params.shapes, dev)), params.n_levels,
        B, params.total, H * W, nty, ntx, cap_a, cap_b, cap_t, cap_taps,
    )
    return Pyramid(levels, blurred, params.shapes, params.offsets)


def build_pyramid(imgs: torch.Tensor, params: OrbParams) -> Pyramid:
    """[B, H, W] f32 images -> Pyramid of all levels and blurred levels.
    Kernel K1 on a CUDA input, the plain version on a CPU input."""
    if imgs.is_cuda:
        return _build_pyramid_cuda(imgs, params)
    if imgs.device.type == "cpu":
        return build_pyramid_plain(imgs, params)
    raise ValueError(f"unsupported device {imgs.device}")
