"""Binary (ORB/BRIEF) descriptor ops: packing, popcount, batched Hamming.

Port of `corbslam_tpu/ops/descriptors.py`. Descriptors are uint8 [..., 32]
(256 bits, LSB-first per byte). These are the plain PyTorch forms; on the
card the masked best match runs as XOR + popcount without storing the
[N, M] matrix, inside the `stereo_match` kernel (`csrc/stereo_match.cu`) for
stereo and inside the `match_masked` kernel (`csrc/match_masked.cu`, wrapped
by `matching.matcher.match_select`, since its mask is the matcher's) for
the searches of tracking.
"""

from __future__ import annotations

import torch

DESC_BYTES = 32
DESC_BITS = 256

# Max possible distance + 1; used as the "invalid" sentinel in matchers.
INF_DIST = 512

_SHIFTS = torch.arange(8, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 32] -> int8 bits [..., 256] (LSB-first per byte)."""
    shifts = _SHIFTS.to(packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], DESC_BITS).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bits [..., 256] (any integer/bool dtype, 0/1) -> uint8 [..., 32]."""
    b = bits.reshape(*bits.shape[:-1], DESC_BYTES, 8).to(torch.uint8)
    shifts = _SHIFTS.to(bits.device)
    return (b << shifts).sum(dim=-1).to(torch.uint8)


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte popcount via the SWAR bit-hack, uint8 -> int32."""
    x = x.to(torch.int32)
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def popcount_desc(packed: torch.Tensor) -> torch.Tensor:
    """Total popcount of packed descriptors [..., 32] -> [...] int32."""
    return popcount_u8(packed).sum(dim=-1, dtype=torch.int32)


def hamming_matrix(packed_a: torch.Tensor, packed_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distances [N, 32] x [M, 32] -> [N, M] int32.

    popcount(a) + popcount(b) - 2 <bits(a), bits(b)> with the product in f32,
    exact for integers this small (<= 256).
    """
    ba = unpack_bits(packed_a).to(torch.float32)
    bb = unpack_bits(packed_b).to(torch.float32)
    dot = (ba @ bb.T).to(torch.int32)
    return popcount_desc(packed_a)[:, None] + popcount_desc(packed_b)[None, :] - 2 * dot


def hamming_pairwise(packed_a: torch.Tensor, packed_b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance over matching leading shapes [..., 32]."""
    return popcount_desc(packed_a ^ packed_b)


def masked_hamming_matrix(packed_a, packed_b, valid_a=None, valid_b=None, extra_mask=None):
    """Hamming matrix with disallowed entries set to INF_DIST (`extra_mask`
    [N, M] True = allowed)."""
    d = hamming_matrix(packed_a, packed_b)
    mask = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if valid_a is not None:
        mask &= valid_a[:, None]
    if valid_b is not None:
        mask &= valid_b[None, :]
    if extra_mask is not None:
        mask &= extra_mask
    return torch.where(mask, d, torch.full_like(d, INF_DIST))


def best_match(dist: torch.Tensor, max_dist: int, ratio: float = 1.0, axis: int = 1):
    """Row-wise best match with threshold + strict Lowe ratio vs 2nd best.

    Ties go to the lower index, as `jax.lax.top_k` orders them: argmin takes
    the first minimum, and the second best is the minimum with that one
    column removed. Returns (idx [N], dist [N], ok [N]).
    """
    if axis == 0:
        dist = dist.T
    idx = torch.argmin(dist, dim=1)
    rows = torch.arange(dist.shape[0], device=dist.device)
    best_d = dist[rows, idx]
    if ratio >= 1.0:
        ratio_ok = torch.ones(best_d.shape, dtype=torch.bool, device=dist.device)
    else:
        rest = dist.clone()
        rest[rows, idx] = torch.iinfo(dist.dtype).max
        second_d = rest.min(dim=1).values
        ratio_ok = best_d.to(torch.float32) < ratio * second_d.to(torch.float32)
    ok = (best_d <= max_dist) & ratio_ok
    return idx, best_d, ok


def mutual_best(dist: torch.Tensor, max_dist: int, ratio: float = 1.0):
    """Cross-check matching: keep (i, j) only when mutually the best.
    Returns (idx_a2b [N], dist [N], ok [N])."""
    idx_ab, d_ab, ok_ab = best_match(dist, max_dist, ratio, axis=1)
    idx_ba, _, _ = best_match(dist, max_dist, 1.0, axis=0)
    mutual = idx_ba[idx_ab] == torch.arange(dist.shape[0], device=dist.device)
    return idx_ab, d_ab, ok_ab & mutual
