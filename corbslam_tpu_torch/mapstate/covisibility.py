"""Local-map selection helpers derived from the observation table (port of
`corbslam_tpu/mapstate/covisibility.py`: `local_map_mask`,
`compact_indices`, `dedupe_candidate_weights`).

These are the plain PyTorch versions. On the tracking path they run inside
the local-map kernel K7 (`csrc/local_map.cu`), launched by
`frontend.track_ops.local_map_window`, together with the candidate
keyframes and the frustum test. `top_covisible_of`, `candidate_covis_weights`
and the `covis_*` functions come with local mapping.
"""

from __future__ import annotations

import torch

from .mapstate import MapState


def scatter_mask(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """[size] bool: True at idx[ok] (the reference's `.at[where(ok, idx, 0)].max(ok)`)."""
    mask = torch.zeros(size, dtype=torch.uint8, device=idx.device)
    src = ok.reshape(-1).to(torch.uint8)
    mask.scatter_reduce_(0, torch.where(ok, idx, torch.zeros_like(idx)).reshape(-1).long(), src,
                         "amax")
    return mask.bool()


def local_map_mask(m: MapState, kf_rows: torch.Tensor, kf_ok: torch.Tensor) -> torch.Tensor:
    """[M] mask of valid map points observed by any of the given keyframes
    (UpdateLocalPoints, Tracking.cc:1230)."""
    r = kf_rows.long()
    idx = m.kf.mp_idx[r]  # [K, F]
    ok = (idx >= 0) & m.kf.fvalid[r] & kf_ok[:, None]
    return scatter_mask(idx, ok, m.mp.capacity) & m.mp.valid


def compact_indices(mask: torch.Tensor, k: int):
    """Fixed-size newest-first compaction: the highest-index True rows in
    descending order, then (if fewer than k) the highest-index False rows in
    descending order. Returns (rows [k] i32, ok [k] bool). This is
    `top_k(mask * (n + 1) + row, k)` of the reference, written as the scan
    the kernel runs: each row's place is its rank from the top among the
    True rows, or the True count plus its rank among the False rows."""
    n = mask.shape[0]
    dev = mask.device
    rev = mask.flip(0)
    n_true = rev.sum()
    pos = torch.where(rev, torch.cumsum(rev, 0) - 1, n_true + torch.cumsum(~rev, 0) - 1)
    keep = pos < k
    rows = torch.zeros(k + 1, dtype=torch.int32, device=dev).scatter_(
        0, torch.where(keep, pos, torch.full_like(pos, k)),
        torch.arange(n - 1, -1, -1, dtype=torch.int32, device=dev))[:k]
    return rows, torch.arange(k, device=dev) < n_true


def dedupe_candidate_weights(cand: torch.Tensor, w: torch.Tensor, ok=None) -> torch.Tensor:
    """Zero the weight of repeated candidate rows, keeping the first VALID
    occurrence (an invalid entry, keyed -1-i, shadows nothing)."""
    C = cand.shape[0]
    ar = torch.arange(C, dtype=cand.dtype, device=cand.device)
    eff = cand if ok is None else torch.where(ok, cand, -1 - ar)
    eq = eff[:, None] == eff[None, :]
    dup = (eq & torch.ones(C, C, dtype=torch.bool, device=cand.device).tril(-1)).any(dim=1)
    return torch.where(dup, torch.zeros_like(w), w)
