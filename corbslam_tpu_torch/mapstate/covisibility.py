"""Covisibility and local-map selection derived from the observation table
(port of `corbslam_tpu/mapstate/covisibility.py`: `point_mask_of_kf`,
`local_map_mask`, `compact_indices`, `dedupe_candidate_weights`,
`anchor_candidates`, `candidate_covis_weights`, `top_covisible_of`).

The `*_plain` functions are the plain PyTorch versions. On the tracking path
they run inside the local-map kernel K7 (`csrc/local_map.cu`), launched by
`frontend.track_ops.local_map_window`, together with the candidate keyframes
and the frustum test. On a CUDA map the mapping stages' calls launch K7 too:
`top_covisible_of` its first four kernels, `local_map_mask` its window
scatter, `compact_indices` its compaction (counted as "covisibility").
Loop closing adds `covis_weights_single`, `covis_weights_matrix_rows`,
`covis_groups_rows`, `spanning_parents`, and `obs_matrix` / `covis_matrix`:
the full [N, N] shared-point count, which kernel K11 (`csrc/pose_graph.cu`,
counted as "covis_matrix") computes from the observation table without
building the [N, M] incidence matrix.
"""

from __future__ import annotations

import torch

from .. import kernels
from .mapstate import MapState

N_ANCHOR = 112  # anchor keyframes of the query's points in the candidate window
N_RECENT = 47   # newest keyframes in the candidate window
SELF_WEIGHT_PINNED = 2 ** 30  # `self_weight` that ranks the query keyframe first


def topk_stable(vals: torch.Tensor, k: int):
    """`lax.top_k` order along the last axis: descending, lower index first
    on ties."""
    v, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def scatter_mask(idx: torch.Tensor, ok: torch.Tensor, size: int) -> torch.Tensor:
    """[size] bool: True at idx[ok] (the reference's `.at[where(ok, idx, 0)].max(ok)`)."""
    mask = torch.zeros(size, dtype=torch.uint8, device=idx.device)
    src = ok.reshape(-1).to(torch.uint8)
    mask.scatter_reduce_(0, torch.where(ok, idx, torch.zeros_like(idx)).reshape(-1).long(), src,
                         "amax")
    return mask.bool()


def local_map_mask_plain(m: MapState, kf_rows: torch.Tensor, kf_ok: torch.Tensor) -> torch.Tensor:
    """[M] mask of valid map points observed by any of the given keyframes
    (UpdateLocalPoints, Tracking.cc:1230)."""
    r = kf_rows.long()
    idx = m.kf.mp_idx[r]  # [K, F]
    ok = (idx >= 0) & m.kf.fvalid[r] & kf_ok[:, None]
    return scatter_mask(idx, ok, m.mp.capacity) & m.mp.valid


def local_map_mask(m: MapState, kf_rows: torch.Tensor, kf_ok: torch.Tensor) -> torch.Tensor:
    """`local_map_mask_plain` (K7's window scatter on a CUDA map)."""
    if not kf_rows.is_cuda:
        if kf_rows.device.type != "cpu":
            raise ValueError(f"unsupported device {kf_rows.device}")
        return local_map_mask_plain(m, kf_rows, kf_ok)
    N, F, M = m.kf.capacity, m.kf.n_features, m.mp.capacity
    K = kf_rows.shape[0]
    dev = kf_rows.device
    chk = kernels.check
    chk(kf_rows, "kf_rows", torch.int32, (K,), dev)
    chk(kf_ok, "kf_ok", torch.bool, (K,), dev)
    chk(m.kf.mp_idx, "kf.mp_idx", torch.int32, (N, F), dev)
    chk(m.kf.fvalid, "kf.fvalid", torch.bool, (N, F), dev)
    chk(m.mp.valid, "mp.valid", torch.bool, (M,), dev)
    out = torch.empty(M, dtype=torch.bool, device=dev)
    p = kernels.ptr
    kernels.launch("covisibility", "local_window_mask", p(kf_rows), p(kf_ok), K, p(m.kf.mp_idx),
                   p(m.kf.fvalid), F, p(m.mp.valid), M, p(out))
    return out


def compact_indices(mask: torch.Tensor, k: int):
    """`compact_indices_plain` (K7's compaction on a CUDA mask)."""
    if not mask.is_cuda:
        if mask.device.type != "cpu":
            raise ValueError(f"unsupported device {mask.device}")
        return compact_indices_plain(mask, k)
    n = mask.shape[0]
    if k > n:
        raise ValueError(f"compact_indices: k={k} > {n} rows")
    kernels.check(mask, "mask", torch.bool, (n,), mask.device)
    rows = torch.empty(k, dtype=torch.int32, device=mask.device)
    ok = torch.empty(k, dtype=torch.bool, device=mask.device)
    work = compact_work(n, mask.device)
    kernels.launch("covisibility", "local_compact", kernels.ptr(mask), n, k, kernels.ptr(rows),
                   kernels.ptr(ok), kernels.ptr(work))
    return rows, ok


def compact_work(n: int, device) -> torch.Tensor:
    """Scratch of K7's compaction of an [n] mask: one int per 4096-row tile."""
    return torch.empty(-(-n // 4096), dtype=torch.int32, device=device)


def compact_indices_plain(mask: torch.Tensor, k: int):
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


def point_mask_of_kf(m: MapState, q: int) -> torch.Tensor:
    """[M] bool: map points observed by a valid feature of keyframe row q."""
    idx = m.kf.mp_idx[q]
    return scatter_mask(idx, (idx >= 0) & m.kf.fvalid[q], m.mp.capacity)


def anchor_candidates(m: MapState, mp_rows, ok, n_anchor: int, n_recent: int, extra_rows=()):
    """Bounded keyframe candidates for covisibility against a point set: the
    top anchor keyframes of the points (by hit count, `lax.top_k` order), the
    n_recent newest keyframes, then the extra rows. Returns (cand, cand_ok)."""
    N = m.kf.capacity
    dev = mp_rows.device
    n_anchor, n_recent = min(n_anchor, N), min(n_recent, N)
    anchors = m.mp.ref_kf[mp_rows.clamp_min(0).long()]
    hit = ok & (anchors >= 0) & (anchors < N)
    cnt = torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(hit, anchors, torch.zeros_like(anchors)).long(), hit.to(torch.int32))
    a_vals, a_rows = topk_stable(cnt, n_anchor)
    recent = m.n_kf - 1 - torch.arange(n_recent, dtype=torch.int32, device=dev)
    extra = torch.tensor(list(extra_rows), dtype=torch.int32, device=dev)
    return (torch.cat([a_rows.to(torch.int32), recent.clamp_min(0), extra]),
            torch.cat([a_vals > 0, recent >= 0, torch.ones_like(extra, dtype=torch.bool)]))


def candidate_covis_weights(m: MapState, q: int, n_anchor: int = N_ANCHOR,
                            n_recent: int = N_RECENT):
    """(cand [C], w [C]): exact shared-point counts between keyframe q and the
    bounded candidate set (C = n_anchor + n_recent + 1, q included),
    duplicates zeroed."""
    idxq = m.kf.mp_idx[q]
    okq = (idxq >= 0) & m.kf.fvalid[q]
    cand, cand_ok = anchor_candidates(m, idxq, okq, n_anchor, n_recent, [q])
    pmask = scatter_mask(idxq, okq, m.mp.capacity)
    c = cand.long()
    cidx = m.kf.mp_idx[c]
    contrib = (cidx >= 0) & m.kf.fvalid[c] & m.kf.valid[c][:, None] & cand_ok[:, None]
    w = (contrib & pmask[cidx.clamp_min(0).long()]).sum(dim=1, dtype=torch.int32)
    return cand, dedupe_candidate_weights(cand, w, cand_ok)


def top_covisible_plain(m: MapState, q: int, k: int, min_weight: int = 1, self_weight: int = 0):
    """Plain version of K7's top_covisible_of."""
    cand, w = candidate_covis_weights(m, q)
    w = torch.where(cand == q, torch.full_like(w, self_weight), w)
    vals, li = topk_stable(w, min(k, cand.shape[0]))
    rows, ok = cand[li], vals >= max(min_weight, 1)
    pad = k - rows.shape[0]
    if pad > 0:  # tiny capacities: pad to the asked size
        rows = torch.cat([rows, torch.zeros(pad, dtype=rows.dtype, device=rows.device)])
        ok = torch.cat([ok, torch.zeros(pad, dtype=torch.bool, device=ok.device)])
    return rows, ok


def _top_covisible_cuda(m: MapState, q: int, k: int, min_weight: int, self_weight: int):
    N, F, M = m.kf.capacity, m.kf.n_features, m.mp.capacity
    n_anchor, n_recent = min(N_ANCHOR, N), min(N_RECENT, N)
    C = n_anchor + n_recent + 1
    if C > 1024 or N > 12288 or not 0 <= q < N or k > 1024:
        raise ValueError(f"top_covisible_of: q={q}, k={k}, C={C}, N={N} outside the kernel's "
                         "limits (0 <= q < N <= 12288, C <= 1024, k <= 1024)")
    dev = m.kf.mp_idx.device
    for name, t, dt, shape in (("kf.mp_idx", m.kf.mp_idx, torch.int32, (N, F)),
                               ("kf.fvalid", m.kf.fvalid, torch.bool, (N, F)),
                               ("kf.valid", m.kf.valid, torch.bool, (N,)),
                               ("mp.ref_kf", m.mp.ref_kf, torch.int32, (M,)),
                               ("n_kf", m.n_kf, torch.int32, ())):
        kernels.check(t, name, dt, shape, dev)
    p = kernels.ptr

    def out(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    pmask, counts = out(M, dtype=torch.bool), out(N, dtype=torch.int32)
    kernels.launch("covisibility", "local_scatter_current", p(m.kf.mp_idx[q]), p(m.kf.fvalid[q]),
                   F, p(m.mp.ref_kf), M, N, p(pmask), p(counts))
    cand, cand_ok = out(C, dtype=torch.int32), out(C, dtype=torch.bool)
    kernels.launch("covisibility", "local_candidates", p(counts), N, p(m.n_kf), None, None, 0,
                   n_anchor, n_recent, None, q, p(cand), p(cand_ok))
    w = out(C, dtype=torch.int32)
    kernels.launch("covisibility", "local_weights", p(cand), p(cand_ok), C, N, p(m.kf.mp_idx),
                   p(m.kf.fvalid), p(m.kf.valid), F, p(pmask), p(w))
    rows, ok = out(k, dtype=torch.int32), out(k, dtype=torch.bool)
    kernels.launch("covisibility", "local_select", p(cand), p(cand_ok), p(w), C, k, q,
                   self_weight, max(min_weight, 1), p(rows), p(ok), None)
    return rows, ok


def top_covisible_of(m: MapState, q: int, k: int, min_weight: int = 1, self_weight: int = 0):
    """Top-k covisible keyframe rows of keyframe row q (a host int) over the
    candidate window, the bounded GetBestCovisibilityKeyFrames (KeyFrame.cc:276).
    `self_weight=0` leaves q out; SELF_WEIGHT_PINNED ranks q first, and then
    every copy of q in the candidate list (its anchor entry, its newest-row
    entry, the extra [q]) is taken, as in the reference. Returns (rows [k]
    i32, ok [k]). K7 on a CUDA map, the plain version on a CPU map."""
    q = int(q)
    if m.kf.mp_idx.is_cuda:
        return _top_covisible_cuda(m, q, k, min_weight, self_weight)
    if m.kf.mp_idx.device.type == "cpu":
        return top_covisible_plain(m, q, k, min_weight, self_weight)
    raise ValueError(f"unsupported device {m.kf.mp_idx.device}")


# ---------------------------------------------------------------------------
# Loop closing's covisibility
# ---------------------------------------------------------------------------

def _contrib(m: MapState) -> torch.Tensor:
    """[N, F] observations that count: a point, a valid feature, a live keyframe."""
    return (m.kf.mp_idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]


def covis_weights_single(m: MapState, q: int) -> torch.Tensor:
    """[N] i32 features of each live keyframe observing a point of keyframe q
    (q included)."""
    pmask = point_mask_of_kf(m, q)
    idx = m.kf.mp_idx
    return (_contrib(m) & pmask[idx.clamp_min(0).long()]).sum(dim=1, dtype=torch.int32)


def covis_weights_matrix_rows(m: MapState, rows) -> torch.Tensor:
    """[K, N] covis_weights_single of each given row."""
    return torch.stack([covis_weights_single(m, int(q)) for q in rows])


def covis_groups_rows(m: MapState, rows: torch.Tensor, n_group: int = 10):
    """[C, n_group] covisible-group rows of each given row (the top anchor
    keyframes of its points, `lax.top_k` order) and their ok mask."""
    N = m.kf.capacity
    r = rows.long()
    idx = m.kf.mp_idx[r]
    ok = (idx >= 0) & m.kf.fvalid[r]
    anchors = m.mp.ref_kf[idx.clamp_min(0).long()]
    hit = ok & (anchors >= 0)
    cnt = torch.zeros(rows.shape[0], N, dtype=torch.int32, device=rows.device)
    cnt.scatter_add_(1, torch.where(hit, anchors, torch.zeros_like(anchors)).long(),
                     hit.to(torch.int32))
    vals, grp = topk_stable(cnt, min(n_group, N))
    return grp.to(torch.int32), vals > 0


def spanning_parents(m: MapState) -> torch.Tensor:
    """[N] i32 parent of each live keyframe: the nearest earlier live row of
    the same client (the per-client temporal chain); -1 for a client's first
    row and for dead rows."""
    valid = m.kf.valid
    ckey = torch.where(valid, m.kf.client, torch.full_like(m.kf.client, 2 ** 30))
    order = torch.sort(ckey, stable=True)[1]
    c_s = ckey[order]
    prev = torch.cat([torch.full((1,), -1, dtype=order.dtype, device=order.device), order[:-1]])
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=order.device), c_s[1:] == c_s[:-1]])
    par_s = torch.where(same, prev, torch.full_like(prev, -1)).to(torch.int32)
    parent = torch.empty_like(par_s).scatter_(0, order, par_s)
    return torch.where(valid, parent, torch.full_like(parent, -1))


def obs_matrix(m: MapState, dtype=torch.int8) -> torch.Tensor:
    """[N, M] 0/1 incidence: keyframe n observes point p (the reference's
    B; plain-version and test use only, 268 MB at the flagship size)."""
    N, M = m.kf.capacity, m.mp.capacity
    c = _contrib(m)
    B = torch.zeros(N, M, dtype=dtype, device=c.device)
    rows = torch.arange(N, device=c.device)[:, None].expand_as(c)
    B[rows[c], m.kf.mp_idx[c].long()] = 1
    return B


def covis_matrix_plain(m: MapState, chunk: int = 8192) -> torch.Tensor:
    """[N, N] i32 shared-point counts B B^T (diagonal: each keyframe's own
    point count), one f32 product per block of `chunk` points (exact: the
    sums are integers far below 2^24)."""
    N, M = m.kf.capacity, m.mp.capacity
    c = _contrib(m)
    rows = torch.arange(N, device=c.device)[:, None].expand_as(c)[c]
    pts = m.kf.mp_idx[c].long()
    W = torch.zeros(N, N, dtype=torch.float32, device=c.device)
    for lo in range(0, M, chunk):
        sel = (pts >= lo) & (pts < lo + chunk)
        B = torch.zeros(N, min(chunk, M - lo), dtype=torch.float32, device=c.device)
        B[rows[sel], pts[sel] - lo] = 1.0
        W += B @ B.T
    return W.to(torch.int32)


COVIS_INLINE = 16  # observers of a point kept inline by K11's count (csrc/pose_graph.cu)
# The count's shared memory (227 KB a CTA on the H100) holds a row of W in
# `covis_rows` (4 N bytes) and a row's hash set of 2 F points, rounded up to
# a power of two, in `covis_push`.
COVIS_MAX_KEYFRAMES = 57344
COVIS_MAX_FEATURES = 16384
_COVIS_WORK: dict = {}


def check_capacity(n_keyframes: int, n_features: int, device) -> None:
    """Raises when the covisibility count's kernels cannot take a map of
    `n_keyframes` rows of `n_features` on `device` (the plain version takes
    any): the loop closer calls it at set-up with its map's capacity."""
    if torch.device(device).type != "cuda":
        return
    if n_keyframes > COVIS_MAX_KEYFRAMES or n_features > COVIS_MAX_FEATURES:
        raise ValueError(f"a map of {n_keyframes} keyframes x {n_features} features: the "
                         f"covisibility count takes at most {COVIS_MAX_KEYFRAMES} x "
                         f"{COVIS_MAX_FEATURES}")


def covis_workspace(device, M: int, stream: int = 0) -> torch.Tensor:
    """The covisibility count's per-point state for one stream: [2 M + 2]
    int32 zeros (observer counts, chain heads, touched points, ticket), kept
    from call to call (each call's last CTA clears what it touched), grown
    when a map has more points, dropped when a launch fails."""
    key = (torch.device(device), stream)
    work = _COVIS_WORK.get(key)
    if work is None or work.numel() < 2 * M + 2:
        work = _COVIS_WORK[key] = torch.zeros(2 * M + 2, dtype=torch.int32, device=device)
    return work


def covis_scratch_ints(N: int, F: int, M: int) -> int:
    """Ints of the count's scratch (`covis_args` in csrc/pose_graph.cu): the
    inline observers [M, COVIS_INLINE], the chain [N F], the touched points
    [min(M, N F)] and one byte an observation."""
    nf = N * F
    return M * COVIS_INLINE + nf + min(M, nf) + (nf + 3) // 4


def covis_matrix(m: MapState) -> torch.Tensor:
    """[N, N] i32 covisibility weights (shared points). K11 on a CUDA map:
    two launches (`covis_push`: each live keyframe's distinct points onto
    their observer lists; `covis_rows`: the live rows of W from those lists,
    the dead rows' zeros), each entry written once, exact in any order; the
    plain version on a CPU map."""
    idx = m.kf.mp_idx
    if not idx.is_cuda:
        if idx.device.type != "cpu":
            raise ValueError(f"unsupported device {idx.device}")
        return covis_matrix_plain(m)
    N, F = m.kf.capacity, m.kf.n_features
    dev = idx.device
    kernels.check(idx, "kf.mp_idx", torch.int32, (N, F), dev)
    kernels.check(m.kf.fvalid, "kf.fvalid", torch.bool, (N, F), dev)
    kernels.check(m.kf.valid, "kf.valid", torch.bool, (N,), dev)
    check_capacity(N, F, dev)
    return _covis_matrix_cuda(m)


def _covis_matrix_cuda(m: MapState) -> torch.Tensor:
    idx = m.kf.mp_idx
    N, F, M, dev = m.kf.capacity, m.kf.n_features, m.mp.capacity, idx.device
    p = kernels.ptr
    stream = kernels.stream()
    work = covis_workspace(dev, M, stream)
    scratch = torch.empty(covis_scratch_ints(N, F, M), dtype=torch.int32, device=dev)
    W = torch.empty(N, N, dtype=torch.int32, device=dev)
    args = (p(idx), p(m.kf.fvalid), p(m.kf.valid), N, F, M, p(work), p(scratch), p(W))
    try:
        kernels.launch("covis_matrix", "covis_push", *args)
        kernels.launch("covis_matrix", "covis_rows", *args)
    except Exception:
        # covis_push may have filled the state that covis_rows clears: the
        # next call makes a zeroed one.
        _COVIS_WORK.pop((torch.device(dev), stream), None)
        raise
    return W
