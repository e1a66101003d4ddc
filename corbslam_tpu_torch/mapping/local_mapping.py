"""Local mapping of the stereo tracker (port of
`corbslam_tpu/mapping/local_mapping.py`: `cull_map_points`,
`sweep_detached`, `fuse_into_kf`, `fuse_rows_into_kf`,
`select_local_ba_window`, `local_ba`, `local_ba_build`, `local_ba_writeback`,
`refresh_point_geometry`, `find_redundant_keyframes`, `cull_keyframes`) —
the device half of the reference's LocalMapping thread (LocalMapping.cc:
MapPointCulling :161, SearchInNeighbors :422, local BA :79, KeyFrameCulling
:590).

Every stage updates the map in place where the reference donates it and
returns it. The stages call into the kernels K5 (fuse's projection match),
K7 (`top_covisible_of`, `local_map_mask`, `compact_indices` on a CUDA map)
and K8 (the local BA's point-major table and LM); the rest is PyTorch.
The reference's duplicate-index `.at[].set` scatters (the fuse relabel, the
local-BA writeback) are reproduced with an explicit last-write-wins rule,
which is what XLA applies on the CPU; a trailing window whose start
`dynamic_slice` would clamp is clamped here. The fused `local_ba` (robust
then plain LM in one K8 call, then the writeback) has one caller, the
two-view BA of mono initialization.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..config import OrbConfig, SlamConfig
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..optim import ba_dense

NO_MP = ms.NO_MP
KF_DETACH_WINDOW = 16  # trailing keyframe rows scanned by the bounded passes


@lru_cache(maxsize=16)
def _scales(cfg: OrbConfig, device: str) -> torch.Tensor:
    return torch.tensor(cfg.scales(), dtype=torch.float32, device=device)


def _trailing_rows(m: ms.MapState, start) -> torch.Tensor:
    """[KW] keyframe rows start .. start + KW - 1, start clamped to
    [0, N - KW] as `dynamic_slice` does."""
    N = m.kf.capacity
    KW = min(N, KF_DETACH_WINDOW)
    base = torch.clamp(torch.as_tensor(start, device=m.n_kf.device), 0, N - KW)
    return base + torch.arange(KW, device=m.n_kf.device)


def last_wins(rows: torch.Tensor, capacity: int) -> torch.Tensor:
    """[W] for each slot, the LAST slot that targets the same row: a scatter
    of vals[last_wins(rows)] to rows writes what XLA's in-order `.at[].set`
    leaves behind, whatever order the device applies the writes in."""
    slot = torch.arange(rows.shape[0], device=rows.device)
    win = torch.full((capacity,), -1, dtype=torch.long, device=rows.device)
    win.scatter_reduce_(0, rows.long(), slot, "amax")
    return win[rows.long()]


def cull_map_points(m: ms.MapState, current_kf_row: int, cfg: SlamConfig,
                    mono: bool = False) -> ms.MapState:
    """MapPointCulling (LocalMapping.cc:161): kill recently created points
    (the trailing R = min(M, 8F) rows) whose found / visible ratio is poor or
    that gathered fewer than 3 (mono 2) observations in the trailing
    keyframe window at 2..4 keyframes of age; detach them in that window."""
    F, M = m.kf.n_features, m.mp.capacity
    R = min(M, 8 * F)
    dev = m.n_mp.device
    base = torch.clamp_min(m.n_mp - R, 0)
    rows = (base + torch.arange(R, device=dev)).long()
    rok = rows < m.n_mp
    krows = _trailing_rows(m, m.n_kf - min(m.kf.capacity, KF_DETACH_WINDOW))
    idx = m.kf.mp_idx[krows]
    contrib = (idx >= 0) & m.kf.fvalid[krows] & m.kf.valid[krows][:, None]
    take = contrib & (idx >= base)
    rel = torch.where(take, idx - base, torch.zeros_like(idx)).reshape(-1).long()
    obs = torch.zeros(R, dtype=torch.int32, device=dev).index_add_(
        0, rel, take.reshape(-1).to(torch.int32))
    ratio = m.mp.n_found[rows].to(torch.float32) / torch.clamp_min(
        m.mp.n_visible[rows].to(torch.float32), 1.0)
    age = current_kf_row - m.mp.first_kf[rows]
    min_obs = 2 if mono else 3
    bad_ratio = ratio < cfg.mapping.recent_point_min_found_ratio
    young = (age >= 2) & (age <= 4) & (obs < min_obs)
    killr = rok & m.mp.valid[rows] & ~m.mp.fixed[rows] & (bad_ratio | young)
    kill = torch.zeros(M, dtype=torch.bool, device=dev)
    kill[rows] = killr
    m.mp.valid.logical_and_(~kill)
    is_killed = (idx >= 0) & kill[idx.clamp_min(0).long()]
    m.kf.mp_idx[krows] = torch.where(is_killed, torch.full_like(idx, NO_MP), idx)
    return m


def sweep_detached(m: ms.MapState) -> ms.MapState:
    """Full-map hygiene pass: detach every observation of an invalid point."""
    idx = m.kf.mp_idx
    m.kf.mp_idx.masked_fill_((idx >= 0) & ~m.mp.valid[idx.clamp_min(0).long()], NO_MP)
    return m


def fuse_into_kf(cam, m: ms.MapState, kf_row: int, cfg: SlamConfig) -> ms.MapState:
    """SearchInNeighbors + Fuse (LocalMapping.cc:422): project the points of
    the covisible neighbours that the keyframe does not observe into it."""
    nb_rows, nb_ok = covis.top_covisible_of(m, kf_row, cfg.capacity.local_window_kfs)
    pmask = covis.local_map_mask(m, nb_rows, nb_ok) & ~covis.point_mask_of_kf(m, kf_row)
    rows, rows_ok = covis.compact_indices(pmask, m.kf.n_features * 2)
    return fuse_rows_into_kf(cam, m, kf_row, rows, rows_ok, cfg)


def fuse_rows_into_kf(cam, m: ms.MapState, kf_row: int, rows, rows_ok, cfg: SlamConfig,
                      radius: float = 3.0, full_relabel: bool = False) -> ms.MapState:
    """Core of ORBmatcher::Fuse: project `rows` into keyframe `kf_row` (K5,
    ratio 1.0, any viewing angle), bind hits on unbound features, and merge
    each duplicate pair (a feature bound to another point) into the older
    row: the newer is killed, its counters folded into the survivor, and its
    observations relabelled in the trailing keyframe window (or the whole
    table with `full_relabel`)."""
    M = m.mp.capacity
    dev = rows.device
    r = rows.long()
    res, _ = matcher.search_by_projection_points(
        cam, m.kf.Tcw[kf_row], m.mp.pos[r], m.mp.desc[r], rows_ok, m.mp.min_dist[r],
        m.mp.max_dist[r], m.mp.normal[r], m.kf.xy[kf_row], m.kf.octave[kf_row],
        m.kf.desc[kf_row], m.kf.fvalid[kf_row], _scales(cfg.orb, str(dev)), cfg.orb.scale_factor,
        radius=radius, max_dist=cfg.matcher.th_low, ratio=1.0, view_cos_limit=-1.0)
    hit = torch.where(res.idx >= 0, rows[res.idx.clamp_min(0).long()],
                      torch.full_like(res.idx, NO_MP))
    cur = m.kf.mp_idx[kf_row].clone()
    new_idx = torch.where((cur == NO_MP) & (hit >= 0), hit, cur)
    dup = (cur >= 0) & (hit >= 0) & (cur != hit)
    older = torch.minimum(cur, hit)
    newer = torch.maximum(cur, hit)
    # relabel[newer] = older per duplicate; several features naming the same
    # newer row: the last feature's older row wins.
    tgt = torch.where(dup, newer, torch.zeros_like(newer)).long()
    fidx = torch.where(dup, torch.arange(cur.shape[0], device=dev), torch.full_like(tgt, -1))
    win = torch.full((M,), -1, dtype=torch.long, device=dev).scatter_reduce_(0, tgt, fidx, "amax")
    relabel = torch.where(win >= 0, older[win.clamp_min(0)].to(torch.int32),
                          torch.arange(M, dtype=torch.int32, device=dev))
    kill = covis.scatter_mask(tgt, dup, M)
    nc = newer.clamp_min(0).long()
    dst = torch.where(dup, older, torch.zeros_like(older)).long()
    zero = torch.zeros_like(cur)
    add_vis = torch.zeros(M, dtype=torch.int32, device=dev).index_add_(
        0, dst, torch.where(dup, m.mp.n_visible[nc], zero))
    add_fnd = torch.zeros(M, dtype=torch.int32, device=dev).index_add_(
        0, dst, torch.where(dup, m.mp.n_found[nc], zero))
    m.mp.valid.logical_and_(~kill)
    m.mp.n_visible.add_(add_vis)
    m.mp.n_found.add_(add_fnd)
    m.kf.mp_idx[kf_row] = new_idx
    if full_relabel:
        idx = m.kf.mp_idx
        m.kf.mp_idx.copy_(torch.where(idx >= 0, relabel[idx.clamp_min(0).long()],
                                      torch.full_like(idx, NO_MP)))
    else:
        KW = min(m.kf.capacity, KF_DETACH_WINDOW)
        krows = _trailing_rows(m, torch.minimum(m.n_kf - KW, torch.as_tensor(kf_row, device=dev)))
        win_idx = m.kf.mp_idx[krows]
        m.kf.mp_idx[krows] = torch.where(win_idx >= 0, relabel[win_idx.clamp_min(0).long()],
                                         torch.full_like(win_idx, NO_MP))
    return m


class LocalBAInputs(NamedTuple):
    kf_rows: torch.Tensor  # [W] window keyframe rows (window, then frontier)
    kf_free: torch.Tensor  # [W] optimized (True) vs fixed
    kf_ok: torch.Tensor    # [W] slot used
    mp_rows: torch.Tensor  # [P] local point rows
    mp_ok: torch.Tensor    # [P]


def select_local_ba_window(m: ms.MapState, kf_row: int, window: int,
                           frontier: int) -> LocalBAInputs:
    """Window = the keyframe pinned first plus its top covisible keyframes
    (the keyframe fills up to three slots, as in the reference); frontier =
    the other keyframes that observe the window's points most, held fixed
    (Optimizer.cc:491-545)."""
    N = m.kf.capacity
    dev = m.kf.mp_idx.device
    win_rows, win_ok = covis.top_covisible_of(m, kf_row, window,
                                              self_weight=covis.SELF_WEIGHT_PINNED)
    pmask = covis.local_map_mask(m, win_rows, win_ok)
    mp_rows, mp_ok = covis.compact_indices(pmask, m.kf.n_features * 4)
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    n_sees = (contrib & pmask[idx.clamp_min(0).long()]).sum(dim=1, dtype=torch.int32)
    in_window = covis.scatter_mask(win_rows, win_ok, N)
    fr_vals, fr_rows = covis.topk_stable(torch.where(in_window, torch.zeros_like(n_sees), n_sees),
                                         frontier)
    kf_rows = torch.cat([win_rows, fr_rows.to(torch.int32)])
    kf_ok = torch.cat([win_ok, fr_vals > 0])
    kf_free = torch.cat([torch.ones(window, dtype=torch.bool, device=dev),
                         torch.zeros(frontier, dtype=torch.bool, device=dev)])
    kf_free = kf_free & ~m.kf.fixed[kf_rows.long()] & (kf_rows != 0)
    # Gauge: with nothing fixed, pin the oldest used window row.
    any_fixed = ((~kf_free) & kf_ok).any()
    oldest = torch.argmin(torch.where(kf_ok, kf_rows, torch.full_like(kf_rows, 2 ** 30)))
    pin = torch.arange(kf_rows.shape[0], device=dev) != oldest
    kf_free = torch.where(any_fixed, kf_free, kf_free & pin)
    return LocalBAInputs(kf_rows, kf_free, kf_ok, mp_rows, mp_ok)


def local_ba_build(m: ms.MapState, kf_row: int, cfg: SlamConfig):
    """Window selection and the BA problem (gathered copies: the map may
    change before the writeback). Returns (LocalBAInputs, BADense)."""
    W = cfg.mapping.local_ba_window
    sel = select_local_ba_window(m, kf_row, W, W // 2)
    return sel, ba_dense.problem_from_window(m, sel, cfg.orb.scale_factor)


def local_ba(cam, m: ms.MapState, kf_row: int, cfg: SlamConfig) -> ms.MapState:
    """LocalBundleAdjustment (Optimizer.cc:487) in one step: the window and
    its fixed frontier, `local_ba_iters` LM iterations with Huber on the
    first 3, then the writeback and the outlier detachment, in place."""
    sel, prob = local_ba_build(m, kf_row, cfg)
    res = ba_dense.optimize(cam, prob, n_iters=cfg.mapping.local_ba_iters,
                            cg_iters=cfg.mapping.local_ba_cg_iters, huber_iters=3)
    return local_ba_writeback(m, sel.kf_rows, sel.kf_free, sel.kf_ok, sel.mp_rows, sel.mp_ok,
                              res.Tcw, res.X, res.inlier, prob.obs_active)


def local_ba_writeback(m: ms.MapState, kf_rows, kf_free, kf_ok, mp_rows, mp_ok, Tcw_opt, X_opt,
                       inlier, obs_active) -> ms.MapState:
    """Fold an optimized window back into the map: poses of free used slots,
    points of used unfixed rows, and outlier observations detached. A slot
    that is not written writes its old value; where rows repeat, the last
    slot wins (so a pose update can be overwritten by a later slot of the
    same keyframe, as in the reference)."""
    rows = kf_rows.long()
    N = m.kf.capacity
    last = last_wins(kf_rows, N)
    wrote_T = torch.where((kf_free & kf_ok)[:, None, None], Tcw_opt, m.kf.Tcw[rows])
    m.kf.Tcw.index_copy_(0, rows, wrote_T[last])
    pr = mp_rows.long()
    wrote_X = torch.where((mp_ok & ~m.mp.fixed[pr])[:, None], X_opt, m.mp.pos[pr])
    m.mp.pos.index_copy_(0, pr, wrote_X[last_wins(mp_rows, m.mp.capacity)])
    cur_idx = m.kf.mp_idx[rows]
    new_idx = torch.where(~inlier & obs_active, torch.full_like(cur_idx, NO_MP), cur_idx)
    m.kf.mp_idx.index_copy_(0, rows, new_idx[last])
    return m


def refresh_point_geometry(m: ms.MapState, kf_row: int, cfg: SlamConfig) -> ms.MapState:
    """Normals and representative descriptors of the points the keyframe's
    covisible window observes (MapPoint::UpdateNormalAndDepth /
    ComputeDistinctiveDescriptors for the touched points): mean unit
    direction from the observing cameras, the newest observation's
    descriptor. A keyframe listed twice counts twice, as in the reference."""
    M, F = m.mp.capacity, m.kf.n_features
    wins, wok = covis.top_covisible_of(m, kf_row, cfg.capacity.local_window_kfs,
                                       self_weight=covis.SELF_WEIGHT_PINNED)
    w = wins.long()
    T = m.kf.Tcw[w]
    R, t = T[:, :3, :3], T[:, :3, 3]
    centers = -(R * t[:, :, None]).sum(dim=1)  # -R^T t
    idx = m.kf.mp_idx[w]
    contrib = (idx >= 0) & m.kf.fvalid[w] & m.kf.valid[w][:, None] & wok[:, None]
    flat = torch.where(contrib, idx, torch.zeros_like(idx)).reshape(-1).long()
    wt = contrib.reshape(-1).to(torch.float32)
    d = m.mp.pos[flat] - centers.repeat_interleave(F, dim=0)
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-9)
    normal_sum = torch.zeros(M, 3, dtype=torch.float32, device=d.device).index_add_(
        0, flat, d * wt[:, None])
    counts = torch.zeros(M, dtype=torch.float32, device=d.device).index_add_(0, flat, wt)
    normal = normal_sum / torch.clamp_min(counts, 1.0)[:, None]
    normal = normal / torch.clamp_min(torch.linalg.norm(normal, dim=-1, keepdim=True), 1e-9)
    has_obs = counts > 0
    key = torch.where(contrib, wins[:, None] * F + torch.arange(F, dtype=torch.int32,
                                                                device=d.device)[None, :],
                      torch.full_like(idx, -1)).reshape(-1)
    newest = torch.full((M,), -1, dtype=torch.int32, device=d.device).scatter_reduce_(
        0, flat, key, "amax")
    newest = torch.where(has_obs, newest.clamp_min(0), torch.zeros_like(newest))
    new_desc = m.kf.desc.reshape(-1, 32)[newest.long()]
    m.mp.normal.copy_(torch.where(has_obs[:, None], normal, m.mp.normal))
    m.mp.desc.copy_(torch.where(has_obs[:, None], new_desc, m.mp.desc))
    return m


def find_redundant_keyframes(m: ms.MapState, kf_row: int, cfg: SlamConfig,
                             window: int = 8) -> torch.Tensor:
    """KeyFrameCulling (LocalMapping.cc:590): a covisible neighbour is
    redundant when more than kf_cull_redundancy of its (> 10) landmarks are
    seen by at least 3 other keyframes at the same or a finer octave (+1).
    One [M, L] cumulative octave histogram over the whole table, then
    gathers per candidate. Returns the [N] kill mask (never row 0, the
    keyframe itself, or fixed keyframes)."""
    N, M = m.kf.capacity, m.mp.capacity
    L = cfg.orb.n_levels
    dev = m.kf.mp_idx.device
    cand_rows, cand_ok = covis.top_covisible_of(m, kf_row, window)
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    bucket = torch.where(contrib, idx * L + m.kf.octave.clamp(0, L - 1),
                         torch.full_like(idx, M * L)).reshape(-1).long()
    hist = torch.zeros(M * L + 1, dtype=torch.int32, device=dev).index_add_(
        0, bucket, torch.ones_like(bucket, dtype=torch.int32))
    cum = torch.cumsum(hist[:M * L].reshape(M, L), dim=1)
    c = cand_rows.long()
    idx_c = m.kf.mp_idx[c]
    bound = (idx_c >= 0) & m.kf.fvalid[c]
    thr = (m.kf.octave[c] + 1).clamp(0, L - 1).long()
    n_others = cum[idx_c.clamp_min(0).long(), thr] - 1
    red = bound & (n_others >= 3)
    n_bound = bound.sum(dim=1)
    ratio = red.sum(dim=1) / torch.clamp_min(n_bound, 1)
    kill_c = cand_ok & (n_bound > 10) & (ratio.to(torch.float32) > cfg.mapping.kf_cull_redundancy)
    kill = covis.scatter_mask(cand_rows, kill_c, N)
    kill &= m.kf.valid & ~m.kf.fixed
    kill[0] = False
    kill[kf_row] = False
    return kill


def cull_keyframes(m: ms.MapState, kf_row: int, cfg: SlamConfig):
    """Apply the redundancy rule in place; returns (map, kill mask)."""
    kill = find_redundant_keyframes(m, kf_row, cfg)
    return ms.cull_keyframes(m, kill), kill
