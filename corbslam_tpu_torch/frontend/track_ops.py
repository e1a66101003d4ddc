"""The stereo tracking step against the map (port of
`corbslam_tpu/frontend/track_ops.py`: `_track_core`, `track_frame_stereo`,
`track_frame_stereo2`, `insert_keyframe_with_points` and their helpers).

One tracked frame (Tracking.cc:266 Track, OK state):
1. motion-model match of the last frame's points (`search_frame_frame`, K5)
   and motion-only pose LM (`optimize_pose`, K6); when that keeps fewer than
   `min_inliers_motion` inliers, a descriptor match against the reference
   keyframe (`search_by_descriptor`, K5) and LM from the last pose instead;
2. the local map (`local_map_window`, K7): candidate keyframes from the
   tracked points' anchors, the last local window and the newest keyframes;
   their shared-point weights; the top K1 as the local window; the points
   they observe that the current frame does not track and that lie in the
   frustum, compacted newest-first to L rows and projected;
3. projection matching of those rows into the untracked features (K5) and a
   second pose LM (K6) over all matches;
4. the visible / found counters of the compacted rows, the keyframe-policy
   counts, the new velocity and the 24-float summary.

The reference runs step 1's fallback under `jax.lax.cond`; here the host
reads the inlier count once per frame (one `.item()`) and runs the fallback
only when it is needed, which gives the same results. The map is updated in
place (the counters; `insert_keyframe_with_points` also writes the new
keyframe and points), where the reference donates its buffers.

`track_motion_model`, `track_reference_kf`, `track_local_map` and
`update_tracking_stats` are the separate programs the tracker runs when it
re-acquires a LOST track (Tracking.cc:886, :775, :951); `track_local_map`
weighs all keyframes, not the candidate window, and shares K7's point-mask,
compaction and frustum launches with the fused step. `track_frame_rgbd` and
`track_frame_mono` are the same step on an RGB-D or a monocular frame; a
mono frame's features have no depth, so K6 runs every observation with the
2-D residual and its 5.991 gate.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from .. import kernels
from ..config import OrbConfig, SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..optim import pose_opt
from . import frame as frame_mod
from .frame import FrameData

NO_MP = ms.NO_MP
N_CANDIDATES = 128  # candidate keyframes scored for the local window
MAX_CANDIDATES = 1024  # local_select ranks one candidate per thread of one block
MAX_KEYFRAMES = 12288  # local_scatter_current counts the anchors in 48 KB of shared memory


@lru_cache(maxsize=16)
def _scales(cfg: OrbConfig, device: str) -> torch.Tensor:
    return torch.tensor(cfg.scales(), dtype=torch.float32, device=device)


def pose_inputs(frame: FrameData, mp_pos: torch.Tensor, match_idx: torch.Tensor):
    """(X, obs, inv_sigma2, is_stereo, valid) of `optimize_pose` for the
    features' map-point matches."""
    X = mp_pos[match_idx.clamp_min(0).long()]
    obs = torch.stack([frame.xy[:, 0], frame.xy[:, 1], frame.uright], dim=-1)
    inv_sigma2 = 1.0 / (1.2 ** (2.0 * frame.octave.to(torch.float32)))
    return X, obs, inv_sigma2, frame.uright > 0, (match_idx >= 0) & frame.fvalid


def lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[idx] where idx >= 0, NO_MP elsewhere (a match index mapped to
    the map point it stands for)."""
    return torch.where(idx >= 0, table[idx.clamp_min(0).long()], torch.full_like(idx, NO_MP))


def motion_model_query(cam, m: ms.MapState, prev: FrameData, cur: FrameData, T_pred,
                       cfg: SlamConfig) -> dict:
    """The K5 query of the motion-model match (`search_frame_frame`): the
    last frame's tracked points projected with T_pred, against the current
    features."""
    return matcher.frame_frame_query(
        cam, T_pred, m.mp.pos[prev.mp_idx.clamp_min(0).long()], (prev.mp_idx >= 0) & prev.fvalid,
        prev.xy, prev.octave, prev.desc, prev.angle, cur.xy, cur.octave, cur.desc, cur.angle,
        cur.fvalid, _scales(cfg.orb, str(cur.xy.device)),
        radius=cfg.matcher.search_radius_motion, max_dist=100)


def reference_kf_query(m: ms.MapState, cur: FrameData, ref_kf) -> tuple[dict, torch.Tensor]:
    """The K5 query of the reference-keyframe fallback (`search_by_descriptor`
    against the keyframe's features that carry a point), and those features'
    point rows."""
    r = torch.as_tensor(ref_kf).long()
    kf_mp = m.kf.mp_idx[r]
    q = dict(desc_q=cur.desc, desc_t=m.kf.desc[r], valid_q=cur.fvalid,
             valid_t=m.kf.fvalid[r] & (kf_mp >= 0), max_dist=50, ratio=0.7, mutual=True)
    return q, kf_mp


def local_map_query(m: ms.MapState, cur: FrameData, win: LocalWindow, tracked,
                    cfg: SlamConfig) -> dict:
    """The K5 query of the local-map projection search: the window's
    projected rows against the features not tracked yet."""
    return matcher.projected_query(
        win.uv, win.visible, win.pred_octave, m.mp.desc[win.rows.long()],
        cur.xy, cur.octave, cur.desc, cur.fvalid & ~tracked, _scales(cfg.orb, str(cur.xy.device)),
        radius=cfg.matcher.search_radius_motion / 4.0, max_dist=cfg.matcher.th_high, ratio=0.8,
        # No octave gate, as in the reference: the radius window, the mutual
        # check and the ratio test disambiguate.
        octave_slack=16, octave_slack_up=16)


def _pose_opt_from_matches(cam, T_init, frame: FrameData, mp_pos, match_idx):
    """Motion-only LM from per-feature map-point matches; returns (Tcw,
    matches kept as inliers, n_inliers)."""
    res = pose_opt.optimize_pose(cam, T_init, *pose_inputs(frame, mp_pos, match_idx))
    kept = torch.where(res.inliers, match_idx, torch.full_like(match_idx, NO_MP))
    return res.Tcw, kept, res.n_inliers


class LocalTrackResult(NamedTuple):
    Tcw: torch.Tensor
    mp_idx: torch.Tensor
    n_inliers: torch.Tensor
    ref_kf: torch.Tensor
    local_kf_rows: torch.Tensor
    local_kf_ok: torch.Tensor
    visible_rows: torch.Tensor     # [L] compacted local map rows
    visible_mask: torch.Tensor     # [L] which were frustum-visible
    found_rows_mask: torch.Tensor  # [L] which got matched


class LocalWindow(NamedTuple):
    """What K7 computes for a frame: the local keyframe window and the
    compacted, projected local map."""

    local_rows: torch.Tensor   # [K1] i32 local-window keyframe rows
    local_ok: torch.Tensor     # [K1] bool
    ref_kf: torch.Tensor       # [] i32 keyframe sharing the most points
    cur_mask: torch.Tensor     # [M] bool points the frame already tracks
    rows: torch.Tensor         # [L] i32 compacted local map rows
    rows_ok: torch.Tensor      # [L] bool
    uv: torch.Tensor           # [L, 2] f32 projections at T_init
    visible: torch.Tensor      # [L] bool in the matching frustum (and rows_ok)
    pred_octave: torch.Tensor  # [L] i32 predicted level
    cand: torch.Tensor         # [C] i32 candidate keyframe rows
    cand_ok: torch.Tensor      # [C] bool
    pmask: torch.Tensor        # [M] bool local-map points before compaction


def _candidate_local_kfs(m: ms.MapState, mp_idx, prev_local_rows, prev_local_ok, ref_kf,
                         K1: int):
    """Local-keyframe selection over a bounded candidate set: the anchor
    keyframes of the tracked points (by hit count), last frame's local
    window, the newest keyframes, and [ref_kf, 0]; exact shared-point weights
    for those rows only, duplicates zeroed (first valid kept). Returns
    (local_rows [K1], local_ok [K1], ref_new, cur_mask [M], cand [C],
    cand_ok [C])."""
    N = m.kf.capacity
    dev = mp_idx.device
    has = mp_idx >= 0
    cur_mask = covis.scatter_mask(mp_idx, has, m.mp.capacity)

    anchors = m.mp.ref_kf[mp_idx.clamp_min(0).long()]
    hit = has & (anchors >= 0) & (anchors < N)
    anchor_count = torch.zeros(N, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(hit, anchors, torch.zeros_like(anchors)).long(), hit.to(torch.int32))
    n_anchor = min(N_CANDIDATES - K1 - 2, N)
    n_recent = min(K1, N)
    a_vals, a_rows = covis.topk_stable(anchor_count, n_anchor)
    recent = m.n_kf - 1 - torch.arange(n_recent, dtype=torch.int32, device=dev)
    ref = torch.as_tensor(ref_kf, dtype=torch.int32, device=dev).reshape(1)
    cand = torch.cat([a_rows.to(torch.int32), prev_local_rows.to(torch.int32),
                      recent.clamp_min(0), ref, torch.zeros(1, dtype=torch.int32, device=dev)])
    cand_ok = torch.cat([a_vals > 0, prev_local_ok, recent >= 0,
                         torch.ones(2, dtype=torch.bool, device=dev)])

    c = cand.long()
    cidx = m.kf.mp_idx[c]  # [C, F]
    contrib = (cidx >= 0) & m.kf.fvalid[c] & m.kf.valid[c][:, None] & cand_ok[:, None]
    share = contrib & cur_mask[cidx.clamp_min(0).long()]
    w = share.sum(dim=1, dtype=torch.int32)
    w = covis.dedupe_candidate_weights(cand, w, cand_ok)
    w = torch.where(cand_ok, w, torch.zeros_like(w))

    ref_new = cand[torch.argmax(w)]
    vals, li = covis.topk_stable(w, K1)
    return cand[li], vals > 0, ref_new, cur_mask, cand, cand_ok


def _local_points_plain(cam, m: ms.MapState, local_rows, local_ok, cur_mask, T_init,
                        cfg: SlamConfig):
    """The local-map point mask (observed by the window, valid, not tracked,
    in the wide frustum at T_init), its newest-first compaction to L rows and
    the matching frustum of those rows: (rows, rows_ok, uv, visible,
    pred_octave, pmask)."""
    L = cfg.capacity.local_window_mps
    pmask = covis.local_map_mask_plain(m, local_rows, local_ok) & ~cur_mask
    pmask &= cam_mod.in_frustum(cam, T_init, m.mp.pos, m.mp.min_dist * 0.5,
                                m.mp.max_dist * 2.0, m.mp.normal, view_cos_limit=-1.0)[0]
    rows, rows_ok = covis.compact_indices_plain(pmask, L)
    r = rows.long()
    visible, uv, pred = matcher.project_map_points(
        cam, T_init, m.mp.pos[r], rows_ok, m.mp.min_dist[r], m.mp.max_dist[r],
        m.mp.normal[r], cfg.orb.scale_factor, cfg.orb.n_levels)
    return rows, rows_ok, uv, visible & rows_ok, pred, pmask


def local_map_window_plain(cam, m: ms.MapState, mp_idx_in, prev_local_rows, prev_local_ok,
                           ref_kf, T_init, cfg: SlamConfig) -> LocalWindow:
    """Plain version of K7: candidate keyframes, then `_local_points_plain`
    over the chosen window."""
    K1 = cfg.capacity.local_window_kfs
    local_rows, local_ok, ref_new, cur_mask, cand, cand_ok = _candidate_local_kfs(
        m, mp_idx_in, prev_local_rows, prev_local_ok, ref_kf, K1)
    rows, rows_ok, uv, visible, pred, pmask = _local_points_plain(
        cam, m, local_rows, local_ok, cur_mask, T_init, cfg)
    return LocalWindow(local_rows, local_ok, ref_new, cur_mask, rows, rows_ok, uv, visible, pred,
                       cand, cand_ok, pmask)


def _local_map_window_cuda(cam, m, mp_idx_in, prev_local_rows, prev_local_ok, ref_kf, T_init,
                           cfg: SlamConfig) -> LocalWindow:
    N, F, M = m.kf.capacity, m.kf.n_features, m.mp.capacity
    K1, L = cfg.capacity.local_window_kfs, cfg.capacity.local_window_mps
    n_anchor = min(N_CANDIDATES - K1 - 2, N)
    n_recent = min(K1, N)
    C = n_anchor + K1 + n_recent + 2
    Fc = mp_idx_in.shape[0]
    dev = mp_idx_in.device
    if L > M or K1 > C or C > MAX_CANDIDATES or N > MAX_KEYFRAMES:
        raise ValueError(f"local_map_window: K1={K1}, L={L}, C={C}, N={N} outside the kernel's "
                         f"limits (K1 <= C <= {MAX_CANDIDATES}, L <= M, N <= {MAX_KEYFRAMES})")
    chk = kernels.check
    chk(mp_idx_in, "mp_idx", torch.int32, (Fc,), dev)
    chk(prev_local_rows, "prev_local_rows", torch.int32, (K1,), dev)
    chk(prev_local_ok, "prev_local_ok", torch.bool, (K1,), dev)
    chk(ref_kf, "ref_kf", torch.int32, (), dev)
    chk(T_init, "T_init", torch.float32, (4, 4), dev)
    chk(m.n_kf, "m.n_kf", torch.int32, (), dev)
    for name, t, dt, shape in (
            ("kf.mp_idx", m.kf.mp_idx, torch.int32, (N, F)),
            ("kf.fvalid", m.kf.fvalid, torch.bool, (N, F)),
            ("kf.valid", m.kf.valid, torch.bool, (N,)),
            ("mp.ref_kf", m.mp.ref_kf, torch.int32, (M,)),
            ("mp.valid", m.mp.valid, torch.bool, (M,)),
            ("mp.pos", m.mp.pos, torch.float32, (M, 3)),
            ("mp.min_dist", m.mp.min_dist, torch.float32, (M,)),
            ("mp.max_dist", m.mp.max_dist, torch.float32, (M,)),
            ("mp.normal", m.mp.normal, torch.float32, (M, 3))):
        chk(t, name, dt, shape, dev)
    p = kernels.ptr

    def out(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    cur_mask, counts = out(M, dtype=torch.bool), out(N, dtype=torch.int32)
    kernels.launch("local_map", "local_scatter_current", p(mp_idx_in), None, Fc, p(m.mp.ref_kf), M,
                   N, p(cur_mask), p(counts))
    cand, cand_ok = out(C, dtype=torch.int32), out(C, dtype=torch.bool)
    kernels.launch("local_map", "local_candidates", p(counts), N, p(m.n_kf), p(prev_local_rows),
                   p(prev_local_ok), K1, n_anchor, n_recent, p(ref_kf), 0, p(cand), p(cand_ok))
    w = out(C, dtype=torch.int32)
    kernels.launch("local_map", "local_weights", p(cand), p(cand_ok), C, N, p(m.kf.mp_idx),
                   p(m.kf.fvalid), p(m.kf.valid), F, p(cur_mask), p(w))
    local_rows, local_ok = out(K1, dtype=torch.int32), out(K1, dtype=torch.bool)
    ref_new = out(dtype=torch.int32)
    kernels.launch("local_map", "local_select", p(cand), p(cand_ok), p(w), C, K1, -1, 0, 1,
                   p(local_rows), p(local_ok), p(ref_new))
    rows, rows_ok, uv, visible, pred, pmask = _local_points_cuda(
        cam, m, local_rows, local_ok, cur_mask, T_init, cfg)
    return LocalWindow(local_rows, local_ok, ref_new, cur_mask, rows, rows_ok, uv, visible, pred,
                       cand, cand_ok, pmask)


def _local_points_cuda(cam, m, local_rows, local_ok, cur_mask, T_init, cfg: SlamConfig):
    """K7's launches (5)-(7) for any window rows (`_local_points_plain`)."""
    F, M = m.kf.n_features, m.mp.capacity
    K1, L = local_rows.shape[0], cfg.capacity.local_window_mps
    dev = local_rows.device
    p = kernels.ptr
    camf = [float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), int(cam.width),
            int(cam.height)]

    def out(*shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    pmask = out(M, dtype=torch.bool)
    kernels.launch("local_map", "local_points", p(local_rows), p(local_ok), K1, p(m.kf.mp_idx),
                   p(m.kf.fvalid), F, p(m.mp.valid), p(cur_mask), p(m.mp.pos), p(m.mp.min_dist),
                   p(m.mp.max_dist), p(m.mp.normal), p(T_init), M, *camf, p(pmask))
    rows, rows_ok = out(L, dtype=torch.int32), out(L, dtype=torch.bool)
    work = covis.compact_work(M, dev)
    kernels.launch("local_map", "local_compact", p(pmask), M, L, p(rows), p(rows_ok), p(work))
    uv, visible, pred = out(L, 2, dtype=torch.float32), out(L, dtype=torch.bool), out(
        L, dtype=torch.int32)
    kernels.launch("local_map", "local_frustum", p(rows), p(rows_ok), L, p(m.mp.pos),
                   p(m.mp.min_dist), p(m.mp.max_dist), p(m.mp.normal), p(T_init), *camf,
                   matcher.log_scale(cfg.orb.scale_factor), cfg.orb.n_levels, p(uv), p(visible),
                   p(pred))
    return rows, rows_ok, uv, visible, pred, pmask


def local_map_window(cam, m: ms.MapState, mp_idx_in, prev_local_rows, prev_local_ok, ref_kf,
                     T_init, cfg: SlamConfig) -> LocalWindow:
    """The local keyframe window and compacted local map of a frame (K7 on
    CUDA tensors, the plain version on CPU tensors)."""
    if mp_idx_in.is_cuda:
        return _local_map_window_cuda(cam, m, mp_idx_in, prev_local_rows, prev_local_ok, ref_kf,
                                      T_init.contiguous(), cfg)
    if mp_idx_in.device.type == "cpu":
        return local_map_window_plain(cam, m, mp_idx_in, prev_local_rows, prev_local_ok, ref_kf,
                                      T_init, cfg)
    raise ValueError(f"unsupported device {mp_idx_in.device}")


def _local_map_track(cam, m, cur: FrameData, T_init, mp_idx_in, prev_local_rows, prev_local_ok,
                     ref_kf, cfg: SlamConfig) -> LocalTrackResult:
    """TrackLocalMap over the bounded candidate window (Tracking.cc:951)."""
    win = local_map_window(cam, m, mp_idx_in, prev_local_rows, prev_local_ok, ref_kf, T_init, cfg)
    has = mp_idx_in >= 0
    res = matcher.match_select(**local_map_query(m, cur, win, has, cfg))
    merged = torch.where(has, mp_idx_in, lookup(res.idx, win.rows))
    Tcw, kept, n_inliers = _pose_opt_from_matches(cam, T_init, cur, m.mp.pos, merged)
    found = covis.scatter_mask(kept, kept >= 0, m.mp.capacity)
    return LocalTrackResult(Tcw, kept, n_inliers, win.ref_kf, win.local_rows, win.local_ok,
                            win.rows, win.visible, found[win.rows.long()])


class FusedTrackResult(NamedTuple):
    map: ms.MapState
    cur: FrameData
    velocity: torch.Tensor    # [4, 4] T_cur_prev (next frame's prediction)
    local_rows: torch.Tensor  # [K1] local-window keyframe rows
    local_ok: torch.Tensor    # [K1]
    ref_kf: torch.Tensor      # [] i32 new reference keyframe
    summary: torch.Tensor     # [24] f32, see _summarize


def _summarize(n_track, used_ref, n_local, ref_kf, n_close_tracked, n_close_spawn, ok, Tcw):
    """[n_track, used_ref, n_local, ref_kf, n_close_tracked, n_close_spawn,
    ok, 0, Tcw (16, row-major)] as f32."""
    head = torch.stack([torch.as_tensor(v, device=Tcw.device).to(torch.float32).reshape(())
                        for v in (n_track, used_ref, n_local, ref_kf, n_close_tracked,
                                  n_close_spawn, ok, 0.0)])
    return torch.cat([head, Tcw.reshape(-1)])


def _track_core(cam, m: ms.MapState, cur: FrameData, prev: FrameData, velocity, ref_kf,
                prev_local_rows, prev_local_ok, cfg: SlamConfig) -> FusedTrackResult:
    """Shared body of the tracking steps (cur already built)."""
    dev = cur.xy.device
    ref_kf = torch.as_tensor(ref_kf, dtype=torch.int32, device=dev).reshape(())
    T_pred = se3.compose(velocity, prev.Tcw)

    # 1. Motion-model track; the reference keyframe when it is thin
    # (TrackWithMotionModel -> TrackReferenceKeyFrame, Tracking.cc:886/775).
    mres = matcher.match_select(**motion_model_query(cam, m, prev, cur, T_pred, cfg))
    match_mp = lookup(mres.idx, prev.mp_idx)
    Tcw0, mp0, n_track = _pose_opt_from_matches(cam, T_pred, cur, m.mp.pos, match_mp)
    used_ref = int(n_track) < cfg.tracking.min_inliers_motion  # the frame's one host sync
    if used_ref:
        q, kf_mp = reference_kf_query(m, cur, ref_kf)
        rres = matcher.match_select(**q)
        Tcw0, mp0, n_track = _pose_opt_from_matches(cam, prev.Tcw, cur, m.mp.pos,
                                                    lookup(rres.idx, kf_mp))

    # 2. Local-map track over the candidate window.
    res = _local_map_track(cam, m, cur, Tcw0, mp0, prev_local_rows, prev_local_ok, ref_kf, cfg)
    track_ok = n_track >= cfg.tracking.min_inliers_motion
    ok = track_ok & (res.n_inliers >= cfg.tracking.min_tracked_points // 2)

    # 3. Visible / found counters (only for frames not lost before the
    # local-map step), in place.
    rows = res.visible_rows.long()
    m.mp.n_visible.index_add_(0, rows, (res.visible_mask & track_ok).to(torch.int32))
    m.mp.n_found.index_add_(0, rows, (res.found_rows_mask & track_ok).to(torch.int32))

    # 4. Keyframe-policy counters (NeedNewKeyFrame, Tracking.cc:1036-1044).
    close = (cur.depth > 0.01) & (cur.depth < cfg.tracking.th_depth * cam.baseline) & cur.fvalid
    n_close_tracked = (close & (res.mp_idx >= 0)).sum()
    n_close_spawn = (close & (res.mp_idx < 0)).sum()

    cur = cur._replace(Tcw=res.Tcw, mp_idx=res.mp_idx)
    vel_next = torch.where(ok, se3.compose(cur.Tcw, se3.inverse(prev.Tcw)), velocity)
    summary = _summarize(n_track, used_ref, res.n_inliers, res.ref_kf, n_close_tracked,
                         n_close_spawn, ok, res.Tcw)
    return FusedTrackResult(m, cur, vel_next, res.local_kf_rows, res.local_kf_ok,
                            res.ref_kf.to(torch.int32), summary)


def _require_on(dev: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index):
            raise ValueError(f"{name} is on {t.device}, the step runs on {dev}")


def track_frame_stereo(m: ms.MapState, prev: FrameData, velocity, img_l, img_r, ref_kf,
                       prev_local_rows, prev_local_ok, cam, cfg: SlamConfig,
                       device="cuda") -> FusedTrackResult:
    """Stereo frame build + the full OK-state tracking step on `device`.
    The map, the last frame and the carried state must already live there."""
    dev = kernels.resolve_device(device)
    _require_on(dev, map=m.mp.pos, prev=prev.xy, velocity=velocity, local_rows=prev_local_rows)
    cur = frame_mod.build_frame_stereo(img_l, img_r, cam, cfg.orb, device=dev)
    return _track_core(cam, m, cur, prev, velocity, ref_kf, prev_local_rows, prev_local_ok, cfg)


def track_frame_stereo2(m: ms.MapState, prev: FrameData, velocity, img_l0, img_r0, img_l1,
                        img_r1, ref_kf, prev_local_rows, prev_local_ok, cam, cfg: SlamConfig,
                        device="cuda"):
    """Two consecutive stereo frames chained (the reference's
    frames_per_dispatch=2 program): returns (result 0, result 1)."""
    o0 = track_frame_stereo(m, prev, velocity, img_l0, img_r0, ref_kf, prev_local_rows,
                            prev_local_ok, cam, cfg, device)
    o1 = track_frame_stereo(o0.map, o0.cur, o0.velocity, img_l1, img_r1, o0.ref_kf,
                            o0.local_rows, o0.local_ok, cam, cfg, device)
    return o0, o1


def track_frame_rgbd(m: ms.MapState, prev: FrameData, velocity, img, depth_map, ref_kf,
                     prev_local_rows, prev_local_ok, cam, cfg: SlamConfig,
                     device="cuda") -> FusedTrackResult:
    """RGB-D frame build (a registered depth map) + the OK-state tracking step."""
    dev = kernels.resolve_device(device)
    _require_on(dev, map=m.mp.pos, prev=prev.xy, velocity=velocity, local_rows=prev_local_rows)
    cur = frame_mod.build_frame_rgbd(img, depth_map, cam, cfg.orb, device=dev)
    return _track_core(cam, m, cur, prev, velocity, ref_kf, prev_local_rows, prev_local_ok, cfg)


def track_frame_mono(m: ms.MapState, prev: FrameData, velocity, img, ref_kf, prev_local_rows,
                     prev_local_ok, cam, cfg: SlamConfig, device="cuda") -> FusedTrackResult:
    """Monocular frame build + the OK-state tracking step."""
    dev = kernels.resolve_device(device)
    _require_on(dev, map=m.mp.pos, prev=prev.xy, velocity=velocity, local_rows=prev_local_rows)
    cur = frame_mod.build_frame_mono(img, cam, cfg.orb, device=dev)
    return _track_core(cam, m, cur, prev, velocity, ref_kf, prev_local_rows, prev_local_ok, cfg)


def insert_keyframe_with_points(cam, m: ms.MapState, cur: FrameData, frame_id, timestamp,
                                cfg: SlamConfig, client: int = 0):
    """CreateNewKeyFrame (Tracking.cc:1083): insert the frame as a keyframe
    and spawn map points for its close stereo features without a match.
    Writes the map in place; returns (map, kf_row, mp_idx)."""
    close = (cur.depth > 0.01) & (cur.depth < cfg.tracking.th_depth * cam.baseline)
    spawn = close & cur.fvalid & (cur.mp_idx < 0)
    p_cam = cam_mod.backproject(cam, cur.xy, cur.depth)
    Twc = se3.inverse(cur.Tcw)
    pos_w = se3.transform(Twc, p_cam)
    d = pos_w - se3.translation(Twc)
    dist = cam_mod.norm3(d)
    normal = d / dist.clamp_min(1e-9)[:, None]
    max_dist = dist * _scales(cfg.orb, str(cur.xy.device))[cur.octave.long()]
    min_dist = matcher.div(max_dist, cfg.orb.scale_factor ** (cfg.orb.n_levels - 1))

    kf_row = m.n_kf.clone()
    m, rows = ms.add_map_points(m, pos_w, cur.desc, normal, min_dist, max_dist, ref_kf=kf_row,
                                create=spawn, client=client)
    mp_idx = torch.where(spawn, rows, cur.mp_idx)
    m, kf_row = ms.insert_keyframe(m, cur.Tcw, cur.xy, cur.octave, cur.angle, cur.desc,
                                   cur.uright, cur.depth, cur.fvalid, mp_idx, frame_id, timestamp,
                                   client=client)
    return m, kf_row, mp_idx


# ---------------------------------------------------------------------------
# The separate programs of LOST re-acquisition (StereoTracker._track)
# ---------------------------------------------------------------------------

def track_motion_model(cam, mp_pos, prev: FrameData, cur: FrameData, T_pred, scale_factors,
                       radius: float = 15.0):
    """TrackWithMotionModel: the last frame's points projected at T_pred,
    matched (K5) and the pose optimized (K6). Returns (Tcw, mp_idx [F],
    n_inliers)."""
    q = matcher.frame_frame_query(
        cam, T_pred, mp_pos[prev.mp_idx.clamp_min(0).long()], (prev.mp_idx >= 0) & prev.fvalid,
        prev.xy, prev.octave, prev.desc, prev.angle, cur.xy, cur.octave, cur.desc, cur.angle,
        cur.fvalid, scale_factors, radius=radius, max_dist=100)
    res = matcher.match_select(**q)
    return _pose_opt_from_matches(cam, T_pred, cur, mp_pos, lookup(res.idx, prev.mp_idx))


def track_reference_kf(cam, m: ms.MapState, ref_kf, cur: FrameData, T_init):
    """TrackReferenceKeyFrame: descriptor match against one keyframe's
    features that carry a point, then the pose from T_init."""
    q, kf_mp = reference_kf_query(m, cur, ref_kf)
    res = matcher.match_select(**q)
    return _pose_opt_from_matches(cam, T_init, cur, m.mp.pos, lookup(res.idx, kf_mp))


def track_local_map(cam, m: ms.MapState, cur: FrameData, T_init, mp_idx_in,
                    cfg: SlamConfig) -> LocalTrackResult:
    """TrackLocalMap with the local window picked over ALL keyframes by
    shared points with the current matches (Tracking.cc:1259), then the
    local points as in the fused step (K7's launches (5)-(7) on the card),
    projection matching (K5) and the pose (K6)."""
    K1, M = cfg.capacity.local_window_kfs, m.mp.capacity
    has = mp_idx_in >= 0
    cur_mask = covis.scatter_mask(mp_idx_in, has, M)
    idx = m.kf.mp_idx
    contrib = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    kf_weight = (contrib & cur_mask[idx.clamp_min(0).long()]).sum(dim=1, dtype=torch.int32)
    ref_kf = torch.argmax(kf_weight).to(torch.int32)
    vals, local_rows = covis.topk_stable(kf_weight, K1)
    local_rows, local_ok = local_rows.to(torch.int32), vals > 0
    T_init = T_init.contiguous()
    if idx.is_cuda:
        pts = _local_points_cuda(cam, m, local_rows, local_ok, cur_mask, T_init, cfg)
    elif idx.device.type == "cpu":
        pts = _local_points_plain(cam, m, local_rows, local_ok, cur_mask, T_init, cfg)
    else:
        raise ValueError(f"unsupported device {idx.device}")
    rows, rows_ok, uv, visible, pred, _ = pts
    win = LocalWindow(local_rows, local_ok, ref_kf, cur_mask, rows, rows_ok, uv, visible, pred,
                      local_rows, local_ok, None)
    res = matcher.match_select(**local_map_query(m, cur, win, has, cfg))
    merged = torch.where(has, mp_idx_in, lookup(res.idx, rows))
    Tcw, kept, n_inliers = _pose_opt_from_matches(cam, T_init, cur, m.mp.pos, merged)
    found = covis.scatter_mask(kept, kept >= 0, M)
    return LocalTrackResult(Tcw, kept, n_inliers, ref_kf, local_rows, local_ok, rows, visible,
                            found[rows.long()])


def update_tracking_stats(m: ms.MapState, visible_rows, visible_mask, found_rows_mask):
    """IncreaseVisible / IncreaseFound (MapPoint.cc, Tracking.cc:1168-1226),
    in place."""
    r = visible_rows.long()
    m.mp.n_visible.index_add_(0, r, visible_mask.to(torch.int32))
    m.mp.n_found.index_add_(0, r, found_rows_mask.to(torch.int32))
    return m
