"""Masked descriptor search policies of tracking (port of
`corbslam_tpu/matching/matcher.py`: `rotation_consistency`, `match_masked`,
`projection_window_mask`, `search_by_projection_points`,
`search_frame_frame`, `search_by_descriptor`).

Every policy is the same function: for each query feature, the best allowed
target by Hamming distance (lower index on ties), the threshold, Lowe's
ratio test with a strict `<` against the second best, the mutual
cross-check, and for frame-to-frame matching the 30-bin rotation histogram.
The reference builds the dense [Nq, Nt] candidacy mask and distance matrix;
`match_select` is the wrapper of kernel K5 (`csrc/match_masked.cu`), which
evaluates the mask inline and stores nothing Nq x Nt. On CPU tensors it runs
`match_select_plain`, the reference's dense formulation.
`search_for_initialization`, `epipolar_band_mask`,
`search_for_triangulation` and `fundamental_from_poses` come with mono
initialization and local mapping.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import descriptors as D

NO_MATCH = -1
TWO_PI = 2.0 * math.pi  # a Python float, rounded to f32 where it meets f32
MAX_FINISH_N = 12288     # match_finish keeps one int per query in 48 KB of shared memory


class MatchResult(NamedTuple):
    idx: torch.Tensor   # [Nq] i32 index into the targets, NO_MATCH if none
    dist: torch.Tensor  # [Nq] i32 best masked Hamming distance (INF_DIST when none)
    ok: torch.Tensor    # [Nq] bool


class Window(NamedTuple):
    """The projection-window candidacy test of `projection_window_mask`, as
    K5 evaluates it for query q (a feature) and target t (a projection):
    |uv_t - xy_q|^2 <= (radius * scale_factors[octave_q])^2 and
    octave_q - pred_octave_t in [-slack, slack_up]."""

    uv: torch.Tensor             # [Nt, 2] f32 projected targets
    xy: torch.Tensor             # [Nq, 2] f32 query keypoints
    octave: torch.Tensor         # [Nq] i32
    pred_octave: torch.Tensor    # [Nt] i32
    scale_factors: torch.Tensor  # [L] f32
    radius: float
    slack: int
    slack_up: int


def div(a: torch.Tensor, s: float) -> torch.Tensor:
    """a / s as a correctly rounded f32 division on every device (PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal)."""
    return a / torch.full_like(a, s)


def rotation_bins(angle_a: torch.Tensor, angle_b: torch.Tensor, n_bins: int = 30) -> torch.Tensor:
    """floor(((a - b) mod 2pi) / 2pi * n_bins) mod n_bins, with the
    reference's floor-mod (fmod, plus 2pi where negative)."""
    r = torch.fmod(angle_a - angle_b, TWO_PI)
    r = torch.where(r < 0, r + TWO_PI, r)
    return torch.floor(div(r, TWO_PI) * n_bins).to(torch.int32) % n_bins


def rotation_consistency(angle_a, angle_b, ok, n_bins: int = 30, keep_top: int = 3):
    """Keep matches whose angle difference falls in the `keep_top` most
    popular bins, dropping bins under a tenth of the largest
    (ComputeThreeMaxima, ORBmatcher.cc:1746-1780); bins tie to the lower."""
    bins = rotation_bins(angle_a, angle_b, n_bins)
    hist = torch.zeros(n_bins, dtype=torch.int32, device=ok.device).index_add_(
        0, bins.long(), ok.to(torch.int32))
    top_vals, top_idx = torch.sort(hist, descending=True, stable=True)
    top_vals, top_idx = top_vals[:keep_top], top_idx[:keep_top]
    good = top_vals > torch.div(top_vals[0], 10, rounding_mode="floor")
    in_top = ((bins[:, None] == top_idx[None, :]) & good[None, :]).any(dim=1)
    return ok & in_top


def match_masked(desc_q, desc_t, mask, max_dist: int, ratio: float = 1.0,
                 mutual: bool = True) -> MatchResult:
    """Dense masked matcher: for each query row the best allowed target.
    desc_q [Nq, 32], desc_t [Nt, 32], mask [Nq, Nt] True = allowed."""
    dmat = D.masked_hamming_matrix(desc_q, desc_t, extra_mask=mask)
    if mutual:
        idx, dist, ok = D.mutual_best(dmat, max_dist, ratio)
    else:
        idx, dist, ok = D.best_match(dmat, max_dist, ratio)
    idx = torch.where(ok, idx, torch.full_like(idx, NO_MATCH)).to(torch.int32)
    return MatchResult(idx, dist.to(torch.int32), ok)


def projection_window_mask(uv_proj, visible, feat_xy, feat_octave, feat_valid, radius: float,
                           scale_factors, pred_octave=None, octave_slack: int = 1,
                           octave_slack_up: int | None = None) -> torch.Tensor:
    """[M, N] mask: feature n is a candidate for projected point m. The
    radius grows with the feature's level; the feature's octave must lie in
    [-octave_slack, +octave_slack_up] of the predicted one."""
    if octave_slack_up is None:
        octave_slack_up = octave_slack
    r = radius * scale_factors[feat_octave.long()]  # [N]
    dx = uv_proj[:, None, 0] - feat_xy[None, :, 0]
    dy = uv_proj[:, None, 1] - feat_xy[None, :, 1]
    mask = dx * dx + dy * dy <= (r * r)[None, :]
    mask &= visible[:, None] & feat_valid[None, :]
    if pred_octave is not None:
        d_oct = feat_octave[None, :] - pred_octave[:, None]
        mask &= (d_oct >= -octave_slack) & (d_oct <= octave_slack_up)
    return mask


def match_select_plain(desc_q, desc_t, valid_q, valid_t, max_dist: int, ratio: float = 1.0,
                       mutual: bool = True, window: Window | None = None,
                       angle_q=None, angle_t=None) -> MatchResult:
    """Plain version of K5: the dense mask (valid_q x valid_t, and the
    projection window if given), `match_masked`, and with angles the
    rotation filter. Returns MatchResult; `dist` is the best distance
    whether or not the match survived."""
    if window is not None:
        mask = projection_window_mask(
            window.uv, valid_t, window.xy, window.octave, valid_q, window.radius,
            window.scale_factors, window.pred_octave, window.slack, window.slack_up).T
    else:
        mask = valid_q[:, None] & valid_t[None, :]
    res = match_masked(desc_q, desc_t, mask, max_dist, ratio, mutual)
    if angle_q is None:
        return res
    ok = rotation_consistency(angle_q, angle_t[res.idx.clamp_min(0).long()], res.ok)
    return MatchResult(torch.where(ok, res.idx, torch.full_like(res.idx, NO_MATCH)), res.dist, ok)


def _match_select_cuda(desc_q, desc_t, valid_q, valid_t, max_dist, ratio, mutual, window,
                       angle_q, angle_t) -> MatchResult:
    Nq, Nt = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    if Nt < 2:
        raise ValueError("match_select needs at least two targets (a best and a second)")
    if Nq > MAX_FINISH_N:
        raise ValueError(f"match_select takes at most {MAX_FINISH_N} queries")
    chk = kernels.check
    chk(desc_q, "desc_q", torch.uint8, (Nq, 32), dev)
    chk(desc_t, "desc_t", torch.uint8, (Nt, 32), dev)
    chk(valid_q, "valid_q", torch.bool, (Nq,), dev)
    chk(valid_t, "valid_t", torch.bool, (Nt,), dev)
    p = kernels.ptr
    win_args = [None] * 5 + [0.0, 0, 0]
    if window is not None:
        chk(window.uv, "window.uv", torch.float32, (Nt, 2), dev)
        chk(window.xy, "window.xy", torch.float32, (Nq, 2), dev)
        chk(window.octave, "window.octave", torch.int32, (Nq,), dev)
        chk(window.pred_octave, "window.pred_octave", torch.int32, (Nt,), dev)
        chk(window.scale_factors, "window.scale_factors", torch.float32, None, dev)
        win_args = [p(window.uv), p(window.xy), p(window.octave), p(window.pred_octave),
                    p(window.scale_factors), float(window.radius), int(window.slack),
                    int(window.slack_up)]
    if angle_q is not None:
        chk(angle_q, "angle_q", torch.float32, (Nq,), dev)
        chk(angle_t, "angle_t", torch.float32, (Nt,), dev)
    best_d, best_j, second = (torch.empty(Nq, dtype=torch.int32, device=dev) for _ in range(3))
    col = torch.empty(Nt, dtype=torch.int64, device=dev) if mutual else None
    kernels.launch(
        "match_masked", "match_rows", p(desc_q), p(desc_t), p(valid_q), p(valid_t), *win_args,
        Nq, Nt, int(window is not None), p(best_d), p(best_j), p(second),
        p(col) if mutual else None)
    idx = torch.empty(Nq, dtype=torch.int32, device=dev)
    dist = torch.empty(Nq, dtype=torch.int32, device=dev)
    ok = torch.empty(Nq, dtype=torch.bool, device=dev)
    kernels.launch(
        "match_masked", "match_finish", p(best_d), p(best_j), p(second),
        p(col) if mutual else None,
        p(angle_q) if angle_q is not None else None, p(angle_t) if angle_q is not None else None,
        Nq, int(max_dist), float(ratio), int(ratio < 1.0), p(idx), p(dist), p(ok))
    return MatchResult(idx, dist, ok)


def match_select(desc_q, desc_t, valid_q, valid_t, max_dist: int, ratio: float = 1.0,
                 mutual: bool = True, window: Window | None = None,
                 angle_q=None, angle_t=None) -> MatchResult:
    """Masked best match of every query (K5 on CUDA tensors, the plain
    version on CPU tensors). The mask is valid_q x valid_t, and with a
    `window` also the projection window; with `angle_q`/`angle_t` the
    rotation-consistency filter is applied to the accepted matches."""
    if desc_q.is_cuda:
        return _match_select_cuda(desc_q, desc_t, valid_q, valid_t, max_dist, ratio, mutual,
                                  window, angle_q, angle_t)
    if desc_q.device.type == "cpu":
        return match_select_plain(desc_q, desc_t, valid_q, valid_t, max_dist, ratio, mutual,
                                  window, angle_q, angle_t)
    raise ValueError(f"unsupported device {desc_q.device}")


# ---------------------------------------------------------------------------
# Projection-window searches
# ---------------------------------------------------------------------------

def log_scale(scale_factor: float) -> float:
    """log(scale_factor) as the reference evaluates it: the f32 log of the
    f32 value, returned as a Python float holding that f32."""
    return float(torch.log(torch.tensor(scale_factor, dtype=torch.float32)))


def predict_octave(max_dist, dist3d, scale_factor: float, n_levels: int) -> torch.Tensor:
    """PredictScale: clip(ceil(log(maxd / d) / log(s) - 1e-3), 0, n_levels-1).
    The -1e-3 bias resolves ratios that sit on a level boundary downwards."""
    ratio_d = max_dist.clamp_min(1e-6) / dist3d.clamp_min(1e-6)
    lvl = torch.ceil(div(torch.log(ratio_d), log_scale(scale_factor)) - 1e-3)
    return lvl.to(torch.int32).clamp(0, n_levels - 1)


def project_map_points(cam, Tcw, mp_pos, mp_valid, mp_min_dist, mp_max_dist, mp_normal,
                       scale_factor: float, n_levels: int, view_cos_limit: float = 0.5,
                       dist_slack: float = 1.2):
    """The frustum half of `search_by_projection_points`: (visible [M],
    uv [M, 2], pred_octave [M]). `dist_slack` loosens only the distance gate;
    the octave prediction uses the raw max distance."""
    visible, uv, _, _, dist3d = cam_mod.in_frustum(
        cam, Tcw, mp_pos, div(mp_min_dist, dist_slack), mp_max_dist * dist_slack,
        mp_normal, view_cos_limit)
    return visible & mp_valid, uv, predict_octave(mp_max_dist, dist3d, scale_factor, n_levels)


def projected_query(uv, visible, pred_octave, mp_desc, feat_xy, feat_octave, feat_desc,
                    feat_valid, scale_factors, radius: float, max_dist: int, ratio: float,
                    octave_slack: int = 1, octave_slack_up: int | None = None) -> dict:
    """The `match_select` arguments of a projection search: features are the
    queries, the projected map points the targets."""
    if octave_slack_up is None:
        octave_slack_up = octave_slack
    win = Window(uv, feat_xy, feat_octave, pred_octave, scale_factors, radius, octave_slack,
                 octave_slack_up)
    return dict(desc_q=feat_desc, desc_t=mp_desc, valid_q=feat_valid, valid_t=visible,
                max_dist=max_dist, ratio=ratio, mutual=True, window=win)


def match_projected(*args, **kw) -> MatchResult:
    """Per-feature best projected map point (K5, window mode); arguments as
    `projected_query`."""
    return match_select(**projected_query(*args, **kw))


def search_by_projection_points(cam, Tcw, mp_pos, mp_desc, mp_valid, mp_min_dist, mp_max_dist,
                                mp_normal, feat_xy, feat_octave, feat_desc, feat_valid,
                                scale_factors, scale_factor: float, radius: float,
                                max_dist: int, ratio: float, view_cos_limit: float = 0.5,
                                dist_slack: float = 1.2, octave_slack: int = 1,
                                octave_slack_up: int | None = None):
    """Match map points into a frame by projection (SearchByProjection,
    Tracking.cc:1168-1215). Returns (per-feature MatchResult, per-point
    visible mask)."""
    visible, uv, pred = project_map_points(
        cam, Tcw, mp_pos, mp_valid, mp_min_dist, mp_max_dist, mp_normal, scale_factor,
        scale_factors.shape[0], view_cos_limit, dist_slack)
    res = match_projected(uv, visible, pred, mp_desc, feat_xy, feat_octave, feat_desc,
                          feat_valid, scale_factors, radius, max_dist, ratio, octave_slack,
                          octave_slack_up)
    return res, visible


def frame_frame_query(cam, Tcw, prev_mp_pos, prev_mp_ok, prev_xy, prev_octave, prev_desc,
                      prev_angle, feat_xy, feat_octave, feat_desc, feat_angle, feat_valid,
                      scale_factors, radius: float, max_dist: int,
                      check_rotation: bool = True) -> dict:
    """The `match_select` arguments of `search_frame_frame`: the last frame's
    points projected with Tcw are the targets, windowed by the last
    feature's octave +-1, ratio 0.9, with the rotation check."""
    p_cam = se3.transform(Tcw, prev_mp_pos)
    uv = cam_mod.project(cam, p_cam)
    visible = prev_mp_ok & (p_cam[..., 2] > 0.0) & cam_mod.in_image(cam, uv)
    win = Window(uv, feat_xy, feat_octave, prev_octave, scale_factors, radius, 1, 1)
    return dict(desc_q=feat_desc, desc_t=prev_desc, valid_q=feat_valid, valid_t=visible,
                max_dist=max_dist, ratio=0.9, mutual=True, window=win,
                angle_q=feat_angle if check_rotation else None,
                angle_t=prev_angle if check_rotation else None)


def search_frame_frame(*args, **kw) -> MatchResult:
    """Motion-model matching: project the last frame's map points with the
    predicted pose and match the current features against them
    (SearchByProjection(Frame, Frame), Tracking.cc:905); arguments as
    `frame_frame_query`. Returns per-current-feature indices into the last
    frame's features."""
    return match_select(**frame_frame_query(*args, **kw))


def search_by_descriptor(desc_q, valid_q, desc_t, valid_t, max_dist: int, ratio: float = 0.75,
                         mutual: bool = True) -> MatchResult:
    """Unconstrained global descriptor matching (the stand-in for
    SearchByBoW, ORBmatcher.cc:294)."""
    return match_select(desc_q, desc_t, valid_q, valid_t, max_dist, ratio, mutual)
