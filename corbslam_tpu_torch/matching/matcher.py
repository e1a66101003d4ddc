"""Masked descriptor search policies (port of `corbslam_tpu/matching/matcher.py`:
`rotation_consistency`, `match_masked`, `projection_window_mask`,
`search_by_projection_points`, `search_frame_frame`, `search_by_descriptor`,
`search_for_initialization`, `epipolar_band_mask`,
`search_for_triangulation`, `fundamental_from_poses`).

Every policy is the same function: for each query feature, the best allowed
target by Hamming distance (lower index on ties), the threshold, Lowe's
ratio test with a strict `<` against the second best, the mutual
cross-check, and for frame-to-frame matching the 30-bin rotation histogram.
The reference builds the dense [Nq, Nt] candidacy mask and distance matrix;
`match_select` is the wrapper of kernel K5 (`csrc/match_masked.cu`), which
evaluates the mask inline and stores nothing Nq x Nt, in one launch per
call (its column keys and batch tickets live in `k5_workspace`, which the
kernel restores before it ends). On CPU tensors it runs
`match_select_plain`, the reference's dense formulation. The mask is the
validity of both sides and, optionally, one geometric test: the projection
window (`Window`), an area window around the query (`AreaWindow`, mono
initialization) or the query's epipolar band in the target image with the
epipole guard (`EpipolarBand`, triangulation). `band_search` runs the band
search of one keyframe against a batch of neighbours in one K5 launch.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from .. import kernels
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..ops import descriptors as D

NO_MATCH = -1
TWO_PI = 2.0 * math.pi  # a Python float, rounded to f32 where it meets f32
MAX_FINISH_N = 12288     # K5's finish keeps one int per query in 48 KB of shared memory
COL_EMPTY = 512 << 32    # a column key with no candidate: (INF_DIST << 32) | row 0
_K5_WORK: dict = {}


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


class AreaWindow(NamedTuple):
    """|xy_t - xy_q|^2 <= radius^2 (SearchForInitialization's window)."""

    xy_t: torch.Tensor  # [Nt, 2] f32 target keypoints
    xy_q: torch.Tensor  # [Nq, 2] f32 query keypoints
    radius: float


class EpipolarBand(NamedTuple):
    """Target t lies in the band of query q's epipolar line l = F12 (x_q, 1):
    (l . (x_t, 1))^2 / (l0^2 + l1^2) < 3.84 scale_t^2 (CheckDistEpipolarLine);
    with `epipole` also |xy_t - epipole|^2 > sqrt(100 scale_t)^2, where
    scale_t is the scale factor of the target's octave."""

    F12: torch.Tensor           # [3, 3] f32, x_t^T F12 x_q = 0
    xy_t: torch.Tensor          # [Nt, 2] f32
    xy_q: torch.Tensor          # [Nq, 2] f32
    octave_t: torch.Tensor      # [Nt] i32
    scale_factors: torch.Tensor  # [L] f32
    epipole: Optional[torch.Tensor] = None  # [2] f32 or None


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


Geometry = Union[Window, AreaWindow, EpipolarBand]


def epipolar_band_mask(F12, xy1, xy2, octave2, sigma2_per_level, chi2_th: float = 3.84):
    """[N1, N2] mask: point 2 lies near the epipolar line l = F12 (x1, y1, 1)
    of point 1, scale-aware (CheckDistEpipolarLine, ORBmatcher.cc:1646-1664)."""
    x, y = xy1[:, 0], xy1[:, 1]
    a, b, c = (x * F12[i, 0] + y * F12[i, 1] + F12[i, 2] for i in range(3))
    a, b, c = a[:, None], b[:, None], c[:, None]
    num = a * xy2[None, :, 0] + b * xy2[None, :, 1] + c
    dsqr = (num * num) / (a * a + b * b).clamp_min(1e-12)
    return dsqr < chi2_th * sigma2_per_level[octave2.long()][None, :]


def geometry_mask(geometry: Geometry, valid_q, valid_t) -> torch.Tensor:
    """The dense [Nq, Nt] candidacy mask K5 evaluates inline."""
    mask = valid_q[:, None] & valid_t[None, :]
    if isinstance(geometry, Window):
        w = geometry
        return projection_window_mask(w.uv, valid_t, w.xy, w.octave, valid_q, w.radius,
                                      w.scale_factors, w.pred_octave, w.slack, w.slack_up).T
    if isinstance(geometry, AreaWindow):
        d = geometry.xy_q[:, None, :] - geometry.xy_t[None, :, :]
        return mask & (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                       <= geometry.radius * geometry.radius)
    if isinstance(geometry, EpipolarBand):
        g = geometry
        s = g.scale_factors
        mask = mask & epipolar_band_mask(g.F12, g.xy_q, g.xy_t, g.octave_t, s * s)
        if g.epipole is not None:
            d = g.xy_t - g.epipole[None, :]
            me = torch.sqrt(100.0 * s[g.octave_t.long()])
            mask = mask & (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] > me * me)[None, :]
        return mask
    if geometry is None:
        return mask
    raise TypeError(f"unknown match geometry {type(geometry).__name__}")


def match_select_plain(desc_q, desc_t, valid_q, valid_t, max_dist: int, ratio: float = 1.0,
                       mutual: bool = True, window: Optional[Geometry] = None,
                       angle_q=None, angle_t=None) -> MatchResult:
    """Plain version of K5: the dense mask (valid_q x valid_t and the
    geometric test of `window`, if given), `match_masked`, and with angles
    the rotation filter. Returns MatchResult; `dist` is the best distance
    whether or not the match survived."""
    mask = geometry_mask(window, valid_q, valid_t)
    res = match_masked(desc_q, desc_t, mask, max_dist, ratio, mutual)
    if angle_q is None:
        return res
    ok = rotation_consistency(angle_q, angle_t[res.idx.clamp_min(0).long()], res.ok)
    return MatchResult(torch.where(ok, res.idx, torch.full_like(res.idx, NO_MATCH)), res.dist, ok)


def k5_workspace(device, B: int, Nt: int, stream: int = 0) -> tuple:
    """K5's column keys (at least B * Nt, int64, all COL_EMPTY) and batch
    tickets (at least B, int32, all 0) for one stream. They are kept from
    call to call: each call's last CTA of a batch restores its keys and
    ticket before the launch ends, so a call needs no fill. A call that
    needs more than the kept buffers gets new ones, filled once."""
    key = (torch.device(device), stream)
    cols, tick = _K5_WORK.get(key, (None, None))
    if cols is None or cols.numel() < B * Nt or tick.numel() < B:
        n_cols = max(B * Nt, 0 if cols is None else cols.numel())
        n_tick = max(B, 0 if tick is None else tick.numel())
        cols = torch.full((n_cols,), COL_EMPTY, dtype=torch.int64, device=device)
        tick = torch.zeros(n_tick, dtype=torch.int32, device=device)
        _K5_WORK[key] = (cols, tick)
    return cols, tick


def _launch_k5(counter: str, desc_q, desc_t, valid_q, valid_t, win_args, mode: int, B: int,
               max_dist: int, ratio: float, mutual: bool, angle_q=None, angle_t=None
               ) -> MatchResult:
    """K5's one launch over B batches of Nq queries (fields [B * Nq])."""
    Nq, Nt = desc_q.shape[0], desc_t.shape[-2]
    dev = desc_q.device
    p = kernels.ptr
    cols, tick = k5_workspace(dev, B, Nt, kernels.stream())
    rows = torch.empty(2 * B * Nq, dtype=torch.int32, device=dev)
    idx = torch.empty(B * Nq, dtype=torch.int32, device=dev)
    dist = torch.empty(B * Nq, dtype=torch.int32, device=dev)
    ok = torch.empty(B * Nq, dtype=torch.bool, device=dev)
    rot = angle_q is not None
    kernels.launch(
        counter, "match_select", p(desc_q), p(desc_t), p(valid_q), p(valid_t), *win_args,
        Nq, Nt, B, mode, int(max_dist), float(ratio), int(ratio < 1.0),
        p(angle_q) if rot else None, p(angle_t) if rot else None,
        p(cols) if mutual else None, p(tick), p(rows), p(idx), p(dist), p(ok))
    return MatchResult(idx, dist, ok)


def _band_geo(F12, epipole) -> tuple:
    """K5's per-batch band geometry [B, 11] (F12 row-major, the epipole) and
    its mode: 4 with the epipole guard, 3 without."""
    B = F12.reshape(-1, 9).shape[0]
    e = epipole if epipole is not None else torch.zeros(B, 2, device=F12.device)
    geo = torch.cat([F12.reshape(B, 9), e.reshape(B, 2)], 1).to(torch.float32).contiguous()
    return geo, 3 if epipole is None else 4


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
    win_args, mode, counter = [None] * 6 + [0.0, 0, 0], 0, "match_masked"
    if isinstance(window, Window):
        chk(window.uv, "window.uv", torch.float32, (Nt, 2), dev)
        chk(window.xy, "window.xy", torch.float32, (Nq, 2), dev)
        chk(window.octave, "window.octave", torch.int32, (Nq,), dev)
        chk(window.pred_octave, "window.pred_octave", torch.int32, (Nt,), dev)
        chk(window.scale_factors, "window.scale_factors", torch.float32, None, dev)
        win_args = [p(window.uv), p(window.xy), p(window.octave), p(window.pred_octave),
                    p(window.scale_factors), None, float(window.radius), int(window.slack),
                    int(window.slack_up)]
        mode = 1
    elif isinstance(window, AreaWindow):
        chk(window.xy_t, "window.xy_t", torch.float32, (Nt, 2), dev)
        chk(window.xy_q, "window.xy_q", torch.float32, (Nq, 2), dev)
        win_args = [p(window.xy_t), p(window.xy_q), None, None, None, None,
                    float(window.radius * window.radius), 0, 0]
        mode, counter = 2, "match_area"
    elif isinstance(window, EpipolarBand):
        if angle_q is not None:
            raise ValueError("match_select: no rotation check with an EpipolarBand")
        res = _band_search_cuda(desc_q, valid_q[None], window.xy_q, desc_t[None],
                                 valid_t[None], window.xy_t[None], window.octave_t[None],
                                 window.F12[None],
                                 None if window.epipole is None else window.epipole[None],
                                 window.scale_factors, max_dist, ratio, mutual)
        return MatchResult(*(t[0] for t in res))
    elif window is not None:
        raise TypeError(f"unknown match geometry {type(window).__name__}")
    if angle_q is not None:
        chk(angle_q, "angle_q", torch.float32, (Nq,), dev)
        chk(angle_t, "angle_t", torch.float32, (Nt,), dev)
    return _launch_k5(counter, desc_q, desc_t, valid_q, valid_t, win_args, mode, 1, max_dist,
                      ratio, mutual, angle_q, angle_t)


def _band_search_cuda(desc_q, valid_q, xy_q, desc_t, valid_t, xy_t, octave_t, F12, epipole,
                      scale_factors, max_dist, ratio, mutual) -> MatchResult:
    B, Nt = desc_t.shape[0], desc_t.shape[1]
    Nq = desc_q.shape[0]
    dev = desc_q.device
    if Nt < 2:
        raise ValueError("band_search needs at least two targets (a best and a second)")
    if Nq > MAX_FINISH_N:
        raise ValueError(f"band_search takes at most {MAX_FINISH_N} queries")
    chk = kernels.check
    chk(desc_q, "desc_q", torch.uint8, (Nq, 32), dev)
    chk(valid_q, "valid_q", torch.bool, (B, Nq), dev)
    chk(xy_q, "xy_q", torch.float32, (Nq, 2), dev)
    chk(desc_t, "desc_t", torch.uint8, (B, Nt, 32), dev)
    chk(valid_t, "valid_t", torch.bool, (B, Nt), dev)
    chk(xy_t, "xy_t", torch.float32, (B, Nt, 2), dev)
    chk(octave_t, "octave_t", torch.int32, (B, Nt), dev)
    chk(scale_factors, "scale_factors", torch.float32, None, dev)
    geo, mode = _band_geo(F12, epipole)
    chk(geo, "F12 / epipole", torch.float32, (B, 11), dev)
    p = kernels.ptr
    win_args = [p(xy_t), p(xy_q), None, p(octave_t), p(scale_factors), p(geo), 0.0, 0, 0]
    res = _launch_k5("match_band", desc_q, desc_t, valid_q, valid_t, win_args, mode, B,
                     max_dist, ratio, mutual)
    return MatchResult(*(t.view(B, Nq) for t in res))


def band_search_plain(desc_q, valid_q, xy_q, desc_t, valid_t, xy_t, octave_t, F12, epipole,
                      scale_factors, max_dist: int, ratio: float = 1.0,
                      mutual: bool = True) -> MatchResult:
    """Plain version of K5's batched band mode: `match_select_plain` with an
    `EpipolarBand` for each batch b (targets desc_t[b], valid_t[b], xy_t[b],
    octave_t[b], geometry F12[b], epipole[b]; query flags valid_q[b])."""
    out = [match_select_plain(
        desc_q, desc_t[b], valid_q[b], valid_t[b], max_dist, ratio, mutual,
        EpipolarBand(F12[b], xy_t[b], xy_q, octave_t[b], scale_factors,
                     None if epipole is None else epipole[b]))
        for b in range(desc_t.shape[0])]
    return MatchResult(*(torch.stack(f) for f in zip(*out)))


def band_search(desc_q, valid_q, xy_q, desc_t, valid_t, xy_t, octave_t, F12, epipole,
                scale_factors, max_dist: int, ratio: float = 1.0,
                mutual: bool = True) -> MatchResult:
    """The epipolar-band search of one keyframe's features (desc_q, xy_q
    [Nq]) in each of B target sets at once ([B, Nt] targets, [B, Nq] query
    flags, F12 [B, 3, 3], epipole [B, 2] or None): MatchResult fields
    [B, Nq]. K5 in band mode on CUDA tensors (one launch for all batches),
    the plain version on CPU tensors."""
    args = (desc_q, valid_q, xy_q, desc_t, valid_t, xy_t, octave_t, F12, epipole,
            scale_factors, max_dist, ratio, mutual)
    if desc_q.is_cuda:
        return _band_search_cuda(*args)
    if desc_q.device.type == "cpu":
        return band_search_plain(*args)
    raise ValueError(f"unsupported device {desc_q.device}")


def match_select(desc_q, desc_t, valid_q, valid_t, max_dist: int, ratio: float = 1.0,
                 mutual: bool = True, window: Optional[Geometry] = None,
                 angle_q=None, angle_t=None) -> MatchResult:
    """Masked best match of every query (K5 on CUDA tensors, the plain
    version on CPU tensors). The mask is valid_q x valid_t, and with a
    `window` (`Window`, `AreaWindow` or `EpipolarBand`) also its geometric
    test; with `angle_q`/`angle_t` the rotation-consistency filter is
    applied to the accepted matches."""
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


# ---------------------------------------------------------------------------
# Mono initialization and triangulation
# ---------------------------------------------------------------------------

def search_for_initialization(xy1, desc1, angle1, valid1, xy2, desc2, angle2, valid2,
                              window: float = 100.0, max_dist: int = 50, ratio: float = 0.9,
                              check_rotation: bool = True) -> MatchResult:
    """Area-window matching between two monocular frames for map
    initialization (SearchForInitialization, ORBmatcher.cc h70): per frame-1
    feature, an index into frame 2's features."""
    return match_select(desc1, desc2, valid1, valid2, max_dist, ratio, True,
                        AreaWindow(xy2, xy1, float(window)),
                        angle1 if check_rotation else None, angle2 if check_rotation else None)


def search_for_triangulation(desc1, xy1, valid1, has_mp1, desc2, xy2, octave2, valid2, has_mp2,
                             F12, scale_factors, epi_center2=None, max_dist: int = 50
                             ) -> MatchResult:
    """Epipolar-constrained matching of unbound features between two
    keyframes (SearchForTriangulation, ORBmatcher.cc h73), ratio 1.0 and
    mutual; with `epi_center2` the targets within sqrt(100 scale) px of the
    epipole are left out. `scale_factors` is the per-level scale table (the
    reference passes its square, sigma^2, for the band)."""
    band = EpipolarBand(F12, xy2, xy1, octave2, scale_factors, epi_center2)
    return match_select(desc1, desc2, valid1 & ~has_mp1, valid2 & ~has_mp2, max_dist, 1.0, True,
                        band)


def fundamental_from_poses(cam1, Tcw1, cam2, Tcw2) -> torch.Tensor:
    """F12 with x2^T F12 x1 = 0 (ComputeF12, LocalMapping.cc:660), batched
    over the leading dimensions of Tcw2: K2^-T [t21]x R21 K1^-1 with
    T21 = inverse(Tcw1 inverse(Tcw2))."""
    T21 = se3.inverse(se3.compose(Tcw1, se3.inverse(Tcw2)))
    E21 = se3.hat(se3.translation(T21)) @ se3.rotation(T21)
    K1inv = torch.linalg.inv(cam1.K).to(Tcw2.device)
    K2inv = torch.linalg.inv(cam2.K).to(Tcw2.device)
    return K2inv.T @ E21 @ K1inv
