"""Stereo correspondence for extracted features (port of
`corbslam_tpu/ops/stereo.py`, `match_stereo_features`).

For each left keypoint: the best right keypoint by Hamming distance among
candidates on the same row band (|dy| <= 2 * scale of the right octave),
with disparity in [-1, max_disp], octave within +-1 and both valid; accepted
at distance <= max_hamming. Then an 11-position SAD slide of the 11x11
centre windows of the two raw patches, a parabola through the best SAD and
its neighbours, and a cut at 2.1 x the median best SAD. As in the reference,
the median is NaN (so the cut removes nothing) unless every left feature
passed, and otherwise averages the two middle values.

`stereo_match` is the wrapper of kernel K4 (`csrc/stereo_match.cu`): one
launch on CUDA inputs (the candidates bucketed by row, the SAD slide a warp
a feature, the median cut by the last CTA, whose ticket word lives in
`k4_workspace`), `stereo_match_plain` on CPU inputs.

`finish_keypoints` finishes a frame's keypoints for every sensor: the
undistorted keypoints (`camera.undistort_points`), and for RGB-D the depth
map read at the raw keypoint rounded half to even with u_right from the
undistorted x (Frame::ComputeStereoFromRGBD, Frame.cc:647,
`compute_stereo_from_rgbd`), for mono u_right -1 and depth 0. On CUDA
inputs it is K4's `finish_keypoints` entry, one launch (its own launch
counter), on CPU inputs `finish_keypoints_plain`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..geometry import camera as cam_mod
from . import descriptors as D

PATCH_W = 5  # half-width of the SAD window (11x11 like the reference)
SLIDE_R = 5  # +-5 px refinement slide


class StereoMatch(NamedTuple):
    idx: torch.Tensor      # [N] i32 best right keypoint (0 when none)
    dist: torch.Tensor     # [N] i32 its masked Hamming distance (512 when none)
    u_right: torch.Tensor  # [N] f32 level-0 right x, -1 where not ok
    depth: torch.Tensor    # [N] f32 bf / disparity, 0 where not ok
    ok: torch.Tensor       # [N] bool


def stereo_match_plain(fl, fr, scale_factors: torch.Tensor, bf: float,
                       max_disp: int = 192, max_hamming: int = 80) -> StereoMatch:
    """Plain PyTorch version of kernel K4 (the reference's algorithm as written)."""
    xy_l, xy_r = fl.xy, fr.xy
    row_tol = 2.0 * scale_factors[fr.octave.long()]
    d_row = (xy_l[:, None, 1] - xy_r[None, :, 1]).abs()
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    mask = (d_row <= row_tol[None, :]) & (disp >= -1.0) & (disp <= float(max_disp))
    mask &= (fl.octave[:, None] - fr.octave[None, :]).abs() <= 1
    mask &= fl.valid[:, None] & fr.valid[None, :]
    dmat = D.masked_hamming_matrix(fl.desc, fr.desc, extra_mask=mask)
    idx, dist, desc_ok = D.best_match(dmat, max_dist=max_hamming)
    u_r0 = xy_r[idx, 0]

    C = fl.patch.shape[-1] // 2
    right_sel = fr.patch[idx]
    Lw = fl.patch[:, C - PATCH_W:C + PATCH_W + 1, C - PATCH_W:C + PATCH_W + 1]
    sad = torch.stack(
        [(right_sel[:, C - PATCH_W:C + PATCH_W + 1,
                    C + s - PATCH_W:C + s + PATCH_W + 1] - Lw).abs().sum(dim=(1, 2))
         for s in range(-SLIDE_R, SLIDE_R + 1)],
        dim=-1,
    )  # [N, 11]
    best = torch.argmin(sad, dim=-1)
    bir = best.clamp(1, 2 * SLIDE_R - 1)
    s0 = sad.gather(1, (bir - 1)[:, None])[:, 0]
    s1 = sad.gather(1, bir[:, None])[:, 0]
    s2 = sad.gather(1, (bir + 1)[:, None])[:, 0]
    denom = s0 + s2 - 2.0 * s1
    delta = torch.where(denom.abs() > 1e-6, 0.5 * (s0 - s2) / denom.clamp_min(1e-6),
                        torch.zeros_like(denom))
    delta = delta.clamp(-1.0, 1.0)
    shift_lvl = (bir - SLIDE_R).to(torch.float32) + delta
    u_right = u_r0 + shift_lvl * scale_factors[fr.octave[idx].long()]

    disparity = xy_l[:, 0] - u_right
    ok = desc_ok & (disparity > 0.1) & (disparity < float(max_disp))
    best_sad = s1
    srt = torch.sort(best_sad).values
    n = srt.shape[0]
    mid = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5
    med = torch.where(ok.all(), mid, torch.full_like(mid, float("inf")))
    ok = ok & (best_sad <= 2.1 * med + 1e-3)
    depth = torch.where(ok, bf / disparity.clamp_min(0.1), torch.zeros_like(disparity))
    u_right = torch.where(ok, u_right, torch.full_like(u_right, -1.0))
    return StereoMatch(idx.to(torch.int32), dist, u_right, depth, ok)


MAX_FINISH_N = 12288  # left features K4's last CTA ranks in 48 KB of shared memory
_K4_WORK: dict = {}


def k4_workspace(device, stream: int = 0) -> torch.Tensor:
    """K4's ticket word (1 int32, 0: the CTAs done in its low 16 bits, their
    failed features above) for one stream, kept from call to call: the
    launch's last CTA sets it back to 0."""
    key = (torch.device(device), stream)
    work = _K4_WORK.get(key)
    if work is None:
        work = _K4_WORK[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return work


def _stereo_match_cuda(fl, fr, scale_factors, bf, max_disp, max_hamming) -> StereoMatch:
    N, M = fl.xy.shape[0], fr.xy.shape[0]
    P = fl.patch.shape[-1]
    dev = fl.xy.device
    if P != 32 or fr.patch.shape[-1] != 32:
        raise ValueError("stereo_match expects 32x32 raw patches")
    if M < 1:
        raise ValueError("stereo_match needs at least one right feature")
    if not 1 <= N <= MAX_FINISH_N:
        raise ValueError(f"stereo_match takes 1 to {MAX_FINISH_N} left features, got {N}")
    for side, f, n in (("left", fl, N), ("right", fr, M)):
        kernels.check(f.xy, f"{side}.xy", torch.float32, (n, 2), dev)
        kernels.check(f.octave, f"{side}.octave", torch.int32, (n,), dev)
        kernels.check(f.valid, f"{side}.valid", torch.bool, (n,), dev)
        kernels.check(f.desc, f"{side}.desc", torch.uint8, (n, 32), dev)
        kernels.check(f.patch, f"{side}.patch", torch.float32, (n, 32, 32), dev)
    kernels.check(scale_factors, "scale_factors", torch.float32, None, dev)
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    dist = torch.empty(N, dtype=torch.int32, device=dev)
    best_sad, u_right, depth = (torch.empty(N, dtype=torch.float32, device=dev) for _ in range(3))
    ok = torch.empty(N, dtype=torch.bool, device=dev)
    p = kernels.ptr
    kernels.launch(
        "stereo_match", "stereo_match",
        p(fl.xy), p(fl.octave), p(fl.valid), p(fl.desc), p(fl.patch),
        p(fr.xy), p(fr.octave), p(fr.valid), p(fr.desc), p(fr.patch),
        p(scale_factors), N, M, scale_factors.numel(), float(max_disp), int(max_hamming),
        float(bf), p(k4_workspace(dev, kernels.stream())), p(best_sad),
        p(idx), p(dist), p(u_right), p(depth), p(ok),
    )
    return StereoMatch(idx, dist, u_right, depth, ok)


def stereo_match(fl, fr, scale_factors, bf: float, max_disp: int = 192,
                 max_hamming: int = 80) -> StereoMatch:
    """Stereo match of every left feature; u_right < 0 marks monocular
    points, all coordinates are level-0 pixels. Kernel K4 on CUDA features,
    the plain version on CPU features."""
    if fl.xy.is_cuda:
        return _stereo_match_cuda(fl, fr, scale_factors, bf, max_disp, max_hamming)
    if fl.xy.device.type == "cpu":
        return stereo_match_plain(fl, fr, scale_factors, bf, max_disp, max_hamming)
    raise ValueError(f"unsupported device {fl.xy.device}")


class RgbdStereo(NamedTuple):
    u_right: torch.Tensor  # [N] f32, -1 where not ok
    depth: torch.Tensor    # [N] f32, 0 where not ok
    ok: torch.Tensor       # [N] bool


MIN_DEPTH = 0.05  # metres: a depth read at or under it is no depth (Frame.cc:647)


def compute_stereo_from_rgbd(depth_map, xy, valid, bf: float, min_depth: float = MIN_DEPTH,
                             xy_und=None) -> RgbdStereo:
    """(u_right, depth, ok) of each feature from a registered depth map [h, w]:
    depth at the raw keypoint `xy` rounded half to even and clamped into the
    image; u_right = x_und - bf / max(d, min_depth) where valid and
    d > min_depth, else -1 (depth 0). Plain PyTorch on any device: the RGB-D
    half of `finish_keypoints_plain`."""
    if xy_und is None:
        xy_und = xy
    h, w = depth_map.shape
    xi = torch.round(xy[:, 0]).to(torch.int32).clamp(0, w - 1)
    yi = torch.round(xy[:, 1]).to(torch.int32).clamp(0, h - 1)
    d = depth_map.reshape(-1)[(yi * w + xi).long()]
    ok = valid & (d > min_depth)
    dm = d.clamp_min(min_depth)
    u_right = torch.where(ok, xy_und[:, 0] - torch.full_like(dm, bf) / dm,
                          torch.full_like(d, -1.0))
    return RgbdStereo(u_right, torch.where(ok, d, torch.zeros_like(d)), ok)


FINISH_MODES = {"stereo": 0, "mono": 1, "rgbd": 2}  # the C entry's FINISH_* modes


class Finished(NamedTuple):
    xy_und: torch.Tensor             # [N, 2] f32 undistorted keypoints
    u_right: Optional[torch.Tensor]  # [N] f32: rgbd from the depth map, mono -1, stereo None
    depth: Optional[torch.Tensor]    # [N] f32: rgbd the depth read, mono 0, stereo None
    ok: Optional[torch.Tensor]       # [N] bool: rgbd a depth above MIN_DEPTH, else None


def finish_keypoints_plain(cam, xy, valid=None, depth_map=None, mode: str = "stereo") -> Finished:
    """Plain version of K4's `finish_keypoints`: `camera.undistort_points`,
    then `compute_stereo_from_rgbd` (rgbd) or the -1 / 0 fill (mono)."""
    xy_und = cam_mod.undistort_points(cam, xy)
    if mode == "stereo":
        return Finished(xy_und, None, None, None)
    if mode == "mono":
        N = xy.shape[0]
        return Finished(xy_und, torch.full((N,), -1.0, dtype=torch.float32, device=xy.device),
                        torch.zeros(N, dtype=torch.float32, device=xy.device), None)
    r = compute_stereo_from_rgbd(depth_map, xy, valid, float(cam.bf), xy_und=xy_und)
    return Finished(xy_und, r.u_right, r.depth, r.ok)


def _finish_cuda(cam, xy, valid, depth_map, mode) -> Finished:
    dev = xy.device
    N = xy.shape[0]
    kernels.check(xy, "xy", torch.float32, (N, 2), dev)
    h = w = 0
    if mode == "rgbd":
        h, w = depth_map.shape
        kernels.check(depth_map, "depth_map", torch.float32, (h, w), dev)
        kernels.check(valid, "valid", torch.bool, (N,), dev)
    xy_und = torch.empty(N, 2, dtype=torch.float32, device=dev)
    u_right = depth = ok = None
    if mode != "stereo":
        u_right = torch.empty(N, dtype=torch.float32, device=dev)
        depth = torch.empty(N, dtype=torch.float32, device=dev)
    if mode == "rgbd":
        ok = torch.empty(N, dtype=torch.bool, device=dev)
    p = lambda t: None if t is None else kernels.ptr(t)  # noqa: E731
    k1, k2, p1, p2, k3 = cam.dist
    kernels.launch("finish_keypoints", "finish_keypoints", p(xy),
                   p(valid if mode == "rgbd" else None), p(depth_map if mode == "rgbd" else None),
                   h, w, N, FINISH_MODES[mode], cam.fx, cam.fy, cam.cx, cam.cy, k1, k2, p1, p2,
                   k3, 2 * p1, 2 * p2, float(cam.bf), MIN_DEPTH, p(xy_und), p(u_right),
                   p(depth), p(ok))
    return Finished(xy_und, u_right, depth, ok)


def finish_keypoints(cam, xy, valid=None, depth_map=None, mode: str = "stereo") -> Finished:
    """The one step that finishes a frame's raw level-0 keypoints `xy` [N, 2]:
    undistorted by the camera, and by `mode`: "stereo" nothing more (K4's
    `stereo_match` gives u_right and depth), "mono" u_right -1 / depth 0,
    "rgbd" (u_right, depth, ok) from the registered depth map [h, w] at the
    raw keypoints (`compute_stereo_from_rgbd`; `valid` [N] the features').
    Kernel K4's `finish_keypoints` entry on CUDA keypoints, the plain
    version on CPU keypoints."""
    if mode not in FINISH_MODES:
        raise ValueError(f"finish_keypoints: mode {mode!r} not in {sorted(FINISH_MODES)}")
    if xy.is_cuda:
        return _finish_cuda(cam, xy, valid, depth_map, mode)
    if xy.device.type == "cpu":
        return finish_keypoints_plain(cam, xy, valid, depth_map, mode)
    raise ValueError(f"unsupported device {xy.device}")
