"""The flagship steps on the port at KITTI geometry (1241x376, 2048 features,
8 levels).

`entry()` is the stereo ORB front end on the entry-point input of the
reference (`random_texture(376, 1241, seed=0)`, right image = left rolled by
-12 px), run by `build_frame_stereo` on `device`.

`track_entry()` is the tracking setup of the reference's flagship bench
(`bench.py:290-305`): the bench camera, `KITTI_STEREO` at full capacity
(2048 keyframes, 131072 points, windows 32 / 8192), a `PlanarWorld` with a
4096 px texture 12 m away at 60 px per metre, rendered on `device`, and the
ground-truth trajectory `gt_pose(i)`: a camera pitched by 0.35 rad moving
0.3 m sideways and 0.05 m forward per frame while yawing 0.002 rad.
`seed_map`, `track_step` and `add_keyframe` drive it: frame 0 seeds the map,
each later frame is tracked, and the caller decides after which frames to
insert a keyframe.

`tracker_entry()` is the flagship cell itself (`bench.py:281-327`): the same
camera, world and trajectory with `frames_per_dispatch=2`, driven through
`frontend.tracking.StereoTracker`; `run_bench_schedule` replays the bench's
schedule on a tracker: 6 frames, 6 forced keyframes, 12 more warm frames and
a flush, then two windows of 30 frames, each followed by a flush (no waits,
no timers).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .config import KITTI_STEREO, OrbConfig, SlamConfig
from .frontend import frame as frame_mod
from .frontend import track_ops
from .frontend.tracking import StereoTracker
from .geometry import camera, se3
from .io import synthetic
from .mapstate import mapstate as ms

CAM = camera.Intrinsics.create(
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
    width=1241, height=376,
)
CFG = OrbConfig(n_features=2048, n_levels=8)


def stereo_pair(seed: int = 0, shift: int = 12, h: int = 376, w: int = 1241):
    """(left, right) f32 numpy images: a random texture and its roll by -shift."""
    tex = synthetic.random_texture(h, w, seed=seed)
    return tex, np.roll(tex, -shift, axis=1).copy()


def entry(device="cuda"):
    """Returns (fwd, (img_l, img_r)) with fwd(img_l, img_r) -> FrameData."""
    def fwd(img_l, img_r):
        return frame_mod.build_frame_stereo(img_l, img_r, CAM, CFG, device=device)

    return fwd, stereo_pair()


def gt_pose(i: int) -> torch.Tensor:
    """Ground-truth Tcw of bench frame i ([4, 4] f32 on the CPU)."""
    tilt = se3.exp(torch.tensor([0.0, 0.0, 0.0, 0.35, 0.0, 0.0]))
    xi = torch.tensor([-(i * 0.3), 0.0, -(i * 0.05), 0.0, i * 0.002, 0.0], dtype=torch.float32)
    return se3.compose(tilt, se3.exp(xi))


def center_error(Tcw: torch.Tensor, i: int) -> float:
    """Distance in metres between the camera centre of Tcw, in a map seeded
    at frame 0 with Tcw = I, and frame i's true centre in that frame
    (gt_pose(i) composed with the inverse of gt_pose(0))."""
    T_gt = se3.compose(gt_pose(i), se3.inverse(gt_pose(0)))
    c_est = se3.translation(se3.inverse(Tcw.detach().cpu().to(torch.float32)))
    return float(torch.linalg.norm(c_est - se3.translation(se3.inverse(T_gt))))


class TrackEntry(NamedTuple):
    cam: camera.Intrinsics
    cfg: SlamConfig
    world: synthetic.PlanarWorld


class TrackState(NamedTuple):
    """What one tracked frame hands the next."""

    m: ms.MapState
    prev: frame_mod.FrameData
    velocity: torch.Tensor
    ref_kf: torch.Tensor
    local_rows: torch.Tensor
    local_ok: torch.Tensor


def seed_map(te: TrackEntry, img_l, img_r, device="cuda") -> TrackState:
    """Frame 0 as the first keyframe of an empty map at Tcw = I."""
    dev = kernels.resolve_device(device)
    cam, cfg, _ = te
    cur = frame_mod.build_frame_stereo(img_l, img_r, cam, cfg.orb, device=dev)
    cur = cur._replace(Tcw=torch.eye(4, device=dev))
    m, kf_row, mp_idx = track_ops.insert_keyframe_with_points(
        cam, ms.empty(cfg.capacity, dev), cur, 0, 0.0, cfg)
    K1 = cfg.capacity.local_window_kfs
    return TrackState(m, cur._replace(mp_idx=mp_idx), torch.eye(4, device=dev), kf_row,
                      torch.zeros(K1, dtype=torch.int32, device=dev),
                      torch.zeros(K1, dtype=torch.bool, device=dev))


def track_step(te: TrackEntry, st: TrackState, img_l, img_r, device="cuda"):
    """Track one stereo frame: returns (next state, 24-float summary)."""
    out = track_ops.track_frame_stereo(st.m, st.prev, st.velocity, img_l, img_r, st.ref_kf,
                                       st.local_rows, st.local_ok, te.cam, te.cfg, device=device)
    return TrackState(out.map, out.cur, out.velocity, out.ref_kf, out.local_rows,
                      out.local_ok), out.summary


def add_keyframe(te: TrackEntry, st: TrackState, frame_id: int) -> TrackState:
    """Insert the last tracked frame as a keyframe (and its new points); it
    becomes the reference keyframe."""
    m, kf_row, mp_idx = track_ops.insert_keyframe_with_points(te.cam, st.m, st.prev, frame_id,
                                                              0.1 * frame_id, te.cfg)
    return st._replace(m=m, prev=st.prev._replace(mp_idx=mp_idx), ref_kf=kf_row)


def track_entry(device="cuda") -> TrackEntry:
    """The bench camera, config and world on `device` (see the module
    docstring); frames come from `world.render_stereo(gt_pose(i))`."""
    dev = kernels.resolve_device(device)
    world = synthetic.PlanarWorld(CAM, texture_size=4096, plane_dist=12.0, texture_scale=60.0,
                                  seed=0, device=dev)
    return TrackEntry(CAM, KITTI_STEREO, world)


BENCH_WARM, BENCH_FORCED_KF, BENCH_WINDOW, BENCH_WINDOWS = 18, 6, 30, 2
BENCH_FRAMES = BENCH_WARM + BENCH_WINDOW * BENCH_WINDOWS


def bench_config() -> SlamConfig:
    """KITTI_STEREO with frames_per_dispatch=2, the flagship cell's config."""
    return KITTI_STEREO.replace(tracking=dataclasses.replace(KITTI_STEREO.tracking,
                                                             frames_per_dispatch=2))


def tracker_entry(device="cuda"):
    """(StereoTracker on `device`, TrackEntry): the flagship cell's tracker,
    camera, config and world; frames come from
    `world.render_stereo(gt_pose(i))`."""
    dev = kernels.resolve_device(device)
    te = track_entry(dev)._replace(cfg=bench_config())
    return StereoTracker(te.cam, te.cfg, device=dev), te


def run_bench_schedule(tracker: StereoTracker, frames, step=None, stop=None, start=0) -> None:
    """The flagship schedule of bench.py:314-327,357-380 on `tracker`, for
    `frames` [(left, right)]; frame i has timestamp 0.1 i. `step(i, fn)`
    runs each measured frame's `process_stereo` (fn()) and, with i None, the
    flush that ends each measured window (bench.py times it inside the
    window); by default it just calls fn. With `stop`, only frames 0 ..
    stop - 1 of the schedule are fed (stop > 6, after the forced keyframes),
    then the tracker is flushed; with `start` (< 6) the tracker has had
    frames 0 .. start - 1 already."""
    n = BENCH_FRAMES if stop is None else stop
    if n <= BENCH_FORCED_KF or len(frames) < n or not 0 <= start < BENCH_FORCED_KF:
        raise ValueError(f"run_bench_schedule: {len(frames)} frames, stop={stop}: needs "
                         f"{BENCH_FORCED_KF} < stop <= frames and 0 <= start < "
                         f"{BENCH_FORCED_KF}")
    if step is None:
        def step(_, fn):
            fn()

    def feed(i):
        return tracker.process_stereo(frames[i][0], frames[i][1], i * 0.1)

    for i in range(start, BENCH_FORCED_KF):
        feed(i)
    for k in range(BENCH_FORCED_KF):
        tracker._create_keyframe(tracker.last_frame, 0.05 * k, 120)
    for i in range(BENCH_FORCED_KF, min(BENCH_WARM, n)):
        feed(i)
    tracker.flush()
    for w in range(BENCH_WINDOWS):
        first = BENCH_WARM + w * BENCH_WINDOW
        if first >= n:
            break
        for i in range(first, min(first + BENCH_WINDOW, n)):
            step(i, lambda i=i: feed(i))
        step(None, tracker.flush)
