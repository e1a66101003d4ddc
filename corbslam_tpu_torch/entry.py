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
no timers). `tracker_entry(loop_closer=True)` attaches a `LoopCloser` with the
shipped vocabulary (`assets/vocab32k.npz`) and global BA off.

`sensor_entry()` is the flagship's camera, config and world driven through
the tracker's other two sensors, one frame per call:
`run_sensor(tracker, te, "mono" | "rgbd", n)` feeds frame i =
`world.render(gt_pose(i))` (the left image of `render_stereo`) and, for
RGB-D, `world.depth(gt_pose(i))`, at timestamp 0.1 i, then flushes. The
JAX reference's run of the same input bootstraps mono at frame 5 (30
frames: 5 keyframes, 1211 points, similarity-aligned ATE 0.323 m) and tracks
all 40 RGB-D frames (2 keyframes, 2906 points, ATE 0.00426 m).

`loop_entry()` is the loop-closure validation setup of the reference
(`tools/loop_e2e.py:36-65`, `tests/test_loop_e2e.py:27-40`): a 320x240
camera, 512 features on 4 levels, capacities 256 keyframes / 32768 points,
the closed room `MultiPlaneWorld.room(half 14, height 3, seed 2)` rendered on
`device`, and the orbit `orbit_pose(i)` of radius 5 m stepping 0.10 rad, one
lap (63 frames) and 8 more; its tracker carries a `LoopCloser` (fixed scale,
global BA off, seed 0) on client 1.

`e2e_entry()` is the reference's end-to-end loop fixture
(`tests/test_loop_e2e.py:27-78`, `bench.py:161-170`): the same camera and
config, the room with photometric noise of std 3 (seed 2), the orbit of
radius 6 m at 0.05 rad a frame for 151 frames (one lap and 25), a
1024-word vocabulary trained (6 iterations) on the valid descriptors of
frames 0, N/3 and 2N/3 (left images through `build_frame_mono`), and a
`system.CorbslamClient` on client 1 with global BA (synchronous).
`e2e_entry(laps=True)` is its 2.5-lap variant (0.1 rad a frame, 158 frames,
global BA asynchronous); `run_e2e` feeds a client every frame, frame i
rendered with `frame=i` at timestamp 0.1 i, and shuts it down.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import kernels
from .config import (KITTI_STEREO, CapacityConfig, MappingConfig, OrbConfig, SlamConfig,
                     TrackingConfig)
from .frontend import frame as frame_mod
from .frontend import track_ops
from .frontend.tracking import StereoTracker
from .geometry import camera, se3
from .io import synthetic
from .loop.loop_closing import LoopCloser
from .mapstate import mapstate as ms
from .place import vocab
from .system import CorbslamClient

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


def loop_closer_for(cam, cfg: SlamConfig, device, seed: int = 0) -> LoopCloser:
    """A LoopCloser with the shipped vocabulary on `device`, fixed scale
    (stereo), global BA off."""
    voc = vocab.load_default(kernels.resolve_device(device))
    if voc is None:
        raise FileNotFoundError(vocab.default_artifact_path())
    return LoopCloser(cam, cfg, voc, fix_scale=True, run_gba=False, seed=seed)


def tracker_entry(device="cuda", loop_closer: bool = False):
    """(StereoTracker on `device`, TrackEntry): the flagship cell's tracker,
    camera, config and world; frames come from
    `world.render_stereo(gt_pose(i))`."""
    dev = kernels.resolve_device(device)
    te = track_entry(dev)._replace(cfg=bench_config())
    lc = loop_closer_for(te.cam, te.cfg, dev) if loop_closer else None
    return StereoTracker(te.cam, te.cfg, loop_closer=lc, device=dev), te


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


MONO_FRAMES, RGBD_FRAMES = 30, 40


def sensor_entry(device="cuda"):
    """(StereoTracker on `device`, TrackEntry) for `process_mono` or
    `process_rgbd` (the plane's depth map) on the flagship camera,
    KITTI_STEREO and world; `run_sensor` picks the sensor."""
    te = track_entry(device)
    return StereoTracker(te.cam, te.cfg, device=te.world.device), te


def run_sensor(tracker: StereoTracker, te: TrackEntry, sensor: str, n: int, step=None) -> None:
    """Frames 0 .. n-1 of the bench trajectory through `process_mono` or
    `process_rgbd`, then a flush; `step(i, fn)` runs frame i's call (fn())
    and, with i None, the flush."""
    if sensor not in ("mono", "rgbd"):
        raise ValueError(f"run_sensor: sensor {sensor!r} is not 'mono' or 'rgbd'")
    if step is None:
        def step(_, fn):
            fn()

    for i in range(n):
        T = gt_pose(i)
        img = te.world.render(T)
        if sensor == "mono":
            step(i, lambda: tracker.process_mono(img, i * 0.1))
        else:
            depth = te.world.depth(T)
            step(i, lambda: tracker.process_rgbd(img, depth, i * 0.1))
    step(None, tracker.flush)


LOOP_CAM = camera.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5,
                                    width=320, height=240)
LOOP_STEP, LOOP_RADIUS = 0.10, 5.0
LOOP_FRAMES = int(np.ceil(2 * np.pi / LOOP_STEP)) + 8  # one lap and 8 frames


def loop_config() -> SlamConfig:
    """The loop-validation config (tools/loop_e2e.py:41-51)."""
    return SlamConfig(
        orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
        tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=10),
        mapping=MappingConfig(local_ba_window=8, local_ba_iters=6),
        capacity=CapacityConfig(max_keyframes=256, max_map_points=32768, max_features=512,
                                local_window_kfs=8, local_window_mps=2048),
    )


def orbit_pose(i: int, step: float = LOOP_STEP, radius: float = LOOP_RADIUS) -> torch.Tensor:
    """Tcw of orbit frame i: the camera on a circle of `radius` in the room,
    looking outward, yawed by step * i ([4, 4] f32 on the CPU)."""
    Twc = se3.compose(se3.exp(torch.tensor([0.0, 0.0, 0.0, 0.0, step * i, 0.0])),
                      se3.from_Rt(torch.eye(3), torch.tensor([0.0, 0.0, -radius])))
    return se3.inverse(Twc)


class LoopEntry(NamedTuple):
    cam: camera.Intrinsics
    cfg: SlamConfig
    world: synthetic.MultiPlaneWorld


def loop_entry(device="cuda"):
    """(StereoTracker with its LoopCloser on `device`, LoopEntry); frame i is
    `world.render_stereo(orbit_pose(i))` at timestamp 0.1 i."""
    dev = kernels.resolve_device(device)
    cfg = loop_config()
    world = synthetic.MultiPlaneWorld.room(LOOP_CAM, half=14.0, height=3.0, seed=2, device=dev)
    lc = loop_closer_for(LOOP_CAM, cfg, dev)
    return StereoTracker(LOOP_CAM, cfg, client=1, loop_closer=lc, device=dev), \
        LoopEntry(LOOP_CAM, cfg, world)


E2E_STEP, E2E_RADIUS = 0.05, 6.0
E2E_FRAMES = int(np.ceil(2 * np.pi / E2E_STEP)) + 25  # one lap and the revisit's overlap
E2E_LAPS_STEP = 0.1
E2E_LAPS_FRAMES = int(np.ceil(2.5 * 2 * np.pi / E2E_LAPS_STEP))  # 2.5 laps
E2E_WORDS, E2E_TRAIN_ITERS = 1024, 6


class E2EEntry(NamedTuple):
    cam: camera.Intrinsics
    cfg: SlamConfig
    world: synthetic.MultiPlaneWorld
    step: float            # rad a frame
    n_frames: int
    corpus: torch.Tensor   # [N, 32] u8 the vocabulary's training descriptors


def e2e_frame(ee: E2EEntry, i: int):
    """(left, right) of orbit frame i with that frame's noise."""
    return ee.world.render_stereo(orbit_pose(i, ee.step, E2E_RADIUS), frame=i)


def e2e_entry(sensor: str = "stereo", device="cuda", laps: bool = False, n_words: int = E2E_WORDS,
              n_iters: int = E2E_TRAIN_ITERS, client_id: int = 1):
    """(CorbslamClient on `device`, E2EEntry): the end-to-end loop fixture
    (see the module docstring), its vocabulary trained on `device`;
    `client_id` seeds the client's draws (the fixture's is 1)."""
    dev = kernels.resolve_device(device)
    cfg = loop_config()
    world = synthetic.MultiPlaneWorld.room(LOOP_CAM, half=14.0, height=3.0, noise_std=3.0,
                                           seed=2, device=dev)
    step, n = (E2E_LAPS_STEP, E2E_LAPS_FRAMES) if laps else (E2E_STEP, E2E_FRAMES)
    ee = E2EEntry(LOOP_CAM, cfg, world, step, n, torch.empty(0, 32, dtype=torch.uint8))
    descs = []
    for i in (0, n // 3, 2 * n // 3):
        f = frame_mod.build_frame_mono(e2e_frame(ee, i)[0], LOOP_CAM, cfg.orb, device=dev)
        descs.append(f.desc[f.fvalid])
    ee = ee._replace(corpus=torch.cat(descs).contiguous())
    voc = vocab.train(ee.corpus, n_words=n_words, n_iters=n_iters)
    client = CorbslamClient(LOOP_CAM, cfg, sensor=sensor, client_id=client_id, voc=voc,
                            run_gba=True, device=dev)
    client.loop_closer.gba_runner.synchronous = not laps
    return client, ee


def run_e2e(client: CorbslamClient, ee: E2EEntry, step=None, n: int | None = None) -> None:
    """Frames 0 .. n-1 (default all) through `track_stereo`, or the left
    image through `track_monocular` for a mono client, then `shutdown`;
    `step(i, fn)` runs frame i's call (fn()) and, with i None, the shutdown."""
    if step is None:
        def step(_, fn):
            fn()

    for i in range(ee.n_frames if n is None else n):
        left, right = e2e_frame(ee, i)
        if client.sensor == "mono":
            step(i, lambda: client.track_monocular(left, i * 0.1))
        else:
            step(i, lambda: client.track_stereo(left, right, i * 0.1))
    step(None, client.shutdown)
