"""Where a stereo frame's time goes on the card.

    python -m corbslam_tpu_torch.profile_frame [--frames 10] [--trace PATH]
        [--track | --tracker | --rgbd | --mono]

Without `--track`: runs `build_frame_stereo` at the flagship geometry
(1241x376, 2048 features, 8 levels) on the entry input, warms up, then
traces `--frames` frames.

With `--track`: the tracked frame of `entry.track_entry()` (the bench's
camera, KITTI_STEREO at full capacity, its PlanarWorld on the card): frame
0 seeds the map, frames 1..5 warm up (a keyframe after frame 5), then
`--frames` further frames go through `track_frame_stereo` under the trace,
chained, with no keyframe inserted inside the traced window.

With `--tracker`: the flagship cell's `StereoTracker` (`entry.tracker_entry`,
frames_per_dispatch=2): the warm part of the bench schedule (6 frames, 6
forced keyframes, 12 frames, flush), then `--frames` further frames of the
schedule go through `process_stereo` under the trace, with their mapping
stages, ending with the window's flush.

With `--rgbd` or `--mono`: the RGB-D or the monocular tracker of
`entry.sensor_entry` (the flagship's camera, config and world; one
`process_rgbd` / `process_mono` call a frame): frames 0..9 of the bench
trajectory warm up (mono bootstraps at frame 5), then `--frames` further
frames go through the tracker under the trace, with their mapping stages,
ending with a flush.

Either way the trace is torch.profiler's (CPU + CUDA activities), and one
JSON object is printed: the wall time per frame, the device time per frame
of each kernel (the port's hand-written kernels and PyTorch's own), the
launches per frame, and the device's idle share of the wall time. `--trace
PATH` also writes the chrome trace. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import torch

from . import entry as entry_mod

WARM_FRAMES = 5
SENSOR_WARM = 10  # sensor frames before the trace (mono bootstraps at frame 5)


def tracked_frames(n: int):
    """A callable that tracks the next bench frame on the card, after the
    seed and WARM_FRAMES warm-up frames; `n` frames are pre-rendered."""
    te = entry_mod.track_entry("cuda")
    imgs = [te.world.render_stereo(entry_mod.gt_pose(i)) for i in range(WARM_FRAMES + n + 1)]
    st = entry_mod.seed_map(te, *imgs[0])
    for i in range(1, WARM_FRAMES + 1):
        st, _ = entry_mod.track_step(te, st, *imgs[i])
    st = entry_mod.add_keyframe(te, st, WARM_FRAMES)
    nxt = iter(range(WARM_FRAMES + 1, WARM_FRAMES + n + 1))

    def step():
        nonlocal st
        st, _ = entry_mod.track_step(te, st, *imgs[next(nxt)])

    return step


def tracker_frames(n: int):
    """A callable that feeds the next bench frame to the flagship tracker
    after the warm part of the schedule (the last call also flushes)."""
    tracker, te = entry_mod.tracker_entry("cuda")
    total = entry_mod.BENCH_WARM + n
    imgs = [te.world.render_stereo(entry_mod.gt_pose(i)) for i in range(total)]
    entry_mod.run_bench_schedule(tracker, imgs, stop=entry_mod.BENCH_WARM)
    nxt = iter(range(entry_mod.BENCH_WARM, total))

    def step():
        i = next(nxt)
        tracker.process_stereo(*imgs[i], i * 0.1)
        if i == total - 1:
            tracker.flush()

    return step


def sensor_frames(sensor: str, n: int):
    """A callable that feeds the next bench frame to the RGB-D or mono
    tracker of `entry.sensor_entry` after SENSOR_WARM frames (the last call
    also flushes); images and depth maps are pre-rendered."""
    tracker, te = entry_mod.sensor_entry("cuda")
    total = SENSOR_WARM + n
    frames = [(te.world.render(T), te.world.depth(T) if sensor == "rgbd" else None)
              for T in map(entry_mod.gt_pose, range(total))]

    def feed(i):
        img, depth = frames[i]
        if sensor == "rgbd":
            tracker.process_rgbd(img, depth, i * 0.1)
        else:
            tracker.process_mono(img, i * 0.1)

    for i in range(SENSOR_WARM):
        feed(i)
    nxt = iter(range(SENSOR_WARM, total))

    def step():
        i = next(nxt)
        feed(i)
        if i == total - 1:
            tracker.flush()

    return step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--trace", help="write the chrome trace to this file")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--track", action="store_true",
                      help="profile the tracked frame (track_frame_stereo) instead of the front end")
    mode.add_argument("--tracker", action="store_true",
                      help="profile the flagship StereoTracker's frames, mapping stages included")
    mode.add_argument("--rgbd", action="store_true",
                      help="profile the RGB-D tracker's frames (entry.sensor_entry)")
    mode.add_argument("--mono", action="store_true",
                      help="profile the monocular tracker's frames after its bootstrap")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_frame: needs a CUDA device")
    mode_name = next(m for m in ("tracker", "track", "rgbd", "mono", "front_end")
                     if m == "front_end" or getattr(args, m))
    if args.tracker:
        step = tracker_frames(args.frames)
    elif args.rgbd or args.mono:
        step = sensor_frames(mode_name, args.frames)
    elif args.track:
        step = tracked_frames(args.frames)
    else:
        fwd, imgs = entry_mod.entry("cuda")
        step = lambda: fwd(*imgs)  # noqa: E731
        for _ in range(5):
            step()
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.frames
    per_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name][0] += ev.device_time_total / 1e3 / args.frames
            per_kernel[ev.name][1] += 1
    device_ms = sum(v[0] for v in per_kernel.values())
    rows = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    out = dict(
        device=torch.cuda.get_device_name(0),
        mode=mode_name,
        frames=args.frames,
        wall_ms_per_frame=wall_ms, device_ms_per_frame=device_ms,
        device_idle_share=max(0.0, 1.0 - device_ms / wall_ms) if wall_ms else None,
        device_launches_per_frame=sum(v[1] for v in per_kernel.values()) / args.frames,
        kernels=[dict(name=k[:120], ms_per_frame=v[0], launches_per_frame=v[1] / args.frames)
                 for k, v in rows],
    )
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)), exist_ok=True)
        prof.export_chrome_trace(args.trace)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
