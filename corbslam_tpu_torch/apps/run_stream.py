"""Live streaming SLAM node — the ROS example-node capability (port of
`corbslam_tpu/apps/run_stream.py`).

Reference: corbslam_client/Examples/ROS/ORB_SLAM2/src/ros_stereo.cc (live
stereo node: subscribe left+right image topics, ApproximateTime sync, feed
System::TrackStereo), ros_mono.cc, ros_rgbd.cc. The same deployment shape
without ROS: a `publisher` role (a camera-driver stand-in rendering a
planar world on the host) streams stereo frames over TCP (`io/stream.py`)
at a chosen fps; the `node` role subscribes, pairs left/right with
ApproxSync, and drives a CorbslamClient on `--device` (default cuda) as
frames arrive, dropping frames when tracking is slower than the stream.
Every wait has a deadline: the portfile (60 s), the subscriber's accept
(60 s), the stream's idle time (`--idle-timeout`) and, in the demo, the
publisher process (600 s).

    # terminal 1 (node):
    python -m corbslam_tpu_torch.apps.run_stream --role node --portfile PATH
    # terminal 2 (publisher):
    python -m corbslam_tpu_torch.apps.run_stream --role publisher \\
        --portfile PATH --fps 10 --frames 100
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PORTFILE_WAIT_S = 60.0
PUBLISHER_DEADLINE_S = 600.0  # the demo's wait for its publisher process


def _camera():
    from ..geometry import camera

    return camera.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0,
                                    width=320, height=240)


def _cfg():
    from ..config import CapacityConfig, OrbConfig, SlamConfig

    return SlamConfig(
        orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
        capacity=CapacityConfig(max_keyframes=256, max_map_points=32768, max_features=512,
                                local_window_kfs=8, local_window_mps=2048),
    )


def run_publisher(args):
    """Camera-driver stand-in: synthetic stereo frames at --fps, rendered on
    the host (the camera is not the system under test)."""
    from ..geometry import se3
    from ..io import synthetic
    from ..io.stream import ImageStreamServer

    world = synthetic.PlanarWorld(_camera(), texture_size=2048, plane_dist=10.0,
                                  texture_scale=40.0)
    tilt = se3.exp(torch.tensor([0, 0, 0, 0.35, 0, 0], dtype=torch.float32))
    srv = ImageStreamServer()
    try:
        with open(args.portfile + ".tmp", "w") as f:
            f.write(str(srv.port))
        os.rename(args.portfile + ".tmp", args.portfile)
        print(f"[publisher] listening on {srv.port}", flush=True)
        srv.wait_subscriber(timeout=PORTFILE_WAIT_S)
        period = 1.0 / args.fps
        for i in range(args.frames):
            t_next = time.time() + period
            xi = torch.tensor([-(i * 0.12), 0.0, -(i * 0.03), 0.0, i * 0.004, 0.0],
                              dtype=torch.float32)
            left, right = world.render_stereo(se3.compose(tilt, se3.exp(xi)))
            ts = time.time()
            srv.publish("left", ts, left.numpy().astype(np.float32))
            srv.publish("right", ts, right.numpy().astype(np.float32))
            time.sleep(max(0.0, t_next - time.time()))
        srv.end()
        time.sleep(0.5)
    finally:
        srv.close()
    print(f"[publisher] streamed {args.frames} frames at {args.fps} fps", flush=True)


def run_node(args) -> dict:
    """The live SLAM node (ros_stereo.cc equivalent); returns its summary."""
    from .. import kernels
    from .. import system as system_mod
    from ..io.stream import ApproxSync, ImageStreamClient

    dev = kernels.resolve_device(args.device)
    c = system_mod.CorbslamClient(_camera(), _cfg(), sensor="stereo", client_id=1,
                                  enable_loop_closing=False, device=dev)
    t0 = time.time()
    while not os.path.exists(args.portfile):
        if time.time() - t0 > PORTFILE_WAIT_S:
            raise RuntimeError("no publisher portfile")
        time.sleep(0.05)
    with open(args.portfile) as f:
        port = int(f.read())
    sub = ImageStreamClient(port=port, idle_timeout=args.idle_timeout)
    sync = ApproxSync(slop=0.02)
    n_in = n_tracked = 0
    try:
        while True:
            for ts, img in sub.pop_all("left"):
                sync.push_a(ts, img)
                n_in += 1
            for ts, img in sub.pop_all("right"):
                sync.push_b(ts, img)
            pairs = sync.pop_pairs()
            # Live semantics: when the tracker lags the stream, only the
            # newest synced pair is processed and older ones are dropped.
            if pairs:
                ts, left, right = pairs[-1]
                c.track_stereo(torch.from_numpy(left.copy()).to(dev),
                               torch.from_numpy(right.copy()).to(dev), ts)
                n_tracked += 1
            elif sub.ended:
                break
            else:
                time.sleep(0.002)
        c.shutdown()
    finally:
        sub.close()
    states = [x.name for x in c.tracker.frame_states]
    out = {
        "frames_streamed": n_in,
        "frames_tracked": n_tracked,
        "drop_rate": round(1.0 - n_tracked / max(n_in, 1), 3),
        "n_keyframes": int(c.tracker.stats.n_keyframes),
        "states": {s: states.count(s) for s in sorted(set(states))},
    }
    print(f"[node] {json.dumps(out)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", choices=["publisher", "node", "demo"], default="demo")
    ap.add_argument("--portfile",
                    default=os.path.join(tempfile.gettempdir(), "corbslam_stream_port"))
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda", help="the node's device: cuda (default) or cpu")
    ap.add_argument("--idle-timeout", type=float, default=30.0,
                    help="seconds without a frame after which the node ends the stream")
    args = ap.parse_args(argv)
    if args.role == "publisher":
        return run_publisher(args)
    if args.role == "node":
        return run_node(args)
    # demo: the publisher in a child process, the node here.
    if os.path.exists(args.portfile):
        os.unlink(args.portfile)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    pub = subprocess.Popen([sys.executable, "-m", "corbslam_tpu_torch.apps.run_stream",
                            "--role", "publisher", "--portfile", args.portfile,
                            "--fps", str(args.fps), "--frames", str(args.frames)], cwd=root)
    try:
        return run_node(args)
    finally:
        try:
            pub.wait(timeout=PUBLISHER_DEADLINE_S)
        except subprocess.TimeoutExpired:
            pub.kill()
            pub.wait()


if __name__ == "__main__":
    main()
