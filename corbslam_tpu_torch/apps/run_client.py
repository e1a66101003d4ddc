"""Dataset-replay client runner (port of `corbslam_tpu/apps/run_client.py`).

Replaces the reference's per-dataset example binaries (stereo_kitti.cc,
stereo_euroc.cc, rgbd_tum.cc, mono_*.cc: load a sequence, construct the
System, feed the frames, print timing, save the trajectory). One runner
covers every dataset and sensor; the client tracks on `--device` (default
cuda, which it requires):

    python -m corbslam_tpu_torch.apps.run_client --dataset kitti --seq 3 \\
        --root /data/kitti --sensor stereo --client-id 1 \\
        --out traj.txt --metrics metrics.jsonl

`--dataset synthetic` replays the flagship's planar world (rendered on the
device); kitti / tum / euroc read a sequence already on disk under
`--root` (nothing is downloaded). The vocabulary comes from `--vocab`, else
the shipped `assets/vocab32k.npz`, else it is trained (1024 words, kernel
K14) on the first frame's descriptors. `main` returns the client.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=["kitti", "tum", "euroc", "synthetic"],
                    default="synthetic")
    ap.add_argument("--root", default=None, help="dataset root directory")
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--sensor", choices=["stereo", "rgbd", "mono"], default="stereo")
    ap.add_argument("--client-id", type=int, default=1)
    ap.add_argument("--n-frames", type=int, default=0, help="0 = all")
    ap.add_argument("--vocab", default=None, help="vocabulary npz")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--out-format", choices=["kitti", "tum"], default="kitti")
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--no-loop-closing", action="store_true")
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--viewer-port", type=int, default=None,
                    help="serve a live frame+map viewer on this port (0 = ephemeral)")
    ap.add_argument("--viewer-host", default="127.0.0.1",
                    help="viewer bind address (loopback by default)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .. import kernels
    from .. import system as system_mod
    from ..io import datasets
    from ..place import vocab as vocab_mod

    dev = kernels.resolve_device(args.device)

    # ---- sequence + camera ------------------------------------------------
    if args.dataset in ("kitti", "tum", "euroc"):
        if args.dataset == "kitti":
            frames = datasets.load_kitti_stereo(args.root, args.seq)
            cam = datasets.kitti_camera(args.seq)
        elif args.dataset == "tum":
            frames = datasets.load_tum_rgbd(args.root)
            cam = datasets.tum_camera(1)
        else:
            frames = datasets.load_euroc_stereo(args.root)
            cam = datasets.euroc_camera()
        cfg = datasets.config_for(args.dataset)

        def get(fr):
            a, b = fr.load()
            return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev), fr.timestamp
    else:  # the flagship's planar world, rendered on the device
        from .. import entry
        from ..io import synthetic

        cam = datasets.kitti_camera(0)
        cfg = datasets.config_for("kitti")
        world = synthetic.PlanarWorld(cam, texture_size=4096, plane_dist=12.0,
                                      texture_scale=60.0, device=dev)
        frames = list(range(args.n_frames or 100))

        def get(i):
            left, right = world.render_stereo(entry.gt_pose(i))
            return left, right, i * 0.1

    if args.n_frames:
        frames = frames[:args.n_frames]
    print(f"[run_client] {len(frames)} frames, sensor={args.sensor}, device={dev}")

    # ---- vocabulary --------------------------------------------------------
    voc = None
    if not args.no_loop_closing:
        if args.vocab:
            voc = vocab_mod.load_any(args.vocab, dev)
            print(f"[run_client] loaded vocabulary ({voc.n_words} words)")
        else:
            voc = vocab_mod.load_default(dev)
            if voc is not None:
                print(f"[run_client] loaded shipped vocabulary ({voc.n_words} words, "
                      "assets/vocab32k.npz)")
        if voc is None:
            from ..frontend import frame as frame_mod

            f = frame_mod.build_frame_mono(get(frames[0])[0], cam, cfg.orb, device=dev)
            voc = vocab_mod.train(f.desc, n_words=1024, n_iters=6)
            print("[run_client] trained bootstrap vocabulary (1024 words)")

    client = system_mod.CorbslamClient(
        cam, cfg, sensor=args.sensor, client_id=args.client_id, voc=voc,
        enable_loop_closing=not args.no_loop_closing, metrics_path=args.metrics, device=dev)

    viewer = None
    if args.viewer_port is not None:
        from .live_viewer import LiveViewer

        viewer = LiveViewer(port=args.viewer_port, host=args.viewer_host)
        print(f"[run_client] live viewer at {viewer.url}")

    # ---- replay ------------------------------------------------------------
    times = []
    for i, fr in enumerate(frames):
        a, b, ts = get(fr)
        t0 = time.perf_counter()
        if args.sensor == "stereo":
            client.track_stereo(a, b, ts)
        elif args.sensor == "rgbd":
            client.track_rgbd(a, b, ts)
        else:
            client.track_monocular(a, ts)
        times.append(time.perf_counter() - t0)
        if viewer is not None and i % 3 == 0:
            viewer.publish_frame(a.cpu().numpy(), client.tracker)
            viewer.publish_stats({"frame": i, "state": client.state.name,
                                  "fps": round(1.0 / max(times[-1], 1e-9), 2),
                                  "n_keyframes": int(client.tracker.stats.n_keyframes)})
            if i % 15 == 0:
                viewer.publish_map(client.tracker.map)
        if i % 50 == 0:
            print(f"[run_client] frame {i} state={client.state.name} "
                  f"({1.0 / max(times[-1], 1e-9):.1f} fps)")

    client.shutdown()
    if viewer is not None:
        viewer.publish_map(client.tracker.map)
    t = np.asarray(times[5:]) if len(times) > 10 else np.asarray(times)
    print(f"[run_client] median track time {np.median(t) * 1e3:.1f} ms "
          f"({1.0 / np.median(t):.2f} fps), mean {t.mean() * 1e3:.1f} ms")
    if args.out_format == "kitti":
        client.save_trajectory_kitti(args.out)
    else:
        client.save_trajectory_tum(args.out)
    print(f"[run_client] trajectory -> {args.out}")
    if args.save_map:
        client.save_map(args.save_map)
        print(f"[run_client] map checkpoint -> {args.save_map}")
    return client


if __name__ == "__main__":
    main()
