"""Multi-client collaborative SLAM runner (port of
`corbslam_tpu/apps/run_collab.py`).

Replaces the reference's multi-terminal launch recipe (README.md:55-75:
roscore + corbslam_server + N dataset clients): N stereo tracking clients
with different world frames explore one synthetic scene and sync through
the in-process transport with the fusion server, which detects their
overlap, merges the maps and broadcasts the fused global map back. Clients,
server and world all run on `--device` (default cuda).

    python -m corbslam_tpu_torch.apps.run_collab --clients 2 --frames 30
"""

from __future__ import annotations

import argparse
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch


class CollabRun(NamedTuple):
    cam: object
    cfg: object
    world: object
    voc: object
    transport: object
    server: object
    clients: List[object]


def tilt() -> torch.Tensor:
    from ..geometry import se3

    return se3.exp(torch.tensor([0, 0, 0, 0.35, 0, 0], dtype=torch.float32))


def gt_pose(i: int, k: int) -> torch.Tensor:
    """Client k's camera at frame i (Tcw in the scene's frame); each
    client's own world frame is its first camera, so the clients' frames
    differ by their staggered start (k * 0.4 m in x)."""
    from ..geometry import se3

    xi = torch.tensor([-(i * 0.12) - k * 0.4, 0.0, -(i * 0.03), 0.0, i * 0.004, 0.0],
                      dtype=torch.float32)
    return se3.compose(tilt(), se3.exp(xi))


def setup(n_clients: int, device="cuda", gba: bool = False) -> CollabRun:
    """The reference runner's camera, config, world, vocabulary, transport,
    server and clients on `device` (the shipped vocabulary, or one trained
    inline on the first frame's descriptors when it is missing)."""
    from .. import kernels
    from .. import system as system_mod
    from ..collab.server import MapFusionServer
    from ..collab.transport import InProcTransport
    from ..config import CapacityConfig, OrbConfig, SlamConfig
    from ..geometry import camera
    from ..io import synthetic
    from ..place import vocab as vocab_mod

    dev = kernels.resolve_device(device)
    cam = camera.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320,
                                   height=240)
    cfg = SlamConfig(
        orb=OrbConfig(n_features=512, n_levels=4, cell_size=12),
        capacity=CapacityConfig(max_keyframes=256, max_map_points=32768, max_features=512,
                                local_window_kfs=8, local_window_mps=2048),
    )
    world = synthetic.PlanarWorld(cam, texture_size=2048, plane_dist=10.0, texture_scale=40.0,
                                  device=dev)
    voc = vocab_mod.load_default(dev)
    if voc is None:
        from ..frontend import frame as frame_mod

        img0, _ = world.render_stereo(tilt())
        f0 = frame_mod.build_frame_mono(img0, cam, cfg.orb, device=dev)
        voc = vocab_mod.train(f0.desc, n_words=512, n_iters=5)
    transport = InProcTransport(serialize=True)
    server = MapFusionServer(cam, cfg, voc, transport, run_gba=gba, synchronous_gba=True,
                             device=dev)
    clients = []
    for k in range(n_clients):
        c = system_mod.CorbslamClient(cam, cfg, sensor="stereo", client_id=k + 1, voc=voc,
                                      transport=transport, enable_loop_closing=False, device=dev)
        c.uplink_every = 10
        c.downlink_every = 5
        clients.append(c)
    return CollabRun(cam, cfg, world, voc, transport, server, clients)


def run(cr: CollabRun, frames: int, frame: Optional[Callable] = None,
        step: Optional[Callable] = None) -> None:
    """Every client tracks `frames` frames; the server fuses and broadcasts
    every 5 frames and once more after the clients shut down. `frame(i, k,
    fn)` and `step(name, fn)`, when given, run each client frame and each
    server step (to time them)."""
    frame = frame or (lambda i, k, fn: fn())
    step = step or (lambda name, fn: fn())
    for i in range(frames):
        for k, c in enumerate(cr.clients):
            left, right = cr.world.render_stereo(gt_pose(i, k))
            frame(i, k, lambda: c.track_stereo(left, right, timestamp=i * 0.1))
        if i % 5 == 4:
            step("fuse_step", cr.server.fuse_step)
            step("broadcast_step", cr.server.broadcast_step)
    for c in cr.clients:
        c.shutdown()
    step("fuse_step", cr.server.fuse_step)
    step("broadcast_step", cr.server.broadcast_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--gba", action="store_true", help="run global BA on fusion")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cr = setup(args.clients, args.device, args.gba)
    run(cr, args.frames)
    server, clients = cr.server, cr.clients
    print(f"[run_collab] fusions: {server.stats['fusions']}, "
          f"kfs received: {server.stats['kfs_received']}, "
          f"global map: {int(server.gmap.n_kf)} KFs / "
          f"{int(np.asarray(server.gmap.mp.valid.cpu()).sum())} MPs")
    for k, c in enumerate(clients):
        st = c.cache.stats
        print(f"[run_collab] client {k + 1}: pushed {st['kfs_pushed']} KFs, "
              f"received {st['foreign_kfs']} foreign KFs, "
              f"transM known: {c.cache.Ttrans is not None}")
    return server, clients


if __name__ == "__main__":
    main()
