"""The collaboration runner's yardstick on a CPU: `run_collab --clients N
--frames 30` of the JAX package (or, with --port, of the port on the CPU),
with the server's RANSAC draws from SEED, and its numbers: fusions,
keyframes received, global keyframes and points, each client's frame
states, pushed and foreign keyframes, whether its alignment is known, and
the fused clients' alignment error against the known offset of their
first cameras (client k's world is its first camera, so it maps into
client 1's by gt_pose(0, 0) gt_pose(0, k)^-1), as (rotation rad,
translation m). With --port --jax-draws the port's server takes the PnP
samples the JAX server draws with SEED (tests/test_torch_collab.JaxDraws),
so that the two runs differ only by floating-point order.

    JAX_PLATFORMS=cpu python tests/yardstick_collab.py N SEED [--port [--jax-draws]]

Run from the root of the checkout (~150 s a JAX run, ~60 s a port run, on
8 cores).
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path[:0] = [".", "tests"]
n, seed = int(sys.argv[1]), int(sys.argv[2])
port, jax_draws = "--port" in sys.argv, "--jax-draws" in sys.argv


def gt(i, k):
    from corbslam_tpu.geometry import se3

    tilt = se3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    xi = jnp.asarray([-(i * 0.12) - k * 0.4, 0.0, -(i * 0.03), 0.0, i * 0.004, 0.0], jnp.float32)
    return np.asarray(se3.compose(tilt, se3.exp(xi)), np.float64)


if port:
    import torch

    from corbslam_tpu_torch.apps import run_collab
    from corbslam_tpu_torch.collab import server as server_mod

    torch.set_num_threads(4)
    if jax_draws:
        import test_torch_collab

        server_mod.fusion_ops.detect_overlap = test_torch_collab.JaxDraws(seed)
    cr = run_collab.setup(n, "cpu")
    cr.server.generator.manual_seed(seed)
    run_collab.run(cr, 30)
    server, clients = cr.server, cr.clients
    host = lambda t: t.cpu().numpy()  # noqa: E731
else:
    from corbslam_tpu.apps import run_collab
    from corbslam_tpu.collab import server as server_mod

    init = server_mod.MapFusionServer.__init__
    server_mod.MapFusionServer.__init__ = lambda self, *a, **k: init(self, *a, **dict(k, seed=seed))
    server, clients = run_collab.main(["--clients", str(n), "--frames", "30"])
    host = np.asarray

out = dict(side="port" if port else "jax", seed=seed, jax_draws=jax_draws,
           fusions=server.stats["fusions"], kfs_received=server.stats["kfs_received"],
           global_keyframes=int(host(server.gmap.kf.valid).sum()),
           global_points=int(host(server.gmap.mp.valid).sum()), clients=[])
for k, c in enumerate(clients):
    st = c.cache.stats
    d = dict(cid=k + 1, states="".join(x.name[0] for x in c.tracker.frame_states),
             kfs_pushed=st["kfs_pushed"], foreign_kfs=st["foreign_kfs"],
             transm=c.cache.Ttrans is not None)
    if k + 1 in server.transMs:
        R, t, _ = server.transMs[k + 1]
        S = gt(0, 0) @ np.linalg.inv(gt(0, k))
        dR = np.asarray(R, np.float64) @ S[:3, :3].T
        d["error"] = (float(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))),
                      float(np.linalg.norm(np.asarray(t, np.float64) - S[:3, 3])))
        mp = c.tracker.map.mp
        own = host(mp.valid) & (host(mp.client) == k + 1)
        p = host(mp.pos)[own].astype(np.float64)
        moved = p @ np.asarray(R, np.float64).T + np.asarray(t, np.float64)
        d["point_error"] = float(np.median(np.linalg.norm(
            moved - (p @ S[:3, :3].T + S[:3, 3]), axis=1))) if len(p) else None
        d["identity_error"] = float(np.linalg.norm(S[:3, 3]))
    out["clients"].append(d)
print(json.dumps(out))
