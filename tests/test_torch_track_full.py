"""One full-width tracked frame of the port against the JAX reference: the
reference bench's camera (1241x376), KITTI_STEREO at full capacity (2048
keyframes, 131072 points, 2048 features, windows 32 / 8192) and its
PlanarWorld (4096 px texture, 12 m, 60 px/m). Frame 0 seeds the map at
Tcw = I and frame 1 is tracked, each package running its own whole path
(front end included; the port's plain versions on the CPU) on the same
rendered images.

Tolerances and why: the front ends agree in counts to 1 % but not in every
keypoint (tests/test_torch_frame.py), and the pose LM is not bit-exact, so
the fallback decision must agree, the motion-model and local-map inlier
counts within 2 %, and the pose within 1e-3 m.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from corbslam_tpu.config import KITTI_STEREO as JCFG
from corbslam_tpu.frontend import frame as jframe
from corbslam_tpu.frontend import track_ops as jtrack
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu_torch import entry
from corbslam_tpu_torch.frontend import frame, track_ops
from corbslam_tpu_torch.mapstate import mapstate as ms

torch.set_num_threads(2)


def _gt(i):
    tilt = jse3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    xi = jnp.asarray([-(i * 0.3), 0.0, -(i * 0.05), 0.0, i * 0.002, 0.0], jnp.float32)
    return jse3.compose(tilt, jse3.exp(xi))


def test_full_width_tracked_frame_agrees_with_the_reference():
    cam_j = jcamera.Intrinsics.create(**entry.CAM._asdict())
    cam, cfg = entry.CAM, entry.KITTI_STEREO
    world = jsynthetic.PlanarWorld(cam_j, texture_size=4096, plane_dist=12.0, texture_scale=60.0,
                                   seed=0)
    render = jax.jit(world.render_stereo)
    imgs = [tuple(np.asarray(a) for a in render(_gt(i))) for i in (0, 1)]
    K1 = cfg.capacity.local_window_kfs

    f0 = jframe.build_frame_stereo(*imgs[0], cam_j, JCFG.orb)._replace(Tcw=jnp.eye(4))
    jm, jrow, jidx = jtrack.insert_keyframe_with_points(cam_j, jms.empty(JCFG.capacity), f0, 0,
                                                        0.0, JCFG)
    n_mp_j = int(jm.n_mp)  # the step donates the map
    oj = jtrack.track_frame_stereo(jm, f0._replace(mp_idx=jidx), jnp.eye(4), *imgs[1],
                                   jnp.int32(jrow), jnp.zeros(K1, jnp.int32),
                                   jnp.zeros(K1, bool), cam_j, JCFG)
    sj = np.asarray(oj.summary)

    p0 = frame.build_frame_stereo(*imgs[0], cam, cfg.orb, device="cpu")._replace(Tcw=torch.eye(4))
    pm, prow, pidx = track_ops.insert_keyframe_with_points(cam, ms.empty(cfg.capacity), p0, 0,
                                                           0.0, cfg)
    assert abs(int(pm.n_mp) - n_mp_j) <= 0.01 * n_mp_j
    op = track_ops.track_frame_stereo(pm, p0._replace(mp_idx=pidx), torch.eye(4), *imgs[1], prow,
                                      torch.zeros(K1, dtype=torch.int32),
                                      torch.zeros(K1, dtype=torch.bool), cam, cfg, device="cpu")
    sp = op.summary.numpy()

    assert sp[1] == sj[1] == 0 and sp[6] == sj[6] == 1, (sp[:8], sj[:8])
    for k in (0, 2):  # n_track, n_local
        assert abs(sp[k] - sj[k]) <= 0.02 * sj[k], (k, sp[k], sj[k])
    assert sj[2] > 1000
    Tj, Tp = sj[8:].reshape(4, 4), sp[8:].reshape(4, 4)
    cj = -Tj[:3, :3].T @ Tj[:3, 3]
    cp = -Tp[:3, :3].T @ Tp[:3, 3]
    assert np.linalg.norm(cp - cj) <= 1e-3, np.linalg.norm(cp - cj)
    assert entry.center_error(torch.from_numpy(Tp.copy()), 1) < 0.03
