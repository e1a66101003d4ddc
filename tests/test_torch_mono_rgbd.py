"""The port's RGB-D and monocular paths against corbslam_tpu on the CPU:
`ops.stereo.compute_stereo_from_rgbd` and `finish_keypoints_plain` in its
RGB-D mode on the planar world's depth map (the plain version of K4's
`finish_keypoints` entry, which finishes every frame's keypoints),
`frontend.frame.build_frame_rgbd`,
`io.synthetic.PlanarWorld.depth`, and the whole `StereoTracker` through
`process_rgbd` and `process_mono` at the size of tests/test_pipeline.py
(320x240, 512 features, 4 levels, capacities 64 / 8192, 16 frames of its
planar world; the images and depth maps rendered by the JAX world, the
same arrays to both trackers).

Tolerances and why: the depth read is a rounding and a gather: exact,
u_right within 2e-5 px (bf / d divided once on each side). The port's
depth map within 2e-6 relative of JAX's (f32 rays in another summation
order). RGB-D is deterministic end to end: per-frame states, keyframes and
valid points equal, and the aligned ATE within 1e-3 m of JAX's (measured
1.6e-5 m apart). Mono draws its two-view sample from its own generator
(JAX's key cannot be reproduced), so the run is held by outcome: the frame
that initializes and the keyframe count equal, every later frame OK, and
the similarity-aligned ATE at most twice JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu import config as jconfig
from corbslam_tpu.frontend import frame as jframe
from corbslam_tpu.frontend.tracking import StereoTracker as JTracker
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.io import trajectory as jtrajectory
from corbslam_tpu.ops import stereo as jstereo
from corbslam_tpu_torch import config
from corbslam_tpu_torch.frontend import frame
from corbslam_tpu_torch.frontend.tracking import StereoTracker, TrackState
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.io import synthetic
from corbslam_tpu_torch.ops import stereo

torch.set_num_threads(2)

KW = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5, width=320, height=240)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)
N_FRAMES = 16


def small_cfg(C):
    return C.SlamConfig(
        orb=C.OrbConfig(n_features=512, n_levels=4, cell_size=12),
        tracking=C.TrackingConfig(th_depth=40.0, max_frames_between_kf=10),
        mapping=C.MappingConfig(local_ba_window=8, local_ba_iters=6),
        capacity=C.CapacityConfig(max_keyframes=64, max_map_points=8192, max_features=512,
                                  local_window_kfs=8, local_window_mps=2048),
    )


def gt_pose(i, dx):
    tilt = jse3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    return jse3.compose(tilt, jse3.exp(jnp.asarray([-(i * dx), 0.0, -(i * 0.03), 0.0,
                                                    i * 0.004, 0.0], jnp.float32)))


@pytest.fixture(scope="module")
def world():
    return jsynthetic.PlanarWorld(JCAM, texture_size=2048, plane_dist=10.0, texture_scale=40.0)


def test_compute_stereo_from_rgbd_equals_the_reference(rng):
    h, w, N = 40, 60, 256
    dmap = rng.uniform(0.0, 5.0, (h, w)).astype(np.float32)
    dmap[::7] = 0.03                      # under the 0.05 m minimum
    xy = rng.uniform(-2.0, [w + 2, h + 2], (N, 2)).astype(np.float32)
    xy[:32] = np.floor(xy[:32]) + 0.5     # on a half pixel: rounds to even
    xy_und = xy + rng.normal(0, 0.3, (N, 2)).astype(np.float32)
    valid = rng.uniform(size=N) > 0.1
    ref = jstereo.compute_stereo_from_rgbd(jnp.asarray(dmap), jnp.asarray(xy), jnp.asarray(valid),
                                           386.1448, xy_und=jnp.asarray(xy_und))
    ours = stereo.compute_stereo_from_rgbd(torch.from_numpy(dmap), torch.from_numpy(xy),
                                           torch.from_numpy(valid), 386.1448,
                                           xy_und=torch.from_numpy(xy_und))
    assert np.array_equal(ours.ok.numpy(), np.asarray(ref[2])) and 0 < ours.ok.sum() < N
    assert np.array_equal(ours.depth.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(ours.u_right.numpy(), np.asarray(ref[0]), rtol=0, atol=2e-5)


@pytest.mark.parametrize("dist", [None, (0.02, -0.004, 0.0007, -0.0004, 0.0009)],
                         ids=["rectified", "distorted"])
def test_finish_keypoints_rgbd_equals_the_reference(world, rng, dist):
    """`finish_keypoints_plain` in RGB-D mode on a rendered depth map against
    JAX's undistort_points then compute_stereo_from_rgbd: the depth read and
    ok exact, undistorted keypoints within 1e-4 px, u_right within 2e-5 px
    of the reference's on the same undistorted x."""
    dref = np.asarray(world.depth(gt_pose(5, 0.12)))
    xy = rng.uniform(-1.0, [321.0, 241.0], (512, 2)).astype(np.float32)
    xy[:64] = np.floor(xy[:64]) + 0.5
    valid = rng.uniform(size=512) > 0.1
    jcam = jcamera.Intrinsics.create(**KW, dist=dist)
    got = stereo.finish_keypoints_plain(camera.Intrinsics.create(**KW, dist=dist),
                                        torch.from_numpy(xy), torch.from_numpy(valid),
                                        torch.from_numpy(dref), "rgbd")
    und = jcamera.undistort_points(jcam, jnp.asarray(xy))
    ur, d, ok = (np.asarray(a) for a in jstereo.compute_stereo_from_rgbd(
        jnp.asarray(dref), jnp.asarray(xy), jnp.asarray(valid), JCAM.bf, xy_und=und))
    np.testing.assert_allclose(got.xy_und.numpy(), np.asarray(und), rtol=0, atol=1e-4)
    assert np.array_equal(got.ok.numpy(), ok) and 0.8 * valid.sum() < ok.sum() <= valid.sum()
    assert np.array_equal(got.depth.numpy(), d)
    u = got.xy_und[:, 0].numpy() - np.float32(JCAM.bf) / np.maximum(d, np.float32(0.05))
    np.testing.assert_allclose(got.u_right.numpy(), np.where(ok, u, -1.0), rtol=0, atol=2e-5)
    np.testing.assert_allclose(got.u_right.numpy(), ur, rtol=0, atol=1e-4)


def test_depth_map_and_rgbd_frame_equal_the_reference(world):
    T = gt_pose(3, 0.12)
    img = np.asarray(world.render_stereo(T)[0])
    dref = np.asarray(world.depth(T))
    ours = synthetic.PlanarWorld(CAM, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
    dmap = ours.depth(torch.from_numpy(np.asarray(T))).numpy()
    np.testing.assert_allclose(dmap, dref, rtol=2e-6, atol=0)
    jorb = jconfig.OrbConfig(n_features=512, n_levels=4, cell_size=12)
    fr = jframe.build_frame_rgbd(jnp.asarray(img), jnp.asarray(dref), JCAM, jorb)
    fo = frame.build_frame_rgbd(img, dref, CAM, config.OrbConfig(n_features=512, n_levels=4,
                                                                  cell_size=12), device="cpu")
    assert np.array_equal(fo.fvalid.numpy(), np.asarray(fr.fvalid))
    assert np.array_equal(fo.depth.numpy(), np.asarray(fr.depth)) and (fo.depth > 0).sum() > 300
    np.testing.assert_allclose(fo.uright.numpy(), np.asarray(fr.uright), rtol=0, atol=1e-3)


def _run(sensor, world, dx):
    frames = [(np.asarray(world.render_stereo(gt_pose(i, dx))[0]),
               np.asarray(world.depth(gt_pose(i, dx)))) for i in range(N_FRAMES)]
    jt, pt = JTracker(JCAM, small_cfg(jconfig)), StereoTracker(CAM, small_cfg(config), device="cpu")
    for tr, conv in ((jt, jnp.asarray), (pt, lambda a: a)):
        for i, (img, dep) in enumerate(frames):
            if sensor == "mono":
                tr.process_mono(conv(img), i * 0.1)
            else:
                tr.process_rgbd(conv(img), conv(dep), i * 0.1)
        tr.flush()
    return jt, pt


def _ate(tr, dx, with_scale):
    ok = [i for i, s in enumerate(tr.frame_states) if s.name == "OK"]
    est = np.asarray([np.linalg.inv(np.asarray(tr.trajectory[i][1], np.float64)) for i in ok])
    gtw = np.asarray([np.linalg.inv(np.asarray(gt_pose(i, dx), np.float64)) for i in ok])
    return jtrajectory.ate_rmse(est, gtw, align=True, with_scale=with_scale)


def test_rgbd_tracker_equals_the_reference(world):
    jt, pt = _run("rgbd", world, 0.12)
    assert [s.name for s in pt.frame_states] == [s.name for s in jt.frame_states]
    assert all(s == TrackState.OK for s in pt.frame_states)
    assert pt.stats.n_keyframes == jt.stats.n_keyframes >= 2
    np.testing.assert_array_equal(pt.map.kf.frame_id[:int(pt.map.n_kf)].numpy(),
                                  np.asarray(jt.map.kf.frame_id)[:int(jt.map.n_kf)])
    assert int(pt.map.mp.valid.sum()) == int(jnp.sum(jt.map.mp.valid))
    a, aj = _ate(pt, 0.12, False), _ate(jt, 0.12, False)
    assert abs(a - aj) <= 1e-3 and a < 0.06, (a, aj)
    assert pt.stats.stages["triangulate"] == 0


def test_mono_tracker_matches_the_reference_by_outcome(world):
    jt, pt = _run("mono", world, 0.15)
    js, ps = [s.name for s in jt.frame_states], [s.name for s in pt.frame_states]
    init = js.index("OK")
    assert ps.index("OK") == init and all(s == "OK" for s in ps[init:]), (ps, js)
    assert pt.stats.n_keyframes == jt.stats.n_keyframes >= 3
    assert pt.stats.stages["triangulate"] == pt.stats.n_keyframes - 2  # every keyframe after init
    assert int(pt.map.mp.valid.sum()) > 100
    a, aj = _ate(pt, 0.15, True), _ate(jt, 0.15, True)
    assert a <= 2 * aj and a < 0.15, (a, aj)
    assert bool(torch.isfinite(pt.map.kf.Tcw).all()) and bool(torch.isfinite(pt.map.mp.pos).all())
    assert jax.devices()[0].platform == "cpu"
