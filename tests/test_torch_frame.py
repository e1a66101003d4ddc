"""Parity of the port's frame builders (plain PyTorch path, CPU) with the JAX
reference: small stereo and mono frames, and one full-width stereo frame on
the input of `__graft_entry__.entry()` (1241x376, 2048 features, 8 levels);
and of `stereo.finish_keypoints_plain` (the plain version of K4's
`finish_keypoints`, which finishes every frame's keypoints) in its three
modes with and without distortion.

Tolerances and why: pyramid levels >= 1 differ by float rounding (<= 1e-3),
which can reorder equal-looking FAST ranks and flip a rare keypoint, so
features are paired by (octave, x, y); counts agree within 1 %, paired
keypoints' undistorted xy and u_right within 1e-2 px. `finish_keypoints_plain`
against JAX's `undistort_points` and `compute_stereo_from_rgbd`: elementwise
f32 in the same order, within 1e-4 (1e-6 relative to values of up to ~1e3);
the depth read, `ok` and the -1 / 0 fill exact. Against the port's own
`undistort_points` and `compute_stereo_from_rgbd` it is the same arithmetic
on the same device: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from corbslam_tpu.config import OrbConfig as JOrbConfig
from corbslam_tpu.frontend import frame as jframe
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.ops import stereo as jstereo
from corbslam_tpu_torch import entry as port_entry
from corbslam_tpu_torch import interop
from corbslam_tpu_torch.config import OrbConfig
from corbslam_tpu_torch.frontend import frame
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.ops import stereo

torch.set_num_threads(2)

DIST = (0.01, -0.002, 0.0005, -0.0003, 0.0)  # exercises undistort_points' iteration


def _cams(h, w, dist=None):
    kw = dict(fx=300.0, fy=300.0, cx=w / 2 - 0.3, cy=h / 2 + 0.2, bf=120.0, dist=dist,
              width=w, height=h)
    return jcamera.Intrinsics.create(**kw), camera.Intrinsics.create(**kw)


def _np(fd):
    if isinstance(fd.xy, torch.Tensor):
        return interop.features_to_numpy(fd)
    return {k: np.asarray(v) for k, v in fd._asdict().items()}


def _compare(ref, got, tol=1e-2):
    """Counts within 1 %; paired features agree in xy, desc and u_right."""
    nv_r, nv_g = int(ref["fvalid"].sum()), int(got["fvalid"].sum())
    ok_r, ok_g = int((ref["uright"] >= 0).sum()), int((got["uright"] >= 0).sum())
    assert abs(nv_r - nv_g) <= 0.01 * nv_r, (nv_r, nv_g)
    assert abs(ok_r - ok_g) <= 0.01 * max(ok_r, 1), (ok_r, ok_g)

    def keyed(d):
        return {(int(o), *np.round(xy, 2).tolist()): i for i, (o, xy, v) in
                enumerate(zip(d["octave"], d["xy"], d["fvalid"])) if v}
    kr, kg = keyed(ref), keyed(got)
    shared = kr.keys() & kg.keys()
    assert len(shared) >= 0.99 * nv_r, (len(shared), nv_r)
    ir = np.array([kr[k] for k in shared])
    ig = np.array([kg[k] for k in shared])
    np.testing.assert_allclose(got["xy"][ig], ref["xy"][ir], rtol=0, atol=tol)
    assert (got["desc"][ig] == ref["desc"][ir]).all(-1).mean() >= 0.99
    both = (ref["uright"][ir] >= 0) & (got["uright"][ig] >= 0)
    assert both.sum() >= 0.99 * min(ok_r, ok_g)
    np.testing.assert_allclose(got["uright"][ig][both], ref["uright"][ir][both], rtol=0, atol=tol)
    return nv_r, ok_r


@pytest.mark.parametrize("dist", [None, DIST], ids=["rectified", "distorted"])
def test_build_frame_stereo_small(dist):
    h, w = 160, 320
    img = jsynthetic.random_texture(h, w, seed=4)
    img_r = np.roll(img, -10, axis=1).copy()
    jcam, cam = _cams(h, w, dist)
    ref = _np(jframe.build_frame_stereo(jnp.asarray(img), jnp.asarray(img_r), jcam,
                                        JOrbConfig(n_features=512, n_levels=3)))
    got = _np(frame.build_frame_stereo(img, img_r, cam, OrbConfig(n_features=512, n_levels=3),
                                       device="cpu"))
    nv, ok = _compare(ref, got)
    assert ok > 0.5 * nv
    np.testing.assert_array_equal(got["Tcw"], np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(got["mp_idx"], -np.ones(512, np.int32))


def test_build_frame_mono_small():
    h, w = 120, 200
    img = jsynthetic.random_texture(h, w, seed=8)
    jcam, cam = _cams(h, w, DIST)
    ref = _np(jframe.build_frame_mono(jnp.asarray(img), jcam, JOrbConfig(n_features=256, n_levels=3)))
    got = _np(frame.build_frame_mono(img, cam, OrbConfig(n_features=256, n_levels=3), device="cpu"))
    _compare(ref, got)
    assert (got["uright"] == -1).all() and (got["depth"] == 0).all()


def test_build_frame_stereo_full_width_entry_input():
    fwd, (img_l, img_r) = __graft_entry__.entry()
    ref = _np(fwd(img_l, img_r))
    got = _np(frame.build_frame_stereo(np.asarray(img_l), np.asarray(img_r), port_entry.CAM,
                                       port_entry.CFG, device="cpu"))
    nv, ok = _compare(ref, got)
    assert nv >= 1800 and ok >= 1500
    # The port's own entry input (its numpy random_texture) gives the same counts.
    port_fwd, port_imgs = port_entry.entry(device="cpu")
    own = _np(port_fwd(*port_imgs))
    assert abs(int(own["fvalid"].sum()) - nv) <= 0.01 * nv
    assert abs(int((own["uright"] >= 0).sum()) - ok) <= 0.01 * ok


def test_scale_tables_equal_the_reference():
    cfg = OrbConfig(n_features=2048, n_levels=8)
    for ours, ref in zip(frame.scale_tables(cfg), jframe.scale_tables(JOrbConfig())):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@jax.jit
def _jax_camera(p_cam, uv, depth):
    jcam, _ = _cams(376, 1241, DIST)
    return dict(project=jcamera.project(jcam, p_cam),
                stereo=jcamera.project_stereo(jcam, p_cam),
                back=jcamera.backproject(jcam, uv, depth),
                distort=jcamera.distort(jcam, uv / 1000.0),
                undistort=jcamera.undistort_points(jcam, uv),
                inside=jcamera.in_image(jcam, uv, 4.0))


def test_camera_functions_equal_the_reference():
    """Elementwise f32 in the reference's order of operations: within 1e-4
    (1e-6 relative to values of up to ~1e3)."""
    rng = np.random.default_rng(2)
    p_cam = np.stack([rng.uniform(-5, 5, 300), rng.uniform(-2, 2, 300),
                      rng.uniform(0.5, 40, 300)], -1).astype(np.float32)
    uv = np.stack([rng.uniform(-20, 1260, 300), rng.uniform(-20, 396, 300)], -1).astype(np.float32)
    depth = rng.uniform(0.5, 40, 300).astype(np.float32)
    ref = jax.tree.map(np.asarray, _jax_camera(p_cam, uv, depth))
    _, cam = _cams(376, 1241, DIST)
    got = dict(project=camera.project(cam, torch.from_numpy(p_cam)),
               stereo=camera.project_stereo(cam, torch.from_numpy(p_cam)),
               back=camera.backproject(cam, torch.from_numpy(uv), torch.from_numpy(depth)),
               distort=camera.distort(cam, torch.from_numpy(uv) / 1000.0),
               undistort=camera.undistort_points(cam, torch.from_numpy(uv)),
               inside=camera.in_image(cam, torch.from_numpy(uv), 4.0))
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k], rtol=1e-6, atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(cam.K.numpy(), np.asarray(_cams(376, 1241, DIST)[0].K))


def _finish_inputs(h=240, w=320, N=300, seed=6):
    """Keypoints inside and around an image (32 on a half pixel, some on the
    border), 10 % invalid, and a depth map with rows under the 0.05 m minimum."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-2.0, [w + 2, h + 2], (N, 2)).astype(np.float32)
    xy[:32] = np.floor(xy[:32]) + 0.5
    xy[32:36] = [[-0.5, -0.5], [w - 0.5, h - 0.5], [0.5, h - 1.5], [w - 1.5, 0.5]]
    dmap = rng.uniform(0.0, 5.0, (h, w)).astype(np.float32)
    dmap[::7] = 0.03
    return xy, rng.uniform(size=N) > 0.1, dmap


@pytest.mark.parametrize("dist", [None, DIST], ids=["rectified", "distorted"])
@pytest.mark.parametrize("mode", ["stereo", "mono", "rgbd"])
def test_finish_keypoints_plain_equals_the_reference(mode, dist):
    """undistort_points (geometry/camera.py:111) and, for RGB-D,
    compute_stereo_from_rgbd (ops/stereo.py:104) of JAX; mono's -1 / 0."""
    h, w = 240, 320
    jcam, cam = _cams(h, w, dist)
    xy, valid, dmap = _finish_inputs(h, w)
    got = stereo.finish_keypoints_plain(cam, torch.from_numpy(xy), torch.from_numpy(valid),
                                        torch.from_numpy(dmap), mode)
    und = np.asarray(jcamera.undistort_points(jcam, jnp.asarray(xy)))
    np.testing.assert_allclose(got.xy_und.numpy(), und, rtol=1e-6, atol=1e-4)
    if dist is not None:
        assert np.abs(und - xy).max() > 0.1  # the distortion moves keypoints
    if mode == "stereo":
        assert got.u_right is None and got.depth is None and got.ok is None
    elif mode == "mono":
        assert (got.u_right.numpy() == -1).all() and (got.depth.numpy() == 0).all()
        assert got.ok is None
    else:
        ur, d, ok = (np.asarray(a) for a in jstereo.compute_stereo_from_rgbd(
            jnp.asarray(dmap), jnp.asarray(xy), jnp.asarray(valid), _cams(h, w)[0].bf,
            xy_und=jnp.asarray(und)))
        assert np.array_equal(got.ok.numpy(), ok) and 0 < ok.sum() < len(ok)
        assert np.array_equal(got.depth.numpy(), d)
        assert np.array_equal(got.u_right.numpy() == -1, ur == -1)
        np.testing.assert_allclose(got.u_right.numpy(), ur, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("mode", ["stereo", "mono", "rgbd"])
def test_finish_keypoints_is_undistortion_then_the_depth_read(mode):
    """On CPU keypoints `finish_keypoints` is its plain version, and that is
    the port's `undistort_points` followed by `compute_stereo_from_rgbd`
    (RGB-D) or the -1 / 0 fill (mono), bit for bit: what `build_frame_*`
    computed before one call of it finished their keypoints."""
    _, cam = _cams(240, 320, DIST)
    xy, valid, dmap = (torch.from_numpy(a) for a in _finish_inputs())
    got = stereo.finish_keypoints(cam, xy, valid, dmap, mode)
    plain = stereo.finish_keypoints_plain(cam, xy, valid, dmap, mode)
    und = camera.undistort_points(cam, xy)
    assert torch.equal(got.xy_und, und) and torch.equal(plain.xy_und, und)
    if mode == "rgbd":
        want = stereo.compute_stereo_from_rgbd(dmap, xy, valid, float(cam.bf), xy_und=und)
    elif mode == "mono":
        want = (torch.full((xy.shape[0],), -1.0), torch.zeros(xy.shape[0]), None)
    else:
        want = (None, None, None)
    for a, b, c in zip(got[1:], plain[1:], want):
        assert (a is b is c is None) or (torch.equal(a, c) and torch.equal(b, c))
    with pytest.raises(ValueError, match="mode"):
        stereo.finish_keypoints(cam, xy, mode="depth")
