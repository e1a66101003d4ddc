"""Parity of the port's local-mapping stages (`mapping/local_mapping.py`,
all kernels on their plain versions) with the JAX reference, on a map grown
by the JAX tracker at the small size of tests/test_pipeline.py (320x240, 512
features, 4 levels, capacities 64 / 8192 / 512, windows 8 / 2048) with a
keyframe forced on every frame. Each stage starts from the same map in both
packages (carried across by `interop`).

Tolerances and why: masks, indices, counters, descriptors and gathered
copies are exact; the problem's inverse sigma^2 (1.2 ** (2 octave), an f32
pow) within 1 ulp. Refreshed normals are means of unit vectors summed in
another order: 1e-5. The local BA runs the same f32 LM as
tests/test_torch_ba_dense.py: after one LM iteration poses within 1e-4 m /
1e-4 rad and points within 1e-3 m; after each of the split BA's two calls the
cost within 1e-3 relative, inlier flips only at the chi2 gate, poses within
1e-3 m / rad (see the test for why) and 99 % of the points within 1e-3 m.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu import config as jconfig
from corbslam_tpu.frontend.tracking import StereoTracker as JTracker
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.mapping import local_mapping as jlm
from corbslam_tpu.optim import ba_dense as jba
from corbslam_tpu_torch import config, interop
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.mapping import local_mapping as lm
from corbslam_tpu_torch.mapstate import mapstate as ms
from corbslam_tpu_torch.optim import ba_dense

torch.set_num_threads(2)

KW = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5, width=320, height=240)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)


def small_cfg(C, **tracking):
    kw = dict(th_depth=40.0, max_frames_between_kf=10)
    kw.update(tracking)
    return C.SlamConfig(
        orb=C.OrbConfig(n_features=512, n_levels=4, cell_size=12),
        tracking=C.TrackingConfig(**kw),
        mapping=C.MappingConfig(local_ba_window=8, local_ba_iters=6),
        capacity=C.CapacityConfig(max_keyframes=64, max_map_points=8192, max_features=512,
                                  local_window_kfs=8, local_window_mps=2048),
    )


JCFG, CFG = small_cfg(jconfig), small_cfg(config)


def gt_pose(i):
    tilt = jse3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    return jse3.compose(tilt, jse3.exp(jnp.asarray([-(i * 0.12), 0.0, -(i * 0.03), 0.0,
                                                    i * 0.004, 0.0], jnp.float32)))


@pytest.fixture(scope="module")
def grown():
    """The JAX tracker's map after 9 frames with a keyframe on each (its
    mapping stages ran), flushed; q = the newest keyframe."""
    cfg = JCFG.replace(tracking=dataclasses.replace(JCFG.tracking, min_frames_between_kf=0,
                                                    max_frames_between_kf=1))
    world = jsynthetic.PlanarWorld(JCAM, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
    render = jax.jit(world.render_stereo)
    tr = JTracker(JCAM, cfg)
    for i in range(9):
        tr.process_stereo(*render(gt_pose(i)), timestamp=i * 0.1)
    tr.flush()
    m = jax.tree.map(np.asarray, tr.map)
    return m, int(tr.map.n_kf) - 1


def _jmap(m):
    return jax.tree.map(jnp.asarray, m)


def _same_map(got, ref, float_tol=None):
    d = interop.map_to_numpy(got)
    for part in ("kf", "mp"):
        for name, a in d[part].items():
            r = np.asarray(getattr(getattr(ref, part), name))
            if float_tol is not None and a.dtype == np.float32:
                np.testing.assert_allclose(a, r, rtol=0, atol=float_tol, err_msg=f"{part}.{name}")
            else:
                np.testing.assert_array_equal(a, r, err_msg=f"{part}.{name}")
    assert d["n_kf"] == int(ref.n_kf) and d["n_mp"] == int(ref.n_mp)


def test_grown_map_has_local_ba_material(grown):
    m, q = grown
    assert q >= 7 and int(m.n_mp) > 1000 and int(np.asarray(m.kf.valid).sum()) >= 3


def test_fuse_into_kf_equals_the_reference(grown):
    m, q = grown
    ref = jax.jit(jlm.fuse_into_kf, static_argnames=("cam", "cfg"))(JCAM, _jmap(m), q, JCFG)
    got = lm.fuse_into_kf(CAM, interop.map_from_numpy(m), q, CFG)
    _same_map(got, ref)


@pytest.mark.parametrize("current", [0, 1], ids=["q", "q_minus_1"])
def test_cull_map_points_equals_the_reference(grown, current):
    m, q = grown
    ref = jax.jit(jlm.cull_map_points, static_argnames=("cfg", "mono"))(_jmap(m), q - current,
                                                                       JCFG)
    pm = interop.map_from_numpy(m)
    got = lm.cull_map_points(pm, q - current, CFG)
    _same_map(got, ref)
    assert int(got.mp.valid.sum()) <= int(np.asarray(m.mp.valid).sum())


def test_sweep_detached_equals_the_reference(grown):
    m, _ = grown
    valid = np.array(m.mp.valid)
    valid[::7] = False  # stale observations to sweep
    m2 = m._replace(mp=m.mp._replace(valid=valid))
    ref = jax.jit(jlm.sweep_detached)(_jmap(m2))
    got = lm.sweep_detached(interop.map_from_numpy(m2))
    _same_map(got, ref)


def test_refresh_point_geometry_equals_the_reference(grown):
    m, q = grown
    ref = jax.jit(jlm.refresh_point_geometry, static_argnames=("cfg",))(_jmap(m), q, JCFG)
    got = lm.refresh_point_geometry(interop.map_from_numpy(m), q, CFG)
    _same_map(got, ref, float_tol=1e-5)
    np.testing.assert_array_equal(got.mp.desc.numpy(), np.asarray(ref.mp.desc))


def test_cull_keyframes_equals_the_reference(grown):
    m, q = grown
    jkill = jax.jit(jlm.find_redundant_keyframes, static_argnames=("cfg", "window"))(
        _jmap(m), q, JCFG)
    got, kill = lm.cull_keyframes(interop.map_from_numpy(m), q, CFG)
    np.testing.assert_array_equal(kill.numpy(), np.asarray(jkill))
    from corbslam_tpu.mapstate import mapstate as jms
    _same_map(got, jms.cull_keyframes(_jmap(m), jkill))


@pytest.fixture(scope="module")
def built(grown):
    m, q = grown
    jsel, jprob = jax.jit(jlm.local_ba_build, static_argnames=("cfg",))(_jmap(m), q, JCFG)
    sel, prob = lm.local_ba_build(interop.map_from_numpy(m), q, CFG)
    return (jsel, jprob), (sel, prob)


def test_local_ba_build_equals_the_reference(grown, built):
    """The window pins q three times (its anchor, newest-row and extra
    copies, all ok) and the problem's every field is exact."""
    _, q = grown
    (jsel, jprob), (sel, prob) = built
    for f in lm.LocalBAInputs._fields:
        np.testing.assert_array_equal(getattr(sel, f).numpy(), np.asarray(getattr(jsel, f)),
                                      err_msg=f)
    rows, ok = sel.kf_rows.numpy(), sel.kf_ok.numpy()
    assert ((rows == q) & ok).sum() == 3 and rows[0] == q
    for f in ba_dense.BADense._fields:
        a, r = getattr(prob, f).numpy(), np.asarray(getattr(jprob, f))
        if f == "obs_inv_sigma2":  # 1.2 ** (2 octave): XLA's f32 pow is 1 ulp off torch's
            np.testing.assert_allclose(a, r, rtol=2.4e-7, atol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, r, err_msg=f)
    assert int(prob.obs_active.sum()) > 1000


def _pose_diff(rp, rj):
    Tp, Tj = rp.Tcw.numpy(), np.asarray(rj.Tcw)
    return (np.abs(Tp[:, :3, 3] - Tj[:, :3, 3]).max(),
            np.abs(Tp[:, :3, :3] @ np.swapaxes(Tj[:, :3, :3], 1, 2) - np.eye(3)).max())


def test_local_ba_two_stage_optimize_equals_the_reference(built):
    """One LM iteration, then the split local BA's two calls (4 robust + 2
    plain iterations at this config)."""
    (_, jprob), (_, prob) = built
    jopt = jax.jit(jba.optimize, static_argnames=("cam", "n_iters", "cg_iters", "huber_iters"))
    j1 = jopt(JCAM, jprob, n_iters=1, cg_iters=16, huber_iters=3)
    p1 = ba_dense.optimize(CAM, prob, n_iters=1, cg_iters=16, huber_iters=3)
    dt, dr = _pose_diff(p1, j1)
    assert dt <= 1e-4 and dr <= 1e-4
    assert np.abs(p1.X.numpy() - np.asarray(j1.X)).max() <= 1e-3
    ja = jopt(JCAM, jprob, n_iters=4, cg_iters=16, huber_iters=3)
    pa = ba_dense.optimize(CAM, prob, n_iters=4, cg_iters=16, huber_iters=3)
    jb = jopt(JCAM, jprob._replace(Tcw=ja.Tcw, X=ja.X, obs_active=jprob.obs_active & ja.inlier),
              n_iters=2, cg_iters=16, huber_iters=0)
    prob2 = prob._replace(Tcw=pa.Tcw, X=pa.X, obs_active=prob.obs_active & pa.inlier)
    pb = ba_dense.optimize(CAM, prob2, n_iters=2, cg_iters=16, huber_iters=0)
    # The window holds q three times, so the reduced camera system is nearly
    # singular and CG stops at its 16-iteration cap after the first LM
    # iteration: later steps carry the two packages' rounding further apart
    # (the runs give ~1.4e-4 m), hence 1e-3 m for the poses of the schedule.
    assert int(pa.trace[1:, 0].max()) == 16
    for rj, rp, p in ((ja, pa, prob), (jb, pb, prob2)):
        assert abs(float(rp.cost) - float(rj.cost)) <= 1e-3 * abs(float(rj.cost))
        dt, dr = _pose_diff(rp, rj)
        assert dt <= 1e-3 and dr <= 1e-3
        dx = np.abs(rp.X.numpy() - np.asarray(rj.X)).max(axis=1)
        assert (dx <= 1e-3).mean() >= 0.99, np.sort(dx)[-10:]
        flips = rp.inlier.numpy() != np.asarray(rj.inlier)
        c2 = ba_dense._chi2(ba_dense._linearize(CAM, p._replace(Tcw=rp.Tcw, X=rp.X))).numpy()
        d2 = np.where(p.obs_stereo.numpy(), 7.815, 5.991)
        assert not (flips & (np.abs(c2 - d2) > 1e-3 * d2)).any()


def test_local_ba_writeback_last_slot_wins(grown, built):
    """Duplicate window rows (q three times, repeated frontier rows): the
    map ends as JAX's in-order scatter leaves it, the last slot's value."""
    m, _ = grown
    (jsel, jprob), (sel, prob) = built
    rng = np.random.default_rng(4)
    W, P = sel.kf_rows.shape[0], sel.mp_rows.shape[0]
    T_opt = np.array(jprob.Tcw)
    T_opt[:, :3, 3] += rng.normal(0, 0.01, (W, 3)).astype(np.float32)
    X_opt = (np.asarray(jprob.X) + rng.normal(0, 0.01, (P, 3))).astype(np.float32)
    inlier = np.asarray(jprob.obs_active) & (rng.random(np.shape(jprob.obs_active)) < 0.9)
    args = [T_opt, X_opt, inlier, np.asarray(jprob.obs_active)]
    ref = jax.jit(jlm.local_ba_writeback)(_jmap(m), jsel.kf_rows, jsel.kf_free, jsel.kf_ok,
                                          jsel.mp_rows, jsel.mp_ok, *map(jnp.asarray, args))
    got = lm.local_ba_writeback(interop.map_from_numpy(m), sel.kf_rows, sel.kf_free, sel.kf_ok,
                                sel.mp_rows, sel.mp_ok, *map(torch.from_numpy, args))
    _same_map(got, ref)
    rows = sel.kf_rows.numpy()
    assert len(set(rows.tolist())) < len(rows)  # the window holds duplicates
    last = lm.last_wins(sel.kf_rows, 64).numpy()
    assert (last >= np.arange(len(rows))).all() and (rows[last] == rows).all()


def test_maps_are_updated_in_place_and_clone_detaches(grown):
    m, q = grown
    pm = interop.map_from_numpy(m)
    cp = ms.clone(pm)
    out = lm.cull_map_points(pm, q, CFG)
    assert out.mp.valid.data_ptr() == pm.mp.valid.data_ptr()
    assert cp.mp.valid.data_ptr() != pm.mp.valid.data_ptr()
    np.testing.assert_array_equal(cp.mp.valid.numpy(), np.asarray(m.mp.valid))
