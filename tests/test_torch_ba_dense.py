"""Parity of the port's dense-plane bundle adjustment (`optim/smallmat.py`,
`optim/ba_dense.py`: the plain versions of kernel K8) with the JAX reference,
on problems built with numpy from a seed and handed to both packages.

Tolerances and why:
- smallmat: 1e-5 relative, f32 recurrences in the same order (XLA may fuse
  them into FMAs).
- build_point_major: exact; it is integer work (a stable sort).
- LM: the two packages sum the same f32 products in different orders, so a
  step agrees to the rounding of its normal equations, amplified by the
  conditioning of the reduced camera system: after one LM iteration poses
  within 1e-4 m / 1e-4 rad and points within 1e-3 m; after a full schedule
  the cost within 1e-3 relative, inlier flips only where the chi2 lies
  within 1e-3 (relative) of its gate, poses within 1e-5 m / 1e-5 rad (the
  runs give ~1e-6) and 99.5 % of the points within 1e-3 m (at full width a
  handful of points whose active observations barely fix their depth move
  by centimetres on rounding alone, 0.1 % of them in this problem).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.optim import ba_dense as jba
from corbslam_tpu.optim import smallmat as jsm
from corbslam_tpu_torch import interop
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.optim import ba_dense, smallmat

torch.set_num_threads(2)

KW = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448, width=1241, height=376)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)


def _spd(rng, B, n):
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    return (A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("n", [3, 6])
def test_smallmat_equals_the_reference(n):
    rng = np.random.default_rng(n)
    A, b = _spd(rng, 64, n), rng.normal(size=(64, n)).astype(np.float32)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    L = smallmat.chol_unrolled(At, n)
    np.testing.assert_allclose(L.numpy(), np.asarray(jsm.chol_unrolled(A, n)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(smallmat.chol_solve_factored(L, bt, n).numpy(),
                               np.asarray(jsm.chol_solve_factored(jsm.chol_unrolled(A, n), b, n)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(smallmat.chol_solve_unrolled(At, bt, n).numpy(),
                               np.asarray(jsm.chol_solve_unrolled(A, b, n)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(smallmat.inv_spd_unrolled(At, n).numpy(),
                               np.asarray(jsm.inv_spd_unrolled(A, n)), rtol=1e-5, atol=1e-6)
    # The eps clamp: a singular block factors without NaN, as in the reference.
    Z = np.zeros((2, n, n), np.float32)
    np.testing.assert_array_equal(smallmat.chol_unrolled(torch.from_numpy(Z), n).numpy(),
                                  np.asarray(jsm.chol_unrolled(Z, n)))


def _pm_case(seed):
    """C=5 x Fb=12 slots over P=9 points with K=4: points 0 and 1 overflow
    (seen 9 and 6 times), row 2 observes point 3 twice, and a quarter of
    the slots are inactive."""
    rng = np.random.default_rng(seed)
    C, Fb, P = 5, 12, 9
    obs = rng.integers(2, P, size=(C, Fb)).astype(np.int32)
    obs[:, 0] = 0
    obs[:4, 1] = 0
    obs[:, 2] = 1
    obs[0, 3] = 1
    obs[2, 4] = obs[2, 5] = 3
    active = rng.random((C, Fb)) < 0.75
    active[:, :3] = True
    active[2, 4:6] = True
    return obs, active, P, 4


@pytest.mark.parametrize("seed", [0, 1])
def test_build_point_major_exact(seed):
    obs, active, P, K = _pm_case(seed)
    ref = jax.jit(jba.build_point_major, static_argnums=(2, 3))(obs, active, P, K)
    got = ba_dense.build_point_major(torch.from_numpy(obs), torch.from_numpy(active), P, K)
    for g, r, name in zip(got, ref, ("pm_src", "pm_ok", "active")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert not got[2].numpy()[0].all() or not got[2].numpy()[1].all()  # overflow thinned
    assert got[1].numpy()[3].sum() >= 2  # the duplicate row counts twice


def make_problem(seed, C, Fb, P, frac_active=0.7, noise=1.0, outliers=0.05):
    """A window-shaped BA problem from numpy: P points 8-14 m in front of C
    cameras near the origin, each camera observing up to Fb of them (u, v
    with `noise` px, u_right for 70 % of slots, `outliers` of the slots 25 px
    off), camera 0 and the last two fixed, a few points fixed; the state
    perturbed from the truth (5 cm, 5 mrad per camera; 5 cm per point)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-6, 6, P), rng.uniform(-2, 2, P), rng.uniform(8, 14, P)],
                 -1).astype(np.float32)
    xi = np.concatenate([rng.uniform(-0.8, 0.8, (C, 3)), rng.uniform(-0.03, 0.03, (C, 3))], -1)
    T = np.array(jse3.exp(xi.astype(np.float32)))
    obs_mp = np.zeros((C, Fb), np.int32)
    active = np.zeros((C, Fb), bool)
    uvr = np.zeros((3, C, Fb), np.float32)
    octave = rng.integers(0, 4, (C, Fb)).astype(np.int32)
    stereo_draw = rng.random((C, Fb)) < 0.7
    for c in range(C):
        pc = X @ T[c, :3, :3].T + T[c, :3, 3]
        u = KW["fx"] * pc[:, 0] / pc[:, 2] + KW["cx"]
        v = KW["fy"] * pc[:, 1] / pc[:, 2] + KW["cy"]
        vis = np.flatnonzero((pc[:, 2] > 1) & (u > 0) & (u < KW["width"]) & (v > 0)
                             & (v < KW["height"]))
        ids = rng.permutation(vis)[:Fb]
        n = len(ids)
        obs_mp[c, :n] = ids
        active[c, :n] = rng.random(n) < frac_active
        obs_mp[c, n:] = rng.integers(0, P, Fb - n)
        sig = 1.2 ** octave[c, :n]
        du = rng.normal(0, noise, n) * sig
        bad = rng.random(n) < outliers
        du[bad] += 25.0
        uvr[0, c, :n] = u[ids] + du
        uvr[1, c, :n] = v[ids] + rng.normal(0, noise, n) * sig
        ur = uvr[0, c, :n] - KW["bf"] / pc[ids, 2] + rng.normal(0, noise, n) * sig
        uvr[2, c, :n] = np.where(stereo_draw[c, :n], ur, -1.0)
    uvr[2][~stereo_draw] = -1.0
    dxi = np.concatenate([rng.normal(0, 0.05, (C, 3)), rng.normal(0, 0.005, (C, 3))], -1)
    T0 = np.array(jse3.compose(jse3.exp(dxi.astype(np.float32)), T))
    pose_fixed = np.zeros(C, bool)
    pose_fixed[[0, C - 2, C - 1]] = True
    T0[pose_fixed] = T[pose_fixed]
    point_fixed = rng.random(P) < 0.03
    X0 = (X + rng.normal(0, 0.05, X.shape) * ~point_fixed[:, None]).astype(np.float32)
    inv_s2 = (1.0 / (1.2 ** (2.0 * octave.astype(np.float32)))).astype(np.float32)
    pm_src, pm_ok, active = (np.array(a) for a in
                             jax.jit(jba.build_point_major, static_argnums=(2, 3))(
                                 obs_mp, active, P, C))
    return dict(Tcw=T0.astype(np.float32), pose_fixed=pose_fixed, X=X0, point_fixed=point_fixed,
                obs_mp=obs_mp, obs_uvr=uvr, obs_inv_sigma2=inv_s2, obs_stereo=uvr[2] > 0,
                obs_active=active, pm_src=pm_src, pm_ok=pm_ok)


def _jprob(d):
    return jba.BADense(**{k: jnp.asarray(v) for k, v in d.items()})


def _rot_err(A, B):
    return float(np.abs(A[..., :3, :3] @ np.swapaxes(B[..., :3, :3], -1, -2)
                        - np.eye(3)).max())


@functools.partial(jax.jit, static_argnames=("use_huber", "cg_iters"))
def _jstep(p, active, lam, x0, use_huber, cg_iters):
    return jba.lm_step_dense(JCAM, p, active, lam, use_huber, cg_iters, x0=x0)


@pytest.mark.parametrize("use_huber", [True, False])
def test_one_lm_step_equals_the_reference(use_huber):
    d = make_problem(3, C=8, Fb=96, P=160)
    x0 = np.random.default_rng(9).normal(0, 1e-3, (8, 6)).astype(np.float32)
    T_j, X_j, c2_j, _, dc_j = _jstep(_jprob(d), jnp.asarray(d["obs_active"]), jnp.float32(1e-4),
                                     jnp.asarray(x0), use_huber, 16)
    pb = interop.problem_from_numpy(d)
    T_p, X_p, c2_p, _, dc_p, n_cg = ba_dense.lm_step_dense(
        CAM, pb, pb.obs_active, torch.tensor(1e-4), use_huber, 16, x0=torch.from_numpy(x0))
    assert 1 <= n_cg <= 16
    np.testing.assert_allclose(c2_p.numpy(), np.asarray(c2_j), rtol=1e-4, atol=1e-3)
    assert np.abs(T_p.numpy()[:, :3, 3] - np.asarray(T_j)[:, :3, 3]).max() <= 1e-4
    assert _rot_err(T_p.numpy(), np.asarray(T_j)) <= 1e-4
    assert np.abs(X_p.numpy() - np.asarray(X_j)).max() <= 1e-3
    # The step moved the free cameras and kept the fixed ones.
    moved = np.abs(T_p.numpy() - d["Tcw"]).max(axis=(1, 2))
    assert (moved[d["pose_fixed"]] == 0).all() and (moved[~d["pose_fixed"]] > 1e-4).all()


def _flips_off_gate(res_p, res_j, pb):
    """Inlier flips whose final chi2 is not within 1e-3 (relative) of the gate."""
    flips = res_p.inlier.numpy() != np.asarray(res_j.inlier)
    c2 = ba_dense._chi2(ba_dense._linearize(CAM, pb._replace(Tcw=res_p.Tcw, X=res_p.X))).numpy()
    d2 = np.where(pb.obs_stereo.numpy(), 7.815, 5.991)
    return int((flips & (np.abs(c2 - d2) > 1e-3 * d2)).sum())


def _schedule(d):
    """The split local BA's two calls (tracking.py:708-728): 3 robust then
    2 plain iterations on the re-classified inliers, cg_iters 16."""
    jopt = jax.jit(jba.optimize, static_argnames=("cam", "n_iters", "cg_iters", "huber_iters"))
    jp = _jprob(d)
    ja = jopt(JCAM, jp, n_iters=3, cg_iters=16, huber_iters=3)
    jb = jopt(JCAM, jp._replace(Tcw=ja.Tcw, X=ja.X, obs_active=jp.obs_active & ja.inlier),
              n_iters=2, cg_iters=16, huber_iters=0)
    pb = interop.problem_from_numpy(d)
    pa = ba_dense.optimize(CAM, pb, n_iters=3, cg_iters=16, huber_iters=3)
    pb2 = pb._replace(Tcw=pa.Tcw, X=pa.X, obs_active=pb.obs_active & pa.inlier)
    pbb = ba_dense.optimize(CAM, pb2, n_iters=2, cg_iters=16, huber_iters=0)
    return (ja, jb), (pa, pbb), (pb, pb2)


def _check_schedule(d):
    (ja, jb), (pa, pbb), (pb, pb2) = _schedule(d)
    for rj, rp, p in ((ja, pa, pb), (jb, pbb, pb2)):
        assert abs(float(rp.cost) - float(rj.cost)) <= 1e-3 * abs(float(rj.cost))
        assert _flips_off_gate(rp, rj, p) == 0
        assert np.abs(rp.Tcw.numpy()[:, :3, 3] - np.asarray(rj.Tcw)[:, :3, 3]).max() <= 1e-5
        assert _rot_err(rp.Tcw.numpy(), np.asarray(rj.Tcw)) <= 1e-5
        dx = np.abs(rp.X.numpy() - np.asarray(rj.X)).max(axis=1)
        assert (dx <= 1e-3).mean() >= 0.995, np.sort(dx)[-10:]
    assert pa.trace.shape == (3, 2) and pbb.trace.shape == (2, 2)
    return pa, pbb


def test_optimize_schedule_equals_the_reference():
    d = make_problem(5, C=8, Fb=96, P=160)
    pa, pb = _check_schedule(d)
    assert int(pa.trace[:, 1].sum()) >= 1  # at least one step accepted
    # The robust phase re-classified some outliers.
    assert int(pa.inlier.sum()) < int(d["obs_active"].sum())


def test_optimize_schedule_full_width():
    """The local-BA shapes of the flagship cell: C = 24 (window 16 +
    frontier 8), Fb = F = 2048, P = 4F = 8192, K = W = 24."""
    d = make_problem(11, C=24, Fb=2048, P=8192, frac_active=0.35)
    assert d["pm_src"].shape == (8192, 24)
    _check_schedule(d)


def test_optimize_schedule_past_256_cameras():
    """More cameras than K8's first form held in one SM's shared memory:
    C = 320, Fb = 32, P = 640, K = C. At 16 slots a camera some of the 320
    poses rest on a handful of inliers, and the reference itself moves them
    by more than the schedule's 1e-5 m when its points move by one f32
    rounding; 32 slots keep the poses determined well enough."""
    d = make_problem(13, C=320, Fb=32, P=640)
    assert d["Tcw"].shape[0] == 320
    _check_schedule(d)


def test_problem_carry_over_round_trips():
    d = make_problem(2, C=4, Fb=32, P=40)
    back = interop.problem_to_numpy(interop.problem_from_numpy(d))
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert interop.problem_from_numpy({k: v for k, v in d.items()
                                       if k not in ("pm_src", "pm_ok")}).pm_src is None


def test_optimize_needs_the_point_major_table():
    d = make_problem(2, C=4, Fb=32, P=40)
    pb = interop.problem_from_numpy(d)._replace(pm_src=None, pm_ok=None)
    with pytest.raises(ValueError, match="point-major"):
        ba_dense.optimize(CAM, pb, n_iters=1)
