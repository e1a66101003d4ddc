"""The port's Sim3 / SE3 geometry (`geometry/sim3.py`, the loop-closing half
of `geometry/se3.py`) and its Sim3 and PnP RANSAC (`solvers/`, kernel K10's
plain versions) against the JAX package, on inputs made from a seed with
numpy.

Tolerances and why: the geometry within 1e-6 (f32 rounding of the same
formulas, summed in another order; so3_log 2e-6, through acos); near theta
= pi the axis is recovered from a difference of O(1) terms, so there 1e-5. The RANSAC gets JAX's own
index array (`jax.random.choice` with the key the JAX function uses, handed
to the port as `idx`): the chosen hypothesis and the inlier count are exact,
R within 1e-5 and t within 1e-4 m, and an inlier flag may differ only where
the error lies within 1e-3 (relative) of the 9.21 sigma^2 (Sim3) or 5.991
sigma^2 (PnP) gate. The refinement within 1e-4 (three damped Gauss-Newton
steps over ~300 reductions of f32 terms), and so the whole attempt
(RANSAC, refinement and `compute_sim3`'s combine of the two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.geometry import sim3 as jsim3
from corbslam_tpu.solvers import pnp as jpnp
from corbslam_tpu.solvers import sim3_solver as jsolver
from corbslam_tpu_torch.geometry import camera, se3, sim3
from corbslam_tpu_torch.solvers import pnp, sim3_solver

torch.set_num_threads(2)

KW = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b), rtol=0, atol=atol)


def tangents(rng, n=48):
    xi = (rng.normal(size=(n, 7)) * 0.6).astype(np.float32)
    xi[:6, 3:6] *= 1e-7      # the small-angle branch
    xi[6:12, 6] = 0.0        # unit scale (sigma = 0)
    xi[12:18, 6] *= 1e-6     # the small-sigma branch
    return xi


@jax.jit
def _sim3_reference(xi, p):
    S = jsim3.exp(xi)
    B = jsim3.exp(xi[::-1])
    T = jse3.exp(xi[:, :6])
    return dict(S=S, log=jsim3.log(S), B=B, compose=jsim3.compose(S, B), inverse=jsim3.inverse(S),
                transform=jsim3.transform(S, p), retract=jsim3.retract(B, xi), T=T,
                from_se3=jsim3.from_se3(T), to_matrix=jsim3.to_matrix(S))


def test_sim3_exp_log_compose_inverse_transform_retract():
    rng = np.random.default_rng(0)
    xi = tangents(rng)
    p = rng.normal(size=(48, 3)).astype(np.float32) * 3
    ref = _sim3_reference(jnp.asarray(xi), jnp.asarray(p))
    S_t = sim3.exp(t_(xi))
    for a, b in zip(S_t, ref["S"]):
        close(a, b, 1e-6)
    close(sim3.log(S_t), ref["log"], 2e-6)
    B_t = tuple(t_(x) for x in ref["B"])
    for a, b in zip(sim3.compose(S_t, B_t), ref["compose"]):
        close(a, b, 1e-6)
    for a, b in zip(sim3.inverse(S_t), ref["inverse"]):
        close(a, b, 1e-6)
    close(sim3.transform(S_t, t_(p)), ref["transform"], 1e-5)
    for a, b in zip(sim3.retract(B_t, t_(xi)), ref["retract"]):
        close(a, b, 1e-6)
    for a, b in zip(sim3.from_se3(t_(ref["T"])), ref["from_se3"]):
        close(a, b, 0)
    close(sim3.to_matrix(S_t), ref["to_matrix"], 1e-6)
    for a, b in zip(sim3.identity((3,)), jsim3.identity((3,))):
        close(a, b, 0)


@jax.jit
def _se3_reference(xi):
    R = jse3.so3_exp(xi[:, 3:])
    T = jse3.exp(xi)
    return dict(R=R, so3_log=jse3.so3_log(R), jl_inv=jse3.left_jacobian_inv(xi[:, 3:]), T=T,
                log=jse3.log(T))


@pytest.mark.parametrize("kind", ["generic", "tiny", "near_pi"])
def test_so3_log_and_se3_log_equal_the_reference(kind):
    rng = np.random.default_rng(1)
    phi = rng.normal(size=(32, 3)).astype(np.float32)
    if kind == "tiny":
        phi *= 1e-5
    elif kind == "near_pi":
        phi = phi / np.linalg.norm(phi, axis=1, keepdims=True) * (np.pi - 1e-2)
    xi = np.concatenate([rng.normal(size=(32, 3)).astype(np.float32), phi], axis=1)
    ref = _se3_reference(jnp.asarray(xi))
    R = np.asarray(ref["R"])
    close(se3.so3_log(t_(R)), ref["so3_log"], 1e-5 if kind == "near_pi" else 2e-6)
    close(se3.left_jacobian_inv(t_(phi)), ref["jl_inv"], 1e-5)
    close(se3.log(t_(ref["T"])), ref["log"], 1e-5 if kind == "near_pi" else 2e-6)


def test_quaternions_equal_the_reference():
    rng = np.random.default_rng(2)
    R = np.asarray(jax.jit(jse3.so3_exp)(
        jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32) * 2)))
    q = se3.quat_from_R(t_(R))
    qj, Rj = jax.jit(lambda R, q: (jse3.quat_from_R(R), jse3.R_from_quat(q)))(
        jnp.asarray(R), jnp.asarray(q.numpy()))
    close(q, qj, 1e-6)
    close(se3.R_from_quat(q), Rj, 1e-6)


def test_solve3x3_equals_the_reference():
    rng = np.random.default_rng(3)
    G = rng.normal(size=(16, 3, 3)).astype(np.float32)
    b = rng.normal(size=(16, 3)).astype(np.float32)
    close(camera.solve3x3(t_(G), t_(b)), jcamera.solve3x3(jnp.asarray(G), jnp.asarray(b)), 1e-4)


def test_horn_sim3_batched_equals_the_reference():
    rng = np.random.default_rng(4)
    p2 = rng.normal(size=(64, 3, 3)).astype(np.float32) * 4
    S = jsim3.exp(jnp.asarray(tangents(rng, 64)))
    p1 = np.asarray(jax.jit(jsim3.transform)(jax.tree.map(lambda x: x[:, None], S),
                                             jnp.asarray(p2)))
    p1 = p1 + rng.normal(size=p1.shape).astype(np.float32) * 0.01
    for fix in (True, False):
        a = sim3_solver.horn_sim3(t_(p1), t_(p2), fix)
        b = jax.jit(jsolver.horn_sim3, static_argnums=2)(jnp.asarray(p1), jnp.asarray(p2), fix)
        for x, y, tol in zip(a, b, (2e-5, 1e-4, 2e-5)):  # t up to ~10 m: 1e-5 relative
            close(x, y, tol)


def matches(rng, N=400, n_out=120):
    """Camera-frame correspondences under a known Sim3, with outliers."""
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(4, 14, N)], -1)
    X = X.astype(np.float32)
    S = jsim3.exp(jnp.asarray([0.2, -0.1, 0.3, 0.05, -0.08, 0.03, 0.02], jnp.float32))
    p1 = np.asarray(jsim3.transform(S, jnp.asarray(X))) + rng.normal(size=(N, 3)).astype(
        np.float32) * 0.01
    p1[:n_out] = X[:n_out][::-1]
    valid = rng.random(N) < 0.95
    s2 = (1.44 ** rng.integers(0, 4, N)).astype(np.float32)
    return p1.astype(np.float32), X, valid, s2


def near_gate(e, gate, flips):
    return bool((np.abs(e[flips] - gate[flips]) <= 1e-3 * gate[flips]).all())


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_with_the_references_draw(fix_scale):
    rng = np.random.default_rng(5)
    p1, p2, valid, s2 = matches(rng)
    key = jax.random.PRNGKey(7)
    ref = jsolver.solve_sim3_ransac(JCAM, JCAM, jnp.asarray(p1), jnp.asarray(p2),
                                    jnp.asarray(valid), jnp.asarray(s2), jnp.asarray(s2), key,
                                    n_hyp=256, min_inliers=20, fix_scale=fix_scale)
    probs = jnp.asarray(valid, jnp.float32)
    idx = jax.random.choice(key, p1.shape[0], shape=(256, 3), p=probs / jnp.maximum(probs.sum(), 1))
    out = sim3_solver.solve_sim3_ransac(CAM, CAM, t_(p1), t_(p2), t_(valid), t_(s2), t_(s2),
                                        min_inliers=20, fix_scale=fix_scale,
                                        idx=t_(np.asarray(idx, np.int32)))
    assert int(out.n_inliers) == int(ref.n_inliers) and bool(out.ok) == bool(ref.ok)
    close(out.R, ref.R, 1e-5)
    close(out.t, ref.t, 1e-4)
    close(out.s, ref.s, 1e-5)
    flips = out.inliers.numpy() != np.asarray(ref.inliers)
    e1, e2, _ = jsolver._sim3_chi2(JCAM, JCAM, jnp.asarray(p1), jnp.asarray(p2), ref.R, ref.t,
                                   ref.s)
    assert near_gate(np.maximum(np.asarray(e1), np.asarray(e2)), 9.21 * s2, flips)
    # The refinement from the RANSAC model.
    a = sim3_solver.refine_sim3_iterative(CAM, CAM, t_(p1), t_(p2), t_(valid), t_(s2), t_(s2),
                                          out.R, out.t, out.s, fix_scale=fix_scale)
    b = jsolver.refine_sim3_iterative(JCAM, JCAM, jnp.asarray(p1), jnp.asarray(p2),
                                      jnp.asarray(valid), jnp.asarray(s2), jnp.asarray(s2),
                                      ref.R, ref.t, ref.s, fix_scale=fix_scale)
    for x, y in zip(a[:3], b[:3]):
        close(x, y, 1e-4)
    assert int(a[4]) == int(b[4])
    e1, e2, _ = jsolver._sim3_chi2(JCAM, JCAM, jnp.asarray(p1), jnp.asarray(p2), *b[:3])
    assert near_gate(np.maximum(np.asarray(e1), np.asarray(e2)), 9.21 * s2,
                     a[3].numpy() != np.asarray(b[3]))


def test_pnp_ransac_with_the_references_draw():
    rng = np.random.default_rng(6)
    N = 400
    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(4, 14, N)],
                 -1).astype(np.float32)
    T = jse3.exp(jnp.asarray([0.1, -0.2, 0.3, 0.05, 0.1, -0.02], jnp.float32))
    uv = np.asarray(jcamera.project(JCAM, jse3.transform(T, jnp.asarray(X))))
    uv = (uv + rng.normal(size=uv.shape) * 0.5).astype(np.float32)
    uv[: N // 4] = uv[: N // 4][::-1]
    valid = rng.random(N) < 0.95
    s2 = (1.44 ** rng.integers(0, 4, N)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jpnp.solve_pnp_ransac(JCAM, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                                jnp.asarray(s2), key, n_hyp=256, min_inliers=15)
    probs = jnp.asarray(valid, jnp.float32)
    idx = jax.random.choice(key, N, shape=(256, 6), p=probs / jnp.maximum(probs.sum(), 1))
    out = pnp.solve_pnp_ransac(CAM, t_(X), t_(uv), t_(valid), t_(s2), min_inliers=15,
                               idx=t_(np.asarray(idx, np.int32)))
    assert int(out.n_inliers) == int(ref.n_inliers) and bool(out.ok) == bool(ref.ok)
    close(out.Tcw[:3, :3], ref.Tcw[:3, :3], 1e-5)
    close(out.Tcw[:3, 3], ref.Tcw[:3, 3], 1e-4)
    flips = out.inliers.numpy() != np.asarray(ref.inliers)
    p = np.asarray(jse3.transform(ref.Tcw, jnp.asarray(X)))
    e = ((np.asarray(jcamera.project(JCAM, jnp.asarray(p))) - uv) ** 2).sum(-1)
    assert near_gate(e, 5.991 * s2, flips)
    # The DLT poses of eight samples of true matches against the reference's.
    i = rng.integers(N // 4, N, (8, 6))
    uvn = np.stack([(uv[:, 0] - 160.0) / 320.0, (uv[:, 1] - 120.0) / 320.0], -1)
    R, tt = pnp._dlt_pose(t_(X[i]), t_(uvn[i]))
    Rj, tj = jax.jit(jax.vmap(jpnp._dlt_pose))(jnp.asarray(X[i]), jnp.asarray(uvn[i]))
    # Within 1e-3 of each pose's translation norm: six noisy matches leave the
    # 12x12 normal matrix's two smallest eigenvalues close, and 8 inverse
    # iterations carry f32 rounding of either package into the null vector.
    scale = np.maximum(np.linalg.norm(np.asarray(tj), axis=1), 1.0)[:, None]
    assert (np.abs(tt.numpy() - np.asarray(tj)) <= 1e-3 * scale).all()
    assert (np.abs(R.numpy() - np.asarray(Rj)).max(axis=2) <= 1e-3 * scale).all()


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_attempt_equals_the_references_sequence(fix_scale):
    """`solve_and_refine_sim3` (the plain path on the CPU) against JAX's
    solve_sim3_ransac -> refine_sim3_iterative -> compute_sim3's combine,
    on the reference's draw."""
    rng = np.random.default_rng(7)
    p1, p2, valid, s2 = matches(rng)
    key = jax.random.PRNGKey(11)
    J = [jnp.asarray(x) for x in (p1, p2, valid, s2, s2)]
    ref = jsolver.solve_sim3_ransac(JCAM, JCAM, *J, key, n_hyp=256, min_inliers=20,
                                    fix_scale=fix_scale)
    Rj, tj, sj, inl_j, nj = jsolver.refine_sim3_iterative(JCAM, JCAM, *J, ref.R, ref.t, ref.s,
                                                          fix_scale=fix_scale, n_rounds=3)
    use = (ref.n_inliers >= 3) & (nj >= 3)
    comb = (jnp.where(use, Rj, ref.R), jnp.where(use, tj, ref.t), jnp.where(use, sj, ref.s),
            jnp.where(use, jnp.maximum(nj, ref.n_inliers), ref.n_inliers))
    probs = jnp.asarray(valid, jnp.float32)
    idx = jax.random.choice(key, p1.shape[0], shape=(256, 3), p=probs / jnp.maximum(probs.sum(), 1))
    out = sim3_solver.solve_and_refine_sim3(CAM, CAM, t_(p1), t_(p2), t_(valid), t_(s2), t_(s2),
                                            min_inliers=20, fix_scale=fix_scale,
                                            idx=t_(np.asarray(idx, np.int32)))
    assert int(out.ransac.n_inliers) == int(ref.n_inliers) and bool(out.ransac.ok) == bool(ref.ok)
    close(out.ransac.R, ref.R, 1e-5)
    close(out.ransac.t, ref.t, 1e-4)
    close(out.ransac.s, ref.s, 1e-5)
    e1, e2, _ = jsolver._sim3_chi2(JCAM, JCAM, J[0], J[1], ref.R, ref.t, ref.s)
    assert near_gate(np.maximum(np.asarray(e1), np.asarray(e2)), 9.21 * s2,
                     out.ransac.inliers.numpy() != np.asarray(ref.inliers))
    for x, y in zip(out.refined[:3], (Rj, tj, sj)):
        close(x, y, 1e-4)
    assert int(out.refined[4]) == int(nj)
    e1, e2, _ = jsolver._sim3_chi2(JCAM, JCAM, J[0], J[1], Rj, tj, sj)
    assert near_gate(np.maximum(np.asarray(e1), np.asarray(e2)), 9.21 * s2,
                     out.refined[3].numpy() != np.asarray(inl_j))
    for x, y in zip((out.R, out.t, out.s), comb[:3]):
        close(x, y, 1e-4)
    assert int(out.n_inliers) == int(comb[3])
