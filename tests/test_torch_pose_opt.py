"""Parity of the port's reprojection residuals and motion-only pose LM
(`optim/reproj.py`, `optim/pose_opt.py`: the plain version of kernel K6)
with the JAX reference, on the scenes of tests/test_optim.py.

Tolerances and why: `linearize` is the same f32 arithmetic, with sums taken
in another order, so rtol 1e-5 (atol 1e-4 for Jacobian entries that cancel
to ~0). The pose LM is not bit-exact: the 6x6 solve (LAPACK's LU against
XLA's), the order of the normal-equation sums and the discrete accept rule
`cost_new < cost` all differ, so poses agree within 1e-4 m and 1e-5 rad, and
the inlier sets are equal except for observations whose final chi2 lies
within 1e-3 (relative) of its gate; those are counted and must stay few.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.optim import pose_opt as jpose_opt
from corbslam_tpu.optim import reproj as jreproj
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.optim import pose_opt, reproj

torch.set_num_threads(2)

KW = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448, width=1241, height=376)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)
T = torch.from_numpy


def make_scene(rng, n_points=200, noise=0.3, outlier_frac=0.0, stereo=True):
    """tests/test_optim.py's scene: points in front of a true camera, noisy
    (u, v, u_right) observations, optional outliers; `stereo` may be a mask."""
    X = np.stack([rng.uniform(-15, 15, n_points), rng.uniform(-5, 5, n_points),
                  rng.uniform(8, 40, n_points)], -1).astype(np.float32)
    T_true = jse3.exp(jnp.asarray([0.3, -0.1, 0.2, 0.02, -0.04, 0.01], jnp.float32))
    uvr = np.array(jcamera.project_stereo(JCAM, jse3.transform(T_true, jnp.asarray(X))))
    uvr += rng.normal(scale=noise, size=uvr.shape)
    n_out = int(outlier_frac * n_points)
    if n_out:
        idx = rng.choice(n_points, n_out, replace=False)
        uvr[idx, :2] += rng.uniform(30, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    is_stereo = np.broadcast_to(np.asarray(stereo), (n_points,)).copy()
    inv_sigma2 = (1.0 / 1.2 ** (2.0 * rng.integers(0, 8, n_points))).astype(np.float32)
    return X, T_true, uvr.astype(np.float32), is_stereo, inv_sigma2


def test_linearize_equals_the_reference():
    rng = np.random.default_rng(1)
    X, T_true, uvr, _, inv_s2 = make_scene(rng, 64)
    st = rng.random(64) < 0.5
    Tk = np.array(jse3.retract(T_true, jnp.asarray([0.1, -0.05, 0.2, 0.01, 0.02, -0.01])))
    X[5, 2] = -3.0  # one point behind the camera: depth_ok False, weights 0
    ref = jax.jit(jreproj.linearize, static_argnames=("cam",))(
        JCAM, jnp.broadcast_to(jnp.asarray(Tk), (64, 4, 4)), jnp.asarray(X), jnp.asarray(uvr),
        jnp.asarray(inv_s2), jnp.asarray(st))
    got = reproj.linearize(CAM, T(Tk).expand(64, 4, 4), T(X), T(uvr), T(inv_s2), T(st))
    for f in ("r", "J_pose", "J_point", "w"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-4, err_msg=f)
    np.testing.assert_array_equal(got.depth_ok.numpy(), np.asarray(ref.depth_ok))
    assert not bool(got.depth_ok[5])
    c2 = reproj.chi2(got.r, got.w)
    np.testing.assert_allclose(c2.numpy(), np.asarray(jreproj.chi2(ref.r, ref.w)), rtol=1e-5,
                               atol=1e-6)
    d2 = jnp.asarray(np.abs(rng.normal(size=64)).astype(np.float32) * 8)
    np.testing.assert_allclose(
        reproj.huber_weights(c2, T(np.asarray(d2))).numpy(),
        np.asarray(jreproj.huber_weights(jnp.asarray(c2.numpy()), d2)), rtol=1e-6)


CASES = {
    # name: (n_points, noise, outlier_frac, stereo, T0 perturbation, edge)
    "clean": (200, 0.2, 0.0, True, [0.3, -0.2, 0.25, 0.03, 0.02, -0.04], None),
    "outliers": (300, 0.2, 0.3, True, [0.2, 0.1, -0.15, 0.02, -0.01, 0.03], None),
    "mono_only": (200, 0.2, 0.0, False, [0.2, -0.1, 0.1, 0.02, 0.01, -0.02], None),
    "mixed": (400, 0.5, 0.15, "mixed", [0.1, 0.15, -0.2, -0.01, 0.02, 0.01], None),
    # The shapes K6's cluster of 8 CTAs x 256 threads makes special: one
    # observation, exactly one observation a thread, one more than that,
    # the most it takes (MAX_OBS, 4 a thread); every observation invalid;
    # most points behind the camera. One observation cannot fix six degrees
    # of freedom: with a residual, its pose is set by the damping alone, and
    # two f32 implementations drift apart along the null space by more than
    # the 1e-4 m tolerance, so "k1" starts at the pose its observation fits.
    "k1": (1, 0.0, 0.0, True, [0.0] * 6, None),
    "k2048": (2048, 0.3, 0.1, "mixed", [0.2, -0.1, 0.15, 0.02, -0.01, 0.02], None),
    "k2049": (2049, 0.3, 0.1, "mixed", [-0.1, 0.2, 0.1, -0.01, 0.02, 0.01], None),
    "k8192": (8192, 0.3, 0.1, "mixed", [0.15, 0.1, -0.2, 0.01, -0.02, 0.02], None),
    "all_invalid": (300, 0.2, 0.0, True, [0.2, -0.1, 0.1, 0.02, 0.01, -0.02], "invalid"),
    "most_behind": (400, 0.2, 0.0, "mixed", [0.1, -0.1, 0.2, 0.01, -0.01, 0.02], "behind"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimize_pose_within_tolerance_of_the_reference(case):
    n, noise, out, stereo, dxi, edge = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    if stereo == "mixed":
        stereo = rng.random(n) < 0.6
    X, T_true, uvr, st, inv_s2 = make_scene(rng, n, noise, out, stereo)
    T0 = np.array(jse3.retract(T_true, jnp.asarray(dxi, jnp.float32)))
    valid = rng.random(n) < 0.95
    if case == "k1":
        valid[:] = True
    if edge == "invalid":
        valid[:] = False
    if edge == "behind":  # 90 % of the points mirrored behind the true camera
        behind = rng.random(n) < 0.9
        Tt = np.asarray(T_true)
        pc = X @ Tt[:3, :3].T + Tt[:3, 3]
        pc[behind, 2] *= -1.0
        X = ((pc - Tt[:3, 3]) @ Tt[:3, :3]).astype(np.float32)
    ref = jpose_opt.optimize_pose(JCAM, jnp.asarray(T0), jnp.asarray(X), jnp.asarray(uvr),
                                  jnp.asarray(inv_s2), jnp.asarray(st), jnp.asarray(valid))
    got = pose_opt.optimize_pose(CAM, T(T0), T(X), T(uvr), T(inv_s2), T(st), T(valid))
    Tr, Tg = np.asarray(ref.Tcw), got.Tcw.numpy()
    assert np.abs(Tg[:3, 3] - Tr[:3, 3]).max() <= 1e-4
    dR = Tg[:3, :3] @ Tr[:3, :3].T
    assert np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)) <= 1e-5 or \
        np.abs(dR - np.eye(3)).max() <= 1e-5
    # Inlier flips only at the chi2 gate.
    res = jreproj.linearize(JCAM, jnp.broadcast_to(ref.Tcw, (n, 4, 4)), jnp.asarray(X),
                            jnp.asarray(uvr), jnp.asarray(inv_s2), jnp.asarray(st))
    c2 = np.asarray(jreproj.chi2(res.r, res.w))
    d2 = np.where(st, jreproj.CHI2_STEREO, jreproj.CHI2_MONO)
    flips = got.inliers.numpy() != np.asarray(ref.inliers)
    near_gate = np.abs(c2 - d2) <= 1e-3 * d2
    assert not (flips & ~near_gate).any(), np.flatnonzero(flips & ~near_gate)
    assert flips.sum() <= 2, int(flips.sum())
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) == int(flips.sum())
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3)
    if edge == "invalid":  # nothing to fit: the start pose, no inlier, no cost
        assert int(got.n_inliers) == 0 and float(got.cost) == 0.0
        np.testing.assert_allclose(Tg, T0, atol=1e-6)
    elif n > 1:
        # And the optimum is the true pose, as tests/test_optim.py demands.
        assert np.abs(Tg[:3, 3] - np.asarray(T_true)[:3, 3]).max() < 0.03
