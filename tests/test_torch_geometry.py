"""Parity of the port's SE(3) operations and frustum test with the JAX
reference, on numpy inputs from a seed.

Tolerances and why: both packages compute in f32 but sum products in their
own order (XLA's dot against the port's explicit sums), so SE(3) results
agree to 1e-6 absolute plus 1e-6 relative (a few f32 ulps of the O(1)
rotation entries), and transformed points to 4e-6 absolute (a few ulps of
their largest intermediate term, |R p| + |t| ~ 15). The frustum masks are
compared exactly on points kept 1e-3 (relative) away from every gate, where
such rounding cannot flip a decision; uv within 1e-3 px where |uv| < 5000
(f32 ulps of 5e-4 there), dist and view_cos within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu_torch.geometry import camera, se3

torch.set_num_threads(2)

KW = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448, width=1241, height=376)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)


def _xi(rng, n, small=False):
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[:, 3:] *= 1e-5 if small else 0.7
    return xi


@jax.jit
def _jax_se3(xi, p):
    T = jse3.exp(xi)
    U = jse3.exp(xi[::-1])
    return dict(
        hat=jse3.hat(xi[:, 3:]), vee=jse3.vee(jse3.hat(xi[:, 3:])), so3=jse3.so3_exp(xi[:, 3:]),
        V=jse3.left_jacobian(xi[:, 3:]), exp=T, inv=jse3.inverse(T), comp=jse3.compose(T, U),
        retract=jse3.retract(U, xi), transform=jse3.transform(T, p),
        from_Rt=jse3.from_Rt(jse3.rotation(T), jse3.translation(U)),
    )


def _port_se3(xi, p):
    xi, p = torch.from_numpy(xi), torch.from_numpy(p)
    T = se3.exp(xi)
    U = se3.exp(xi.flip(0))
    return dict(
        hat=se3.hat(xi[:, 3:]), vee=se3.vee(se3.hat(xi[:, 3:])), so3=se3.so3_exp(xi[:, 3:]),
        V=se3.left_jacobian(xi[:, 3:]), exp=T, inv=se3.inverse(T), comp=se3.compose(T, U),
        retract=se3.retract(U, xi), transform=se3.transform(T, p),
        from_Rt=se3.from_Rt(se3.rotation(T), se3.translation(U)),
    )


@pytest.mark.parametrize("small", [False, True], ids=["generic", "small_angle"])
def test_se3_equals_the_reference(small):
    """Every ported function on 64 random poses; `small` puts every rotation
    below the theta^2 < 1e-8 branch of _sinc_coeffs."""
    rng = np.random.default_rng(3 + small)
    xi = _xi(rng, 64, small)
    p = rng.normal(scale=5.0, size=(64, 3)).astype(np.float32)
    if small:
        assert ((xi[:, 3:] ** 2).sum(-1) < 1e-8).all()
    ref = _jax_se3(jnp.asarray(xi), jnp.asarray(p))
    got = _port_se3(xi, p)
    for name, r in ref.items():
        atol = 4e-6 if name == "transform" else 1e-6
        np.testing.assert_allclose(got[name].numpy(), np.asarray(r), rtol=1e-6, atol=atol,
                                   err_msg=name)


def test_identity_and_orthonormalize_fast():
    rng = np.random.default_rng(5)
    T = np.array(jse3.exp(jnp.asarray(_xi(rng, 16))))
    T[:, :3, :3] += rng.normal(scale=1e-3, size=(16, 3, 3)).astype(np.float32)  # drifted R
    ref = np.asarray(jax.jit(jse3.orthonormalize_fast)(jnp.asarray(T)))
    got = se3.orthonormalize_fast(torch.from_numpy(T)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    R = got[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-6)
    np.testing.assert_array_equal(se3.identity((2,)).numpy(), np.asarray(jse3.identity((2,))))


def _frustum_inputs(rng, n):
    T = np.array(jse3.exp(jnp.asarray([0.3, -0.2, 0.5, 0.05, -0.1, 0.02], jnp.float32)))
    p = np.stack([rng.uniform(-30, 30, n), rng.uniform(-10, 10, n), rng.uniform(-5, 40, n)],
                 -1).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    dmin = rng.uniform(0, 20, n).astype(np.float32)
    dmax = (dmin + rng.uniform(0, 30, n)).astype(np.float32)
    return T, p, nrm, dmin, dmax


def test_in_frustum_masks_exact_away_from_the_gates():
    rng = np.random.default_rng(11)
    T, p, nrm, dmin, dmax = _frustum_inputs(rng, 20000)
    ref = jax.jit(jcamera.in_frustum, static_argnames=("cam", "view_cos_limit"))(
        JCAM, jnp.asarray(T), jnp.asarray(p), jnp.asarray(dmin), jnp.asarray(dmax),
        jnp.asarray(nrm), view_cos_limit=0.5)
    ok_r, uv_r, iz_r, vc_r, d_r = (np.asarray(a) for a in ref)
    got = camera.in_frustum(CAM, torch.from_numpy(T), torch.from_numpy(p),
                            torch.from_numpy(dmin), torch.from_numpy(dmax),
                            torch.from_numpy(nrm), view_cos_limit=0.5)
    ok_g, uv_g, iz_g, vc_g, d_g = (a.numpy() for a in got)
    z = (p @ T[:3, :3].T + T[:3, 3])[:, 2]
    eps = 1e-3
    away = ((np.abs(z) > eps) & (np.abs(uv_r[:, 0]) > eps) & (np.abs(uv_r[:, 0] - 1241) > eps)
            & (np.abs(uv_r[:, 1]) > eps) & (np.abs(uv_r[:, 1] - 376) > eps)
            & (np.abs(d_r - dmin) > eps * d_r) & (np.abs(d_r - dmax) > eps * d_r)
            & (np.abs(vc_r - 0.5) > eps))
    assert away.sum() > 19000 and 100 < ok_r[away].sum() < away.sum() - 100
    np.testing.assert_array_equal(ok_g[away], ok_r[away])
    front = z > 0.1
    near = front & (np.abs(uv_r) < 5000).all(-1)
    np.testing.assert_allclose(uv_g[near], uv_r[near], rtol=0, atol=1e-3)
    np.testing.assert_allclose(d_g, d_r, rtol=1e-4)
    np.testing.assert_allclose(vc_g, vc_r, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(iz_g[front], iz_r[front], rtol=1e-4)


def test_world_to_cam_round_trip_equals_the_reference():
    rng = np.random.default_rng(2)
    T = np.array(jse3.exp(jnp.asarray(_xi(rng, 1)[0])))
    p = rng.normal(scale=4.0, size=(50, 3)).astype(np.float32)
    ref_c = np.asarray(jcamera.world_to_cam(jnp.asarray(T), jnp.asarray(p)))
    got_c = camera.world_to_cam(torch.from_numpy(T), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got_c, ref_c, rtol=0, atol=1e-5)
    back = camera.cam_to_world(torch.from_numpy(T), torch.from_numpy(got_c)).numpy()
    np.testing.assert_allclose(back, p, rtol=0, atol=1e-4)
