"""Batched SE(3) operations on 4x4 f32 matrices (port of
`corbslam_tpu/geometry/se3.py`, the part tracking needs).

Poses are `[..., 4, 4]` homogeneous matrices; tangent vectors are `[..., 6]`
laid out `(rho, phi) = (translation, rotation)`. The small-angle branches
(`theta2 < 1e-8`) are the reference's Taylor expansions. `transform` sums
its three products one by one, in the order the CUDA kernels use, so a
point's camera coordinates are the same bits in the plain versions and the
kernels on the card. `log`, `so3_log` and the quaternions come with loop
closing.
"""

from __future__ import annotations

import torch


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. phi: [..., 3] -> [..., 3, 3] skew matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of hat. M: [..., 3, 3] -> [..., 3]."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """A = sin(t)/t, B = (1-cos t)/t^2, C = (t-sin t)/t^3 from theta^2, with
    the reference's series below theta^2 = 1e-8."""
    small = theta2 < 1e-8
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(t2_safe)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / t2_safe)
    return A, B, C


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    theta2 = (phi * phi).sum(dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    K = hat(phi)
    return _eye3(K) + A[..., None, None] * K + B[..., None, None] * (K @ K)


def left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V: exp(xi)_trans = V @ rho."""
    theta2 = (phi * phi).sum(dim=-1)
    _, B, C = _sinc_coeffs(theta2)
    K = hat(phi)
    return _eye3(K) + B[..., None, None] * K + C[..., None, None] * (K @ K)


def identity(batch_shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(*batch_shape, 4, 4).clone()


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(*batch, 1, 4)], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def _rot_apply(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R @ p as ((r0 x + r1 y) + r2 z) per row: [..., 3, 3], [..., 3]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return torch.stack(
        [R[..., i, 0] * x + R[..., i, 1] * y + R[..., i, 2] * z for i in range(3)], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return from_Rt(Rt, -_rot_apply(Rt, translation(T)))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to points [..., 3] (broadcasting): R p + t."""
    return _rot_apply(rotation(T), p) + translation(T)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp. xi: [..., 6] (rho, phi) -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return from_Rt(so3_exp(phi), _rot_apply(left_jacobian(phi), rho))


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update exp(xi) @ T (the BA update convention)."""
    return compose(exp(xi), T)


def orthonormalize_fast(T: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Project the rotation block toward SO(3) with the Newton polar step
    R <- R (3I - R^T R) / 2. Every pose a tracking step writes goes through
    it: `inverse` uses R^T as R^-1, so without it f32 rounding compounds
    through the velocity / prediction chain frame after frame."""
    R = rotation(T)
    I = _eye3(R)
    for _ in range(iters):
        R = 0.5 * (R @ (3.0 * I - R.transpose(-1, -2) @ R))
    return from_Rt(R, translation(T))
