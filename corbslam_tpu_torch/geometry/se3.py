"""Batched SE(3) operations on 4x4 f32 matrices (port of
`corbslam_tpu/geometry/se3.py`, the part tracking needs).

Poses are `[..., 4, 4]` homogeneous matrices; tangent vectors are `[..., 6]`
laid out `(rho, phi) = (translation, rotation)`. The small-angle branches
(`theta2 < 1e-8`) are the reference's Taylor expansions. `transform` sums
its three products one by one, in the order the CUDA kernels use, so a
point's camera coordinates are the same bits in the plain versions and the
kernels on the card. `so3_log` keeps the reference's two branch
thresholds (the small-angle series above cos = 1 - 1e-6, the symmetric-part
axis above theta = 3).
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


EPS = 1e-8


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle, [..., 3, 3] -> [..., 3], with the
    reference's branches near theta = 0 and theta = pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = ((trace - 1.0) * 0.5).clamp(-1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # sin(theta) * axis
    small = cos_t > 1.0 - 1e-6
    cos_gen = torch.where(small, torch.full_like(cos_t, 0.5), cos_t)
    theta_gen = torch.arccos(cos_gen)
    theta = torch.where(small, torch.sqrt((2.0 * (1.0 - cos_t)).clamp_min(1e-24)), theta_gen)
    scale = torch.where(small, 1.0 + (1.0 - cos_t) / 3.0,
                        theta_gen / torch.sin(theta_gen).clamp_min(EPS))
    phi_generic = scale[..., None] * w
    # Near pi: the axis from the diagonal of (R + I) / 2, signed by the
    # off-diagonals of the row of its largest component, then by w.
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = ((diag - cos_t[..., None]) / (1.0 - cos_t[..., None]).clamp_min(EPS)).clamp_min(0.0)
    axis = torch.sqrt(axis2.clamp_min(1e-24))
    Rsym = (R + R.transpose(-1, -2)) * 0.5
    k = torch.argmax(axis2, dim=-1)
    offd = torch.stack([
        torch.stack([axis2[..., 0], Rsym[..., 0, 1], Rsym[..., 0, 2]], dim=-1),
        torch.stack([Rsym[..., 1, 0], axis2[..., 1], Rsym[..., 1, 2]], dim=-1),
        torch.stack([Rsym[..., 2, 0], Rsym[..., 2, 1], axis2[..., 2]], dim=-1),
    ], dim=-2)
    row = torch.gather(offd, -2, k[..., None, None].expand(*k.shape, 1, 3))[..., 0, :]
    signs = torch.sign(torch.where(row.abs() < EPS, torch.ones_like(row), row))
    axis_pi = axis * signs
    axis_pi = axis_pi / torch.linalg.norm(axis_pi, dim=-1, keepdim=True).clamp_min(EPS)
    dot_w = (axis_pi * w).sum(dim=-1, keepdim=True)
    axis_pi = torch.where(dot_w < 0.0, -axis_pi, axis_pi)
    return torch.where((theta > 3.0)[..., None], theta[..., None] * axis_pi, phi_generic)


def left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = (phi * phi).sum(dim=-1)
    theta = torch.sqrt(theta2.clamp_min(EPS * EPS))
    K = hat(phi)
    half = 0.5 * theta
    cot = torch.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0,
                      (1.0 - half * torch.cos(half) / torch.sin(half).clamp_min(EPS))
                      / theta2.clamp_min(EPS))
    return _eye3(K) - 0.5 * K + cot[..., None, None] * (K @ K)


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


def log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] -> [..., 6] (rho, phi)."""
    phi = so3_log(rotation(T))
    rho = (left_jacobian_inv(phi) @ translation(T)[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


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


def quat_from_R(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z): the best
    conditioned of the four constructions."""
    m = [[R[..., i, j] for j in range(3)] for i in range(3)]
    qw = torch.sqrt((1.0 + m[0][0] + m[1][1] + m[2][2]).clamp_min(0.0)) * 0.5
    qx = torch.sqrt((1.0 + m[0][0] - m[1][1] - m[2][2]).clamp_min(0.0)) * 0.5
    qy = torch.sqrt((1.0 - m[0][0] + m[1][1] - m[2][2]).clamp_min(0.0)) * 0.5
    qz = torch.sqrt((1.0 - m[0][0] - m[1][1] + m[2][2]).clamp_min(0.0)) * 0.5
    a, b, c = m[2][1] - m[1][2], m[0][2] - m[2][0], m[1][0] - m[0][1]
    d, e, f = m[0][1] + m[1][0], m[0][2] + m[2][0], m[1][2] + m[2][1]
    cands = torch.stack([
        torch.stack([qw, a / (4 * qw + EPS), b / (4 * qw + EPS), c / (4 * qw + EPS)], -1),
        torch.stack([a / (4 * qx + EPS), qx, d / (4 * qx + EPS), e / (4 * qx + EPS)], -1),
        torch.stack([b / (4 * qy + EPS), d / (4 * qy + EPS), qy, f / (4 * qy + EPS)], -1),
        torch.stack([c / (4 * qz + EPS), e / (4 * qz + EPS), f / (4 * qz + EPS), qz], -1),
    ], dim=-2)
    best = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(EPS)


def R_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
