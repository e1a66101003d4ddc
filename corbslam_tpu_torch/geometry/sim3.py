"""Batched Sim(3) similarity transforms (port of `corbslam_tpu/geometry/sim3.py`).

A Sim3 element is `(R [..., 3, 3], t [..., 3], s [...])`, the scale kept apart
from the rotation so SE3 interop is free. Tangent layout `[..., 7] = (rho,
phi, sigma)` with `s = exp(sigma)`. `exp` / `log` use the closed-form W
matrix (Strasdat 2010) with the reference's series branches; the pose-graph
kernel K11 (`csrc/pose_graph.cu`) carries the same arithmetic.
"""

from __future__ import annotations

import torch

from . import se3

EPS = 1e-8


def identity(batch_shape=(), dtype=torch.float32, device="cpu"):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    return R, torch.zeros(*batch_shape, 3, dtype=dtype, device=device), \
        torch.ones(batch_shape, dtype=dtype, device=device)


def from_se3(T: torch.Tensor):
    return se3.rotation(T), se3.translation(T), torch.ones(T.shape[:-2], dtype=T.dtype,
                                                           device=T.device)


def to_matrix(S) -> torch.Tensor:
    """(R, t, s) -> [..., 4, 4] with sR in the rotation block."""
    R, t, s = S
    return se3.from_Rt(s[..., None, None] * R, t)


def _mv(R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return (R @ p[..., None])[..., 0]


def transform(S, p: torch.Tensor) -> torch.Tensor:
    """p' = s R p + t."""
    R, t, s = S
    return s[..., None] * _mv(R, p) + t


def compose(A, B):
    """A o B: s_a R_a (s_b R_b x + t_b) + t_a."""
    Ra, ta, sa = A
    Rb, tb, sb = B
    return Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta, sa * sb


def inverse(S):
    R, t, s = S
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s.clamp_min(EPS)
    return Rt, -s_inv[..., None] * _mv(Rt, t), s_inv


def _w_coeffs(theta2, sigma, s, exact_c: bool):
    """A, B, C of W = A I + B K + C K^2 (the reference's branches; `log`
    uses C = 1/6 in the small-angle / not-small-sigma corner, as it does)."""
    theta = torch.sqrt(theta2.clamp_min(EPS * EPS))
    sig2 = sigma * sigma
    small_sig = sigma.abs() < 1e-5
    small_th = theta < 1e-5
    one = torch.ones_like(sigma)
    A = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / torch.where(small_sig, one, sigma))
    denom = (sig2 + theta2).clamp_min(EPS)
    s_cos = s * torch.cos(theta)
    s_sin = s * torch.sin(theta)
    B_gen = (sigma * s_sin + theta * (1.0 - s_cos)) / (theta.clamp_min(EPS) * denom)
    B_small = torch.where(small_sig, 0.5 + sigma / 3.0,
                          (s * (1.0 - sigma) - 1.0 + sig2 * A) / torch.where(small_sig, one, denom))
    B = torch.where(small_th, B_small, B_gen)
    C_gen = (A - ((s_cos - 1.0) * sigma + s_sin * theta) / denom) / theta2.clamp_min(EPS)
    if exact_c:
        C_small = torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0,
                              (A - sigma * (s - 1.0 - sig2 * A) / torch.where(small_sig, one, denom))
                              / theta2.clamp_min(1.0))
    else:
        C_small = torch.where(small_sig, 1.0 / 6.0 + sigma / 8.0, A * 0 + 1.0 / 6.0)
    return A, B, torch.where(small_th, C_small, C_gen)


def _w_matrix(phi, sigma, s, exact_c: bool):
    theta2 = (phi * phi).sum(dim=-1)
    A, B, C = _w_coeffs(theta2, sigma, s, exact_c)
    K = se3.hat(phi)
    I = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return A[..., None, None] * I + B[..., None, None] * K + C[..., None, None] * (K @ K)


def exp(xi: torch.Tensor):
    """sim(3) exp, [..., 7] (rho, phi, sigma) -> (R, t, s), t = W rho."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    W = _w_matrix(phi, sigma, s, exact_c=True)
    return se3.so3_exp(phi), _mv(W, rho), s


def log(S) -> torch.Tensor:
    """(R, t, s) -> [..., 7], inverse of `exp` by solving W rho = t."""
    R, t, s = S
    phi = se3.so3_log(R)
    sigma = torch.log(s.clamp_min(EPS))
    W = _w_matrix(phi, sigma, s, exact_c=False)
    rho = torch.linalg.solve(W, t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def retract(S, xi: torch.Tensor):
    """Left-multiplicative update exp(xi) o S."""
    return compose(exp(xi), S)
