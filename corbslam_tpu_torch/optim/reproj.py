"""Reprojection residuals and analytic Jacobians, mono and stereo (port of
`corbslam_tpu/optim/reproj.py`).

Residual r = z - h(T, X) with h the (stereo) pinhole projection and
Jacobians with respect to the camera's left-multiplicative se(3) update
exp(xi) @ Tcw and the world point. Residuals are 3-vectors (u, v, u_right);
a mono observation zeroes the third weight. The pose kernel K6
(`csrc/pose_opt.cu`) inlines the same arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3

# Chi2 95 % quantiles (Optimizer.cc:419-420): 2-DoF mono, 3-DoF stereo.
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class Residuals(NamedTuple):
    r: torch.Tensor         # [K, 3] residual (u, v, uR); third row 0 for mono
    J_pose: torch.Tensor    # [K, 3, 6] d r / d xi (camera tangent)
    J_point: torch.Tensor   # [K, 3, 3] d r / d X_world
    w: torch.Tensor         # [K, 3] per-row weights (invSigma2, 0 third row mono)
    depth_ok: torch.Tensor  # [K] positive-depth mask


def observation_weights(inv_sigma2: torch.Tensor, is_stereo: torch.Tensor) -> torch.Tensor:
    """[K] -> [K, 3] row weights; mono zeroes the u_right row."""
    w3 = torch.where(is_stereo, inv_sigma2, torch.zeros_like(inv_sigma2))
    return torch.stack([inv_sigma2, inv_sigma2, w3], dim=-1)


def linearize(cam, Tcw: torch.Tensor, X: torch.Tensor, obs: torch.Tensor,
              inv_sigma2: torch.Tensor, is_stereo: torch.Tensor) -> Residuals:
    """Residuals + Jacobians at the current linearization point. Tcw is
    [K, 4, 4] (one pose per observation) or a broadcastable [4, 4]."""
    R = se3.rotation(Tcw)
    p = se3.transform(Tcw, X)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    depth_ok = z > 1e-3
    zs = torch.where(depth_ok, z, torch.ones_like(z))
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    u = fx * x * inv_z + cam.cx
    v = fy * y * inv_z + cam.cy
    ur = u - bf * inv_z
    r = obs - torch.stack([u, v, ur], dim=-1)

    zero = torch.zeros_like(x)
    A = torch.stack([
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2], -1),
        torch.stack([zero, fy * inv_z, -fy * y * inv_z2], -1),
        torch.stack([fx * inv_z, zero, -fx * x * inv_z2 + bf * inv_z2], -1),
    ], dim=-2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(A.shape)
    B = torch.cat([eye, -se3.hat(p)], dim=-1)
    J_pose = -(A @ B)
    J_point = -(A @ R.expand(A.shape))
    w = observation_weights(inv_sigma2, is_stereo) * depth_ok[:, None]
    return Residuals(r, J_pose, J_point, w, depth_ok)


def chi2(res_r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted squared error per observation: [K, 3], [K, 3] -> [K]."""
    return (res_r * res_r * w).sum(dim=-1)


def chi2_threshold(is_stereo: torch.Tensor) -> torch.Tensor:
    return torch.where(is_stereo, torch.full(is_stereo.shape, CHI2_STEREO, device=is_stereo.device),
                       torch.full(is_stereo.shape, CHI2_MONO, device=is_stereo.device))


def huber_weights(c2: torch.Tensor, delta2: torch.Tensor) -> torch.Tensor:
    """IRLS Huber weight from chi2: 1 for chi2 <= delta^2, else delta/sqrt(chi2)."""
    safe = c2.clamp_min(1e-12)
    return torch.where(c2 <= delta2, torch.ones_like(c2), torch.sqrt(delta2 / safe))
