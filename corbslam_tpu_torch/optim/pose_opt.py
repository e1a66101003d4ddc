"""Motion-only pose optimization, one camera against fixed points (port of
`corbslam_tpu/optim/pose_opt.py`: `optimize_pose`).

`Optimizer::PoseOptimization` (Optimizer.cc:272) as the reference runs it:
Levenberg-Marquardt on one SE(3) pose, 4 rounds of 10 iterations, lambda
restarting at 1e-3 each round, the Huber kernel in rounds 0-1 only, an
iteration kept only if its robust cost drops, and between rounds the inliers
re-classified as `valid & depth_ok & chi2 <= delta2` (an outlier can come
back). delta2 is 7.815 for stereo and 5.991 for mono observations and is also
the Huber delta^2. The pose is re-orthonormalized at the end.

`optimize_pose` is the wrapper of kernel K6 (`csrc/pose_opt.cu`), which runs
all 40 iterations of one problem in one launch on a cluster of 8 CTAs; CPU
tensors take `optimize_pose_plain`, the reference's loop in PyTorch. There
is no batched form: relocalization and loop closing check their candidates
one at a time.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..geometry import se3
from . import reproj


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor        # [4, 4] optimized pose
    inliers: torch.Tensor    # [K] bool final inlier classification
    n_inliers: torch.Tensor  # 0-dim i32
    cost: torch.Tensor       # 0-dim f32 last round's robust cost


def _normal_system(res: reproj.Residuals, robust_w, active):
    """H [6, 6], g [6]: (J^T W J) d = -J^T W r."""
    w = res.w * (robust_w * active)[:, None]
    Jw = res.J_pose * w[:, :, None]
    H = torch.einsum("kri,krj->ij", Jw, res.J_pose)
    g = -torch.einsum("kri,kr->i", Jw, res.r)
    return H, g


def _robust_cost(c2, delta2, use_huber: bool, active):
    if use_huber:
        rho = torch.where(c2 > delta2, 2.0 * torch.sqrt(delta2 * c2.clamp_min(1e-12)) - delta2, c2)
    else:
        rho = c2
    return (rho * active).sum()


def optimize_pose_plain(cam, T_init, X, obs, inv_sigma2, is_stereo, valid,
                        n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """Plain version of K6: the reference's LM loop over [K] observations."""
    delta2 = reproj.chi2_threshold(is_stereo)
    dev = X.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    def lin(T):
        res = reproj.linearize(cam, T, X, obs, inv_sigma2, is_stereo)
        return res, reproj.chi2(res.r, res.w)

    T, inliers = T_init, valid
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    for rnd in range(n_rounds):
        use_huber = rnd < 2
        res0, c20 = lin(T)
        cost = _robust_cost(c20, delta2, use_huber, (inliers & valid & res0.depth_ok).float())
        lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            res, c2 = lin(T)
            rw = reproj.huber_weights(c2, delta2) if use_huber else torch.ones_like(c2)
            active = (inliers & valid & res.depth_ok).float()
            H, g = _normal_system(res, rw, active)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-10 * eye6
            T_new = se3.retract(T, torch.linalg.solve(Hd, g))
            _, c2n = lin(T_new)
            cost_new = _robust_cost(c2n, delta2, use_huber, active)
            accept = cost_new < cost
            T = torch.where(accept, T_new, T)
            lam = torch.where(accept, (lam * 0.5).clamp_min(1e-9), (lam * 4.0).clamp_max(1e4))
            cost = torch.where(accept, cost_new, cost)
        res, c2 = lin(T)
        inliers = valid & res.depth_ok & (c2 <= delta2)
    T = se3.orthonormalize_fast(T)
    return PoseOptResult(T, inliers, inliers.sum(dtype=torch.int32), cost)


MAX_OBS = 8192  # pose_opt's cluster owns at most 4 observations a thread


def _optimize_pose_cuda(cam, T_init, X, obs, inv_sigma2, is_stereo, valid, n_rounds, n_iters):
    K = X.shape[0]
    dev = X.device
    if K > MAX_OBS:
        raise ValueError(f"optimize_pose takes at most {MAX_OBS} observations")
    chk = kernels.check
    T_init = T_init.contiguous()
    chk(T_init, "T_init", torch.float32, (4, 4), dev)
    chk(X, "X", torch.float32, (K, 3), dev)
    chk(obs, "obs", torch.float32, (K, 3), dev)
    chk(inv_sigma2, "inv_sigma2", torch.float32, (K,), dev)
    chk(is_stereo, "is_stereo", torch.bool, (K,), dev)
    chk(valid, "valid", torch.bool, (K,), dev)
    T = torch.empty(4, 4, dtype=torch.float32, device=dev)
    inliers = torch.empty(K, dtype=torch.bool, device=dev)
    n_in = torch.empty((), dtype=torch.int32, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch(
        "pose_opt", "pose_opt", p(T_init), p(X), p(obs), p(inv_sigma2), p(is_stereo), p(valid),
        K, int(n_rounds), int(n_iters), float(cam.fx), float(cam.fy), float(cam.cx),
        float(cam.cy), float(cam.bf), p(T), p(inliers), p(n_in), p(cost))
    return PoseOptResult(T, inliers, n_in, cost)


def optimize_pose(cam, T_init, X, obs, inv_sigma2, is_stereo, valid,
                  n_rounds: int = 4, n_iters: int = 10) -> PoseOptResult:
    """Optimize Tcw from T_init [4, 4] against X [K, 3] world points and
    obs [K, 3] (u, v, u_right) with weights inv_sigma2 [K]; `valid` [K]
    marks observations with a match. K6 on CUDA tensors, the plain version
    on CPU tensors."""
    if X.is_cuda:
        return _optimize_pose_cuda(cam, T_init, X, obs, inv_sigma2, is_stereo, valid,
                                   n_rounds, n_iters)
    if X.device.type == "cpu":
        return optimize_pose_plain(cam, T_init, X, obs, inv_sigma2, is_stereo, valid,
                                   n_rounds, n_iters)
    raise ValueError(f"unsupported device {X.device}")
