"""Batched absolute-pose (PnP) RANSAC (port of `corbslam_tpu/solvers/pnp.py`:
`_dlt_pose`, `solve_pnp_ransac`).

Each hypothesis solves the pose from 6 correspondences by DLT: Hartley
normalization of the world points, the 12x12 normal matrix, its smallest
eigenvector by 8 inverse iterations on a regularized Cholesky factor, the
sign and scale from det(M), and 8 Newton polar steps (Cramer 3x3
inverses) onto SO(3), in float64 (the reference's f32 carries rounding
into poses of near-degenerate samples). The sampling is an input as in
`sim3_solver`. On CUDA tensors the whole RANSAC (the hypotheses, the
first maximum of their counts and its inlier mask) is one launch of kernel
K10 (`csrc/ransac.cu` `pnp_ransac`) on N <= `PNP_MAX_N` matches; on CPU
tensors `solve_pnp_ransac_plain`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..matching.matcher import div
from ..optim.smallmat import chol_solve_factored, chol_unrolled
from .sim3_solver import sample_indices

PNP_MAX_N = 8192  # the kernel stages 6 floats of every match in one CTA's shared memory


class PnPResult(NamedTuple):
    Tcw: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _dlt_pose(X: torch.Tensor, uv_norm: torch.Tensor):
    """Poses from [H, K, 3] world points and [H, K, 2] normalized image
    coordinates: (R [H, 3, 3], t [H, 3]) in X's dtype, computed in float64.
    Six noisy matches can leave the 12x12 normal matrix's two smallest
    eigenvalues close; in f32 the inverse iteration then carries rounding
    into the pose (at the flagship's 19 m, two f32 orders of the same sums
    gave poses centimetres apart), in f64 a negligible part of it."""
    dt = X.dtype
    X, uv_norm = X.double(), uv_norm.double()
    H, K, _ = X.shape
    dev = X.device
    c = X.mean(dim=1)
    Xc = X - c[:, None, :]
    sigma = torch.sqrt((Xc * Xc).sum(dim=2).mean(dim=1) / 3.0).clamp_min(1e-6)
    Xn = Xc / sigma[:, None, None]
    zeros = torch.zeros(H, K, 4, dtype=X.dtype, device=dev)
    Xh = torch.cat([Xn, torch.ones(H, K, 1, dtype=X.dtype, device=dev)], dim=2)
    u, v = uv_norm[..., 0:1], uv_norm[..., 1:2]
    A = torch.cat([torch.cat([Xh, zeros, -u * Xh], dim=2),
                   torch.cat([zeros, Xh, -v * Xh], dim=2)], dim=1)   # [H, 2K, 12]
    AtA = A.transpose(1, 2) @ A
    eps = 1e-7 * torch.diagonal(AtA, dim1=1, dim2=2).sum(dim=1) + 1e-12
    L = chol_unrolled(AtA + eps[:, None, None] * torch.eye(12, dtype=X.dtype, device=dev), 12)
    p = torch.ones(H, 12, dtype=X.dtype, device=dev) / torch.sqrt(torch.tensor(12.0))
    for _ in range(8):
        p = chol_solve_factored(L, p, 12)
        p = p / torch.linalg.norm(p, dim=1, keepdim=True).clamp_min(1e-20)
    Pn = p.reshape(H, 3, 4)
    T_norm = torch.zeros(H, 4, 4, dtype=X.dtype, device=dev)
    T_norm[:, :3, :3] = torch.eye(3, dtype=X.dtype, device=dev) / sigma[:, None, None]
    T_norm[:, :3, 3] = -c / sigma[:, None]
    T_norm[:, 3, 3] = 1.0
    P = Pn @ T_norm
    detM = torch.linalg.det(P[:, :, :3])
    P = P * torch.where(detM < 0, -1.0, 1.0)[:, None, None]
    scale = detM.abs().clamp_min(1e-20) ** (1.0 / 3.0)
    M = P[:, :, :3] / scale[:, None, None]
    t = P[:, :, 3] / scale[:, None]
    eye = torch.eye(3, dtype=X.dtype, device=dev)
    for _ in range(8):
        Minv = torch.stack([cam_mod.solve3x3(M, eye[i].expand(H, 3)) for i in range(3)], dim=-1)
        M = 0.5 * (M + Minv.transpose(1, 2))
    return M.to(dt), t.to(dt)


def normalized(cam, uv: torch.Tensor) -> torch.Tensor:
    """(uv - c) / f, correctly rounded on every device as K10 divides (the
    DLT would carry an ulp of the input into the pose)."""
    return torch.stack([div(uv[:, 0] - cam.cx, cam.fx), div(uv[:, 1] - cam.cy, cam.fy)], dim=-1)


def solve_pnp_ransac_plain(cam, X, uv, valid, sigma2, idx, min_inliers: int = 15,
                           chi2_th: float = 5.991) -> PnPResult:
    i = idx.long()
    R, t = _dlt_pose(X[i], normalized(cam, uv)[i])
    p_cam = X @ R.transpose(1, 2) + t[:, None, :]
    err2 = ((cam_mod.project(cam, p_cam) - uv[None]) ** 2).sum(dim=-1)
    inl = (err2 < chi2_th * sigma2[None]) & (p_cam[..., 2] > 0) & valid[None]
    counts = inl.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(counts)
    n_in = counts[best]
    return PnPResult(se3.from_Rt(R[best], t[best]), inl[best], n_in, n_in >= min_inliers)


def solve_pnp_ransac(cam, X, uv, valid, sigma2, generator: Optional[torch.Generator] = None,
                     n_hyp: int = 256, min_inliers: int = 15, chi2_th: float = 5.991,
                     idx: Optional[torch.Tensor] = None) -> PnPResult:
    """PnP RANSAC in one fixed-shape pass: X [N, 3] world points, uv [N, 2]
    pixels, gate chi2_th x sigma2; the best hypothesis is the first maximum
    of the inlier count. `idx` [n_hyp, 6] overrides the draw."""
    if idx is None:
        idx = sample_indices(valid, n_hyp, 6, generator)
    if not X.is_cuda:
        if X.device.type != "cpu":
            raise ValueError(f"unsupported device {X.device}")
        return solve_pnp_ransac_plain(cam, X, uv, valid, sigma2, idx, min_inliers, chi2_th)
    dev, N, H = X.device, X.shape[0], idx.shape[0]
    for name, t, dt, shape in (("X", X, torch.float32, (N, 3)), ("uv", uv, torch.float32, (N, 2)),
                               ("valid", valid, torch.bool, (N,)),
                               ("sigma2", sigma2, torch.float32, (N,)),
                               ("idx", idx, torch.int32, (H, 6))):
        kernels.check(t, name, dt, shape, dev)
    check_capacity(N, dev)
    if H < 1:
        raise ValueError("idx: needs at least one hypothesis")
    f32 = dict(dtype=torch.float32, device=dev)
    models = torch.empty(H, 12, **f32)
    T = torch.empty(4, 4, **f32)
    inl = torch.empty(N, dtype=torch.bool, device=dev)
    n_in = torch.empty((), dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    p = kernels.ptr
    work = kernels.workspace("pnp", dev, kernels.stream(), kernels.STAMPED_WORDS)
    kernels.launch("pnp", "pnp_ransac", p(X), p(uv), p(valid), p(sigma2), N, p(idx), H,
                   int(min_inliers), float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                   float(chi2_th), p(work), p(models), p(T), p(inl), p(n_in), p(ok))
    return PnPResult(T, inl, n_in, ok)


def check_capacity(n_matches: int, device) -> None:
    """Raises when K10's PnP kernel cannot take `n_matches` matches on
    `device` (the plain version takes any number): the tracker calls it at
    set-up with its frames' feature capacity."""
    if torch.device(device).type == "cuda" and n_matches > PNP_MAX_N:
        raise ValueError(f"{n_matches} matches: K10's PnP kernel takes at most {PNP_MAX_N}")
