"""Monocular two-view bootstrap (port of `corbslam_tpu/solvers/initializer.py`:
`_normalize`, `_eight_point_F`, `_dlt_H`, `_score_F`, `_score_H`, `_check_rt`,
`initialize_two_view`).

Initializer.cc's parallel H / F RANSAC, model selection and reconstruction
in one fixed-shape pass: 256 hypotheses of each model from one [256, 8]
sample of the matches (Hartley-normalized coordinates; the 9x9 normal matrix
of the eight-point F or of the DLT H, its smallest eigenvector by inverse
iteration; F projected to rank 2 through `svd3x3`), symmetric-transfer
scores, the first best hypothesis refit on all its inliers and rescored,
the model choice RH = SH / (SH + SF) > 0.40, then the 4 (R, t) candidates of
E = K^T F K or the 8 of the Faugeras decomposition of K^-1 H K, each checked
by triangulating every inlier (cheirality, parallax, reprojection), the best
by good count with the uniqueness test. As in the reference, each H
hypothesis is the DLT of all 8 sampled matches (`x1n[idx, :4]` slices the
coordinate axis) and `R * sign(det R)` keeps a zero matrix when det R is 0.

The sample is an input: `sample_indices` with the tracker's generator on
the path, JAX's index array in the tests. On CUDA tensors the whole pass is
one launch of kernel K12 (`csrc/two_view.cu` `two_view`, no host sync) on
N <= `TV_MAX_N` matches; on CPU tensors `initialize_two_view_plain`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..geometry import camera as cam_mod
from ..geometry import linalg3
from ..mapping.triangulation import triangulate_midpoint
from .sim3_solver import sample_indices

CHI2_F = 3.841    # 1-DoF epipolar distance gate (CheckFundamental)
CHI2_H = 5.991    # 2-DoF transfer error gate (CheckHomography)
SCORE_TH = 5.991  # score accumulator offset
N_HYP, N_SAMPLE = 256, 8
TV_MAX_N = 4096  # the kernel keeps 39 bytes of every match in one CTA's shared memory


class InitResult(NamedTuple):
    ok: torch.Tensor       # [] bool
    used_H: torch.Tensor   # [] bool
    R: torch.Tensor        # [3, 3] cam2 <- cam1 rotation
    t: torch.Tensor        # [3] unit-norm translation
    X: torch.Tensor        # [N, 3] points in cam1
    good: torch.Tensor     # [N] triangulated inliers
    n_good: torch.Tensor   # [] i32
    score_h: torch.Tensor  # [] f32
    score_f: torch.Tensor  # [] f32


def _normalize(xy, valid):
    """Zero mean, unit mean absolute deviation over the valid points
    (Initializer::Normalize): (normalized xy, T)."""
    w = valid.to(xy.dtype)
    n = w.sum().clamp_min(1.0)
    mean = (xy * w[:, None]).sum(dim=0) / n
    md = ((xy - mean).abs() * w[:, None]).sum(dim=0) / n
    s = 1.0 / md.clamp_min(1e-9)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]), torch.stack([z, z, o])])
    return (xy - mean) * s, T


def _normal_matrix(A, w=None):
    if w is not None:
        A = A * w[..., None]
    return A.transpose(-1, -2) @ A


def _eight_point_F(x1, x2, w=None):
    """F from normalized correspondences [..., K, 2] (x2^T F x1 = 0), rank 2."""
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)
    f = linalg3.smallest_eigvec_sym(_normal_matrix(A, w))
    F = f.reshape(*f.shape[:-1], 3, 3)
    U, _, V = linalg3.svd3x3(F)
    u3, v3 = U[..., :, 2], V[..., :, 2]
    sig3 = (u3[..., :, None] * F * v3[..., None, :]).sum(dim=(-2, -1))
    return F - sig3[..., None, None] * u3[..., :, None] * v3[..., None, :]


def _dlt_H(x1, x2, w=None):
    """H from normalized correspondences [..., K, 2] (x2 ~ H x1)."""
    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    one, zero = torch.ones_like(u1), torch.zeros_like(u1)
    r1 = torch.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2], dim=-1)
    r2 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    h = linalg3.smallest_eigvec_sym(_normal_matrix(A, None if w is None else torch.cat([w, w], -1)))
    return h.reshape(*h.shape[:-1], 3, 3)


def _homogeneous(xy):
    return torch.cat([xy, torch.ones_like(xy[:, :1])], dim=-1)


def _score_F(F, xy1, xy2, valid, inv_sigma2: float):
    """Symmetric epipolar-distance score of F [..., 3, 3] (CheckFundamental):
    (score [...], inliers [..., N])."""
    p1, p2 = _homogeneous(xy1), _homogeneous(xy2)
    l2 = torch.einsum("...ij,nj->...ni", F, p1)
    l1 = torch.einsum("...ji,nj->...ni", F, p2)
    d2 = (l2 * p2).sum(-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2).clamp_min(1e-12)
    d1 = (l1 * p1).sum(-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2).clamp_min(1e-12)
    return _score(d1 * inv_sigma2, d2 * inv_sigma2, valid, CHI2_F)


def _score(c1, c2, valid, chi2: float):
    ok = (c1 < chi2) & (c2 < chi2) & valid
    zero = torch.zeros_like(c1)
    sc = torch.where(c1 < chi2, SCORE_TH - c1, zero) + torch.where(c2 < chi2, SCORE_TH - c2, zero)
    return torch.where(valid, sc, zero).sum(-1), ok


def _transfer(H, p):
    q = torch.einsum("...ij,nj->...ni", H, p)
    z = q[..., 2:]
    return q[..., :2] / torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)


def _score_H(H, Hinv, xy1, xy2, valid, inv_sigma2: float):
    """Symmetric transfer-error score of H (CheckHomography)."""
    p1, p2 = _homogeneous(xy1), _homogeneous(xy2)
    c2 = ((_transfer(H, p1) - xy2) ** 2).sum(-1) * inv_sigma2
    c1 = ((_transfer(Hinv, p2) - xy1) ** 2).sum(-1) * inv_sigma2
    return _score(c1, c2, valid, CHI2_H)


def _check_rt(cam, R, t, xy1, xy2, valid, inv_sigma2: float):
    """Triangulate every match under candidate (R [C, 3, 3], t [C, 3]) and
    count the good ones (CheckRT): (n_good [C], X [C, N, 3], good [C, N])."""
    N = xy1.shape[0]
    ones = torch.ones(N, dtype=xy1.dtype, device=xy1.device)
    o2 = -torch.einsum("cji,cj->ci", R, t)
    d1 = cam_mod.backproject(cam, xy1, ones)
    d2 = torch.einsum("cji,nj->cni", R, cam_mod.backproject(cam, xy2, ones))
    o1 = torch.zeros_like(d2)
    X, _, _ = triangulate_midpoint(o1, d1.expand_as(d2), o2[:, None, :].expand_as(d2), d2)
    p2c = torch.einsum("cij,cnj->cni", R, X) + t[:, None, :]
    cheir = (X[..., 2] > 0) & (p2c[..., 2] > 0)
    r2 = X - o2[:, None, :]
    cospar = (X * r2).sum(-1) / (linalg3.norm(X) * linalg3.norm(r2)).clamp_min(1e-12)
    e1 = ((cam_mod.project(cam, X) - xy1) ** 2).sum(-1) * inv_sigma2
    e2 = ((cam_mod.project(cam, p2c) - xy2) ** 2).sum(-1) * inv_sigma2
    good = valid & cheir & (cospar < 0.99998) & (e1 < 4.0) & (e2 < 4.0)
    return good.sum(-1, dtype=torch.int32), X, good


def _fix_det(R):
    return R * torch.sign(linalg3.det3(R))[..., None, None]


def candidates_F(cam, F):
    """The 4 (R, t) of E = K^T F K (ReconstructF)."""
    K = cam.K.to(F.device)
    U, _, V = linalg3.svd3x3(K.T @ F @ K)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], device=F.device)
    Ra, Rb = _fix_det(U @ W @ V.T), _fix_det(U @ W.T @ V.T)
    tu = U[:, 2] / linalg3.norm(U[:, 2]).clamp_min(1e-12)
    return torch.stack([Ra, Ra, Rb, Rb]), torch.stack([tu, -tu, tu, -tu])


def candidates_H(cam, H):
    """The 8 (R, t) of the Faugeras decomposition of K^-1 H K (ReconstructH)."""
    dev = H.device
    K = cam.K.to(dev)
    Ua, da, Va = linalg3.svd3x3(torch.linalg.inv(K) @ H @ K)
    sdet = linalg3.det3(Ua) * linalg3.det3(Va)
    d1, d2, d3 = da[0], da[1], da[2]
    denom13 = (d1 * d1 - d3 * d3).clamp_min(1e-12)
    aux1 = torch.sqrt((d1 * d1 - d2 * d2).clamp_min(0.0) / denom13)
    aux3 = torch.sqrt((d2 * d2 - d3 * d3).clamp_min(0.0) / denom13)
    sgn = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev)
    x1s = torch.tensor([1.0, 1.0, -1.0, -1.0], device=dev) * aux1
    x3s = sgn * aux3
    root = torch.sqrt(((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp_min(0.0))
    st = root / ((d1 + d3) * d2).clamp_min(1e-12)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2).clamp_min(1e-12)
    sp = root / ((d1 - d3) * d2).clamp_min(1e-12)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2).clamp_min(1e-12)
    Rs, ts = [], []
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    for i in range(4):  # d' = +d2
        Rp = torch.stack([torch.stack([ct, zero, -sgn[i] * st]), torch.stack([zero, one, zero]),
                          torch.stack([sgn[i] * st, zero, ct])])
        Rs.append(sdet * (Ua @ Rp @ Va.T))
        ts.append(Ua @ (torch.stack([x1s[i], zero, -x3s[i]]) * (d1 - d3)))
    for i in range(4):  # d' = -d2
        Rp = torch.stack([torch.stack([cp, zero, sgn[i] * sp]), torch.stack([zero, -one, zero]),
                          torch.stack([sgn[i] * sp, zero, -cp])])
        Rs.append(sdet * (Ua @ Rp @ Va.T))
        ts.append(Ua @ (torch.stack([x1s[i], zero, x3s[i]]) * (d1 + d3)))
    return torch.stack(Rs), torch.stack(ts)


def initialize_two_view_plain(cam, xy1, xy2, valid, sample, sigma: float = 1.0,
                              min_triangulated: int = 50) -> InitResult:
    """Plain version of kernel K12 (the reference's algorithm as written)."""
    inv_sigma2 = 1.0 / (sigma * sigma)
    dev = xy1.device
    eye = torch.eye(3, device=dev)
    x1n, T1 = _normalize(xy1, valid)
    x2n, T2 = _normalize(xy2, valid)
    idx = sample.long()

    Fn = _eight_point_F(x1n[idx], x2n[idx])
    F = T2.T @ Fn @ T1
    sF, okF = _score_F(F, xy1, xy2, valid, inv_sigma2)
    Fn_ref = _eight_point_F(x1n, x2n, w=okF[torch.argmax(sF)].to(torch.float32))
    F_best = T2.T @ Fn_ref @ T1
    score_f, inl_F = _score_F(F_best, xy1, xy2, valid, inv_sigma2)

    Hn = _dlt_H(x1n[idx], x2n[idx])
    T2inv = torch.linalg.inv(T2)
    Hm = T2inv @ Hn @ T1
    # inv_ex: a singular H (a degenerate sample) gives non-finite entries, as
    # jnp.linalg.inv does, instead of raising.
    sH, okH = _score_H(Hm, torch.linalg.inv_ex(Hm + 1e-12 * eye)[0], xy1, xy2, valid,
                       inv_sigma2)
    Hn_ref = _dlt_H(x1n, x2n, w=okH[torch.argmax(sH)].to(torch.float32))
    H_best = T2inv @ Hn_ref @ T1
    score_h, inl_H = _score_H(H_best, torch.linalg.inv_ex(H_best + 1e-12 * eye)[0], xy1, xy2,
                              valid, inv_sigma2)

    use_H = score_h / (score_h + score_f).clamp_min(1e-9) > 0.40
    RF, tF = candidates_F(cam, F_best)
    RH, tH = candidates_H(cam, H_best)
    R_all = torch.cat([RF, RH])
    t_all = torch.cat([tF, tH])
    t_all = t_all / linalg3.norm(t_all, keepdim=True).clamp_min(1e-12)
    is_H = torch.arange(12, device=dev) >= 4
    inl = torch.where(use_H, inl_H, inl_F)
    n_good, X_all, good_all = _check_rt(cam, R_all, t_all, xy1, xy2, inl, inv_sigma2)
    n_good = torch.where(is_H == use_H, n_good, torch.full_like(n_good, -1))
    return _choose(n_good, inl, use_H, R_all, t_all, X_all, good_all, score_h, score_f,
                   min_triangulated)


def _choose(n_good, inl, use_H, R_all, t_all, X_all, good_all, score_h, score_f,
            min_triangulated: int) -> InitResult:
    best = torch.argmax(n_good)
    nb = n_good[best]
    second = torch.where(torch.arange(12, device=nb.device) == best,
                         torch.full_like(n_good, -1), n_good).max()
    n_inl = inl.sum(dtype=torch.int32)
    ok = ((nb >= min_triangulated) & (nb.to(torch.float32) > 0.5 * n_inl.to(torch.float32))
          & (0.75 * nb.to(torch.float32) > second.clamp_min(0).to(torch.float32)))
    return InitResult(ok, use_H, R_all[best], t_all[best], X_all[best], good_all[best], nb,
                      score_h, score_f)


def check_capacity(n_matches: int, device) -> None:
    """Raises when K12 cannot take `n_matches` matches on `device` (the
    plain version takes any number): the tracker calls it at set-up with
    its frames' feature capacity."""
    if torch.device(device).type == "cuda" and n_matches > TV_MAX_N:
        raise ValueError(f"{n_matches} matches: K12 takes at most {TV_MAX_N}")


def _initialize_two_view_cuda(cam, xy1, xy2, valid, sample, sigma: float,
                              min_triangulated: int) -> InitResult:
    dev, N = xy1.device, xy1.shape[0]
    H = sample.shape[0]
    chk = kernels.check
    chk(xy1, "xy1", torch.float32, (N, 2), dev)
    chk(xy2, "xy2", torch.float32, (N, 2), dev)
    chk(valid, "valid", torch.bool, (N,), dev)
    chk(sample, "sample", torch.int32, (H, N_SAMPLE), dev)
    check_capacity(N, dev)
    if H < 1:
        raise ValueError("sample: needs at least one hypothesis")
    f32 = dict(dtype=torch.float32, device=dev)
    models = torch.empty(2, H, 18, **f32)   # per model and hypothesis: M, then M^-1 (H)
    scores = torch.empty(2, H, **f32)
    score_fh = torch.empty(2, **f32)
    # ok, used_H, n_good, best candidate, the chosen model's inliers, best F and H hypotheses
    out_i = torch.empty(7, dtype=torch.int32, device=dev)
    R = torch.empty(3, 3, **f32)
    t = torch.empty(3, **f32)
    X = torch.empty(N, 3, **f32)
    good = torch.empty(N, dtype=torch.bool, device=dev)
    p = kernels.ptr
    work = kernels.workspace("two_view", dev, kernels.stream(), kernels.STAMPED_WORDS)
    kernels.launch("two_view", "two_view", p(xy1), p(xy2), p(valid), N, p(sample), H,
                   1.0 / (sigma * sigma), int(min_triangulated), float(cam.fx), float(cam.fy),
                   float(cam.cx), float(cam.cy), p(work), p(models), p(scores), p(score_fh),
                   p(out_i), p(R), p(t), p(X), p(good))
    return InitResult(out_i[0] != 0, out_i[1] != 0, R, t, X, good, out_i[2], score_fh[1],
                      score_fh[0])


def initialize_two_view(cam, xy1, xy2, valid, generator: Optional[torch.Generator] = None,
                        sample: Optional[torch.Tensor] = None, sigma: float = 1.0,
                        min_triangulated: int = 50) -> InitResult:
    """Two-view initialization from matched pixels xy1, xy2 [N, 2] (valid
    [N]): K12 on CUDA tensors, the plain version on CPU tensors. `sample`
    [256, 8] i32 (indices into the matches) overrides the draw from
    `generator`."""
    if sample is None:
        sample = sample_indices(valid, N_HYP, N_SAMPLE, generator)
    if xy1.is_cuda:
        return _initialize_two_view_cuda(cam, xy1, xy2, valid, sample, sigma, min_triangulated)
    if xy1.device.type == "cpu":
        return initialize_two_view_plain(cam, xy1, xy2, valid, sample, sigma, min_triangulated)
    raise ValueError(f"unsupported device {xy1.device}")
