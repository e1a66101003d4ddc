"""Batched Horn similarity alignment, Sim3 RANSAC and its iterative
refinement (port of `corbslam_tpu/solvers/sim3_solver.py`: `horn_sim3`,
`_sim3_chi2`, `refine_sim3_iterative`, `solve_sim3_ransac`).

Every hypothesis is Horn's closed form on three correspondences: the
largest eigenvector of the 4x4 N matrix by 100 shifted power iterations
(Gershgorin shift), then the inlier count in both cameras. The sampling is
an input: `idx` [H, 3], drawn from `valid` with a `torch.Generator` when the
caller passes none (the reference's `jax.random.choice` cannot be
reproduced, so the tests hand both packages the same index array).

On CUDA tensors the hypotheses, the choice of the best (first maximum),
the refinement and `compute_sim3`'s combine of the two run on kernel K10
(`csrc/ransac.cu`), one launch an attempt (`solve_and_refine_sim3`), or the
RANSAC or the refinement alone (`solve_sim3_ransac`,
`refine_sim3_iterative`) on the same kernel; on CPU tensors the plain
versions below. `horn_sim3` on one weighted set of pairs (the server's
sub-map alignment) is K10's weighted-Horn launch on CUDA tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..geometry import camera as cam_mod
from ..geometry import se3, sim3
from ..optim.smallmat import chol_solve_factored, chol_unrolled

CHI2_SIM3 = 9.21  # Sim3Solver::CheckInliers gate (x octave sigma^2)
SIM3_RANSAC, SIM3_REFINE = 1, 2  # the kernel's mode bits
SIM3_MAX_N = 4096  # the kernel keeps 8 floats of every match in one CTA's shared memory


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor   # [N] bool
    n_inliers: torch.Tensor  # 0-dim i32
    ok: torch.Tensor         # 0-dim bool


class Sim3Attempt(NamedTuple):
    ransac: Sim3RansacResult
    refined: tuple           # (R, t, s, inliers [N], n_inliers) of refine_sim3_iterative
    R: torch.Tensor          # the combine: the refined model where both counts reach 3
    t: torch.Tensor
    s: torch.Tensor
    n_inliers: torch.Tensor  # 0-dim i32


def sample_indices(valid: torch.Tensor, n_hyp: int, k: int,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[n_hyp, k] i32 indices drawn with replacement, uniformly over the
    valid entries (over all entries when none is valid), without a host sync."""
    probs = valid.to(torch.float32)
    probs = probs + (probs.sum() == 0).to(torch.float32)
    idx = torch.multinomial(probs, n_hyp * k, replacement=True, generator=generator)
    return idx.view(n_hyp, k).to(torch.int32)


def horn_sim3_batched(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False,
                      w: Optional[torch.Tensor] = None):
    """Closed-form similarity p1 ~ s R p2 + t from matched sets [..., K, 3],
    batched over the leading dims in PyTorch (the RANSAC's plain version
    solves its hypotheses with it)."""
    if w is None:
        w = torch.ones(p1.shape[:-1], dtype=p1.dtype, device=p1.device)
    wn = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    c1 = (p1 * wn[..., None]).sum(dim=-2, keepdim=True)
    c2 = (p2 * wn[..., None]).sum(dim=-2, keepdim=True)
    q1 = (p1 - c1) * torch.sqrt(wn)[..., None]
    q2 = (p2 - c2) * torch.sqrt(wn)[..., None]
    M = q2.transpose(-1, -2) @ q1
    S = [[M[..., i, j] for j in range(3)] for i in range(3)]
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = S
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    diag = torch.diagonal(N, dim1=-2, dim2=-1)
    radius = N.abs().sum(dim=-1) - diag.abs()
    shift = (-(diag - radius).min(dim=-1).values).clamp_min(0.0)
    Ns = N + shift[..., None, None] * torch.eye(4, dtype=N.dtype, device=N.device)
    v = torch.ones(N.shape[:-1], dtype=N.dtype, device=N.device)
    for _ in range(100):
        v = (Ns @ v[..., None])[..., 0]
        v = v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
    R = se3.R_from_quat(v)
    q2r = q2 @ R.transpose(-1, -2)
    if fix_scale:
        s = torch.ones(p1.shape[:-2], dtype=p1.dtype, device=p1.device)
    else:
        s = (q1 * q2r).sum(dim=(-1, -2)) / (q2r * q2r).sum(dim=(-1, -2)).clamp_min(1e-12)
    t = c1[..., 0, :] - s[..., None] * (R @ c2[..., 0, :, None])[..., 0]
    return R, t, s


HORN_THREADS = 256  # the weighted-Horn kernel's CTA: its sums' order
HORN_REG = 8        # pairs a kernel thread keeps in registers (its partials add their zeros)


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """[K, C] -> [C], summed in the weighted-Horn kernel's order: partial i
    of 256 adds rows i, i + 256, ... in turn from 0 (zeros past K among its
    HORN_REG registers), each warp halves its 32 partials to one (shfl_down),
    and the 8 warp sums are halved to one (w0 + w4, ..., then + 2, + 1)."""
    T = HORN_THREADS
    K, C = x.shape
    n = max(-(-K // T), HORN_REG)
    xs = torch.cat([x, x.new_zeros(n * T - K, C)]).view(n, T, C)
    acc = x.new_zeros(T, C)
    for r in range(n):
        acc = acc + xs[r]
    acc = acc.view(T // 32, 32, C)
    st = 16
    while st >= 1:
        acc = acc[:, :st] + acc[:, st:2 * st]
        st //= 2
    acc = acc[:, 0]
    st = T // 64
    while st >= 1:
        acc = acc[:st] + acc[st:2 * st]
        st //= 2
    return acc[0]


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """(a0 + a1) + a2 along the last axis."""
    return (a[..., 0] + a[..., 1]) + a[..., 2]


def _scale4(C: torch.Tensor) -> torch.Tensor:
    """4x4 C scaled exactly by the power of 2 that puts its largest diagonal
    entry in [1, 2) (the kernel's `horn_scale`)."""
    ex = int(torch.frexp(torch.diagonal(C).max())[1])
    return C * torch.tensor(2.0 ** min(max(1 - ex, -126), 126), dtype=C.dtype, device=C.device)


def _product4(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """4x4 A B, each entry's 4 terms added in k order, then `_scale4` (the
    kernel's squaring step)."""
    return _scale4(((A[:, 0:1] * B[0:1, :] + A[:, 1:2] * B[1:2, :]) + A[:, 2:3] * B[2:3, :])
                   + A[:, 3:4] * B[3:4, :])


def _matvec4(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return ((A[:, 0] * u[0] + A[:, 1] * u[1]) + A[:, 2] * u[2]) + A[:, 3] * u[3]


def horn_power_tail(Ns: torch.Tensor) -> torch.Tensor:
    """The reference's 100 shifted power iterations from the ones vector,
    v = Ns^100 1 / |Ns^100 1|, as the weighted-Horn kernel computes it: Ns
    scaled (`_scale4`, so no product overflows) and squared 6 times
    (`_product4`), u = Ns^64 (Ns^32 (Ns^4 1)), normalized (1e-12 clamp:
    Ns = 0 gives v = 0)."""
    A, u = _scale4(Ns), torch.ones(4, dtype=Ns.dtype, device=Ns.device)
    for s in range(1, 7):
        A = _product4(A, A)
        if s in (2, 5, 6):
            u = _matvec4(A, u)
    uu = u * u
    return u / torch.sqrt(((uu[0] + uu[1]) + uu[2]) + uu[3]).clamp_min(1e-12)


def horn_weighted_plain(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor,
                        fix_scale: bool = False):
    """Plain version of the weighted-Horn kernel: `horn_sim3` on one set of
    K pairs with weights w [K], every sum over the pairs in the kernel's
    order (`_block_sum`), every other sum left to right, and the power
    iteration by the kernel's squaring (`horn_power_tail`)."""
    den = _block_sum(w[:, None])[0].clamp_min(1e-12)
    wn = w / den
    c = _block_sum(torch.cat([p1 * wn[:, None], p2 * wn[:, None]], dim=1))
    c1, c2 = c[:3], c[3:]
    sw = torch.sqrt(wn)[:, None]
    q1, q2 = (p1 - c1) * sw, (p2 - c2) * sw
    M = _block_sum((q2[:, :, None] * q1[:, None, :]).reshape(-1, 9)).view(3, 3)
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = M
    N = torch.stack([
        torch.stack([(Sxx + Syy) + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx]),
        torch.stack([Syz - Szy, (Sxx - Syy) - Szz, Sxy + Syx, Szx + Sxz]),
        torch.stack([Szx - Sxz, Sxy + Syx, (-Sxx + Syy) - Szz, Syz + Szy]),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, (-Sxx - Syy) + Szz]),
    ])
    a = N.abs()
    diag = torch.diagonal(N)
    g = diag - (((a[:, 0] + a[:, 1]) + a[:, 2]) + a[:, 3] - diag.abs())
    Ns = N + g.min().neg().clamp_min(0.0) * torch.eye(4, dtype=N.dtype, device=N.device)
    R = se3.R_from_quat(horn_power_tail(Ns))
    if fix_scale:
        s = torch.ones((), dtype=p1.dtype, device=p1.device)
    else:
        r = _sum3(R[None] * q2[:, None, :])                  # [K, 3] = R q2
        sums = _block_sum(torch.stack([_sum3(q1 * r), _sum3(r * r)], dim=1))
        s = sums[0] / sums[1].clamp_min(1e-12)
    t = c1 - s * _sum3(R * c2)
    return R, t, s


def horn_sim3(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool = False,
              w: Optional[torch.Tensor] = None):
    """Closed-form similarity p1 ~ s R p2 + t from matched sets [..., K, 3],
    optionally weighted by w [..., K]. One set of pairs ([K, 3], the
    server's alignment) runs on the weighted-Horn kernel of K10 on CUDA
    tensors (one launch, counted as "horn") and on `horn_weighted_plain` on
    CPU tensors; batched sets on `horn_sim3_batched`."""
    if p1.dim() != 2:
        if p1.is_cuda:
            raise ValueError("horn_sim3: the kernel takes one set of pairs [K, 3]")
        return horn_sim3_batched(p1, p2, fix_scale, w)
    K = p1.shape[0]
    if w is None:
        w = torch.ones(K, dtype=p1.dtype, device=p1.device)
    if not p1.is_cuda:
        if p1.device.type != "cpu":
            raise ValueError(f"unsupported device {p1.device}")
        return horn_weighted_plain(p1, p2, w, fix_scale)
    dev = p1.device
    for name, t, shape in (("p1", p1, (K, 3)), ("p2", p2, (K, 3)), ("w", w, (K,))):
        kernels.check(t, name, torch.float32, shape, dev)
    out = torch.empty(13, dtype=torch.float32, device=dev)
    work = kernels.workspace("horn", dev, kernels.stream(), kernels.STAMPED_WORDS)
    kernels.launch("horn", "horn_weighted", kernels.ptr(p1), kernels.ptr(p2), kernels.ptr(w), K,
                   int(bool(fix_scale)), kernels.ptr(out), kernels.ptr(work))
    return out[:9].view(3, 3), out[9:12], out[12]


def _sim3_chi2(cam1, cam2, p1_cam, p2_cam, R, t, s):
    """Per-correspondence squared reprojection error of a Sim3 in both
    cameras, and the cheirality mask. R, t, s may carry a leading batch."""
    p2_in1 = s[..., None, None] * (p2_cam @ R.transpose(-1, -2)) + t[..., None, :]
    s_inv = 1.0 / s.clamp_min(1e-12)
    p1_in2 = s_inv[..., None, None] * ((p1_cam - t[..., None, :]) @ R)
    e1 = ((cam_mod.project(cam1, p2_in1) - cam_mod.project(cam1, p1_cam)) ** 2).sum(dim=-1)
    e2 = ((cam_mod.project(cam2, p1_in2) - cam_mod.project(cam2, p2_cam)) ** 2).sum(dim=-1)
    return e1, e2, (p2_in1[..., 2] > 0) & (p1_in2[..., 2] > 0)


def _inliers(cam1, cam2, p1, p2, valid, s2_1, s2_2, R, t, s):
    e1, e2, pos = _sim3_chi2(cam1, cam2, p1, p2, R, t, s)
    return (e1 < CHI2_SIM3 * s2_1) & (e2 < CHI2_SIM3 * s2_2) & valid & pos


def solve_sim3_ransac_plain(cam1, cam2, p1, p2, valid, s2_1, s2_2, idx, min_inliers: int = 20,
                            fix_scale: bool = False) -> Sim3RansacResult:
    i = idx.long()
    R, t, s = horn_sim3_batched(p1[i], p2[i], fix_scale)
    inl = _inliers(cam1, cam2, p1, p2, valid, s2_1, s2_2, R, t, s)
    counts = inl.sum(dim=1, dtype=torch.int32)
    best = torch.argmax(counts)
    n_in = counts[best]
    return Sim3RansacResult(R[best], t[best], s[best], inl[best], n_in, n_in >= min_inliers)


def _cams(cam1, cam2):
    return (float(cam1.fx), float(cam1.fy), float(cam1.cx), float(cam1.cy),
            float(cam2.fx), float(cam2.fy), float(cam2.cx), float(cam2.cy))


def _check_matches(p1, p2, valid, s2_1, s2_2, idx=None) -> None:
    """Device (p1's), dtype and shape of a Sim3 call's matches and draw."""
    dev, N = p1.device, p1.shape[0]
    for name, t, dt, shape in (("p1", p1, torch.float32, (N, 3)), ("p2", p2, torch.float32, (N, 3)),
                               ("valid", valid, torch.bool, (N,)),
                               ("s2_1", s2_1, torch.float32, (N,)),
                               ("s2_2", s2_2, torch.float32, (N,))):
        kernels.check(t, name, dt, shape, dev)
    if idx is not None:
        kernels.check(idx, "idx", torch.int32, (idx.shape[0], 3), dev)


def check_capacity(n_matches: int, device) -> None:
    """Raises when K10's Sim3 kernel cannot take `n_matches` matches on
    `device` (the plain version takes any number): the loop closer calls it
    at set-up with the keyframes' feature capacity."""
    if torch.device(device).type == "cuda" and n_matches > SIM3_MAX_N:
        raise ValueError(f"{n_matches} matches: K10's Sim3 kernel takes at most {SIM3_MAX_N}")


def solve_sim3_ransac(cam1, cam2, p1, p2, valid, s2_1, s2_2,
                      generator: Optional[torch.Generator] = None, n_hyp: int = 128,
                      min_inliers: int = 20, fix_scale: bool = False,
                      idx: Optional[torch.Tensor] = None) -> Sim3RansacResult:
    """All RANSAC hypotheses at once; the best is the first maximum of the
    inlier count (Sim3Solver::CheckInliers gate 9.21 sigma^2 in both
    cameras). `idx` [n_hyp, 3] overrides the draw."""
    if idx is None:
        idx = sample_indices(valid, n_hyp, 3, generator)
    if not p1.is_cuda:
        if p1.device.type != "cpu":
            raise ValueError(f"unsupported device {p1.device}")
        return solve_sim3_ransac_plain(cam1, cam2, p1, p2, valid, s2_1, s2_2, idx, min_inliers,
                                       fix_scale)
    _check_matches(p1, p2, valid, s2_1, s2_2, idx)
    return _sim3_cuda(SIM3_RANSAC, cam1, cam2, p1, p2, valid, s2_1, s2_2, idx=idx,
                      min_inliers=min_inliers, fix_scale=fix_scale)[0]


def _proj_diff(cam, q):
    """[N, 2, 3] differential of the pinhole projection at q."""
    z = q[..., 2].clamp_min(1e-3)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(z)
    return torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * q[..., 0] * inv_z2], -1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * q[..., 1] * inv_z2], -1),
    ], dim=-2)


def _action_cols(p):
    """[N, 3, 7] d(exp(xi) p)/dxi for xi = (rho, phi, sigma): [I | -hat(p) | p]."""
    I = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    return torch.cat([I, -se3.hat(p), p[:, :, None]], dim=-1)


def refine_sim3_iterative_plain(cam1, cam2, p1, p2, valid, s2_1, s2_2, R0, t0, s0,
                                fix_scale: bool = False, n_rounds: int = 3):
    uv1_obs = cam_mod.project(cam1, p1)
    uv2_obs = cam_mod.project(cam2, p2)
    v_f = valid.to(torch.float32)
    inv1 = 1.0 / s2_1.clamp_min(1e-9)
    inv2 = 1.0 / s2_2.clamp_min(1e-9)

    def hub(c):
        return torch.where(c > CHI2_SIM3, torch.sqrt(CHI2_SIM3 / c.clamp_min(1e-9)),
                           torch.ones_like(c))

    R, t, s = R0, t0, s0
    mask = torch.arange(7, device=p1.device) < 6
    for _ in range(n_rounds):
        q = s * (p2 @ R.T) + t
        s_inv = 1.0 / s.clamp_min(1e-12)
        pp = s_inv * ((p1 - t) @ R)
        r1 = cam_mod.project(cam1, q) - uv1_obs
        r2 = cam_mod.project(cam2, pp) - uv2_obs
        c1 = (r1 * r1).sum(-1) * inv1
        c2 = (r2 * r2).sum(-1) * inv2
        w1 = v_f * (q[..., 2] > 1e-3) * hub(c1) * inv1
        w2 = v_f * (pp[..., 2] > 1e-3) * hub(c2) * inv2
        J1 = _proj_diff(cam1, q) @ _action_cols(q)
        J2 = _proj_diff(cam2, pp) @ (-s_inv * (R.T @ _action_cols(p1)))
        H = (torch.einsum("nik,n,nil->kl", J1, w1, J1)
             + torch.einsum("nik,n,nil->kl", J2, w2, J2))
        g = torch.einsum("nik,n,ni->k", J1, w1, r1) + torch.einsum("nik,n,ni->k", J2, w2, r2)
        if fix_scale:
            H = torch.where(mask[:, None] & mask[None, :], H, torch.zeros_like(H))
            g = torch.where(mask, g, torch.zeros_like(g))
        H = H + (1e-4 * torch.diagonal(H) + 1e-8) * torch.eye(7, device=H.device)
        dx = -chol_solve_factored(chol_unrolled(H, 7), g, 7)
        Rn, tn, sn = sim3.retract((R, t, s), dx)
        ok = torch.isfinite(dx).all() & (v_f.sum() >= 3)
        R, t, s = torch.where(ok, Rn, R), torch.where(ok, tn, t), torch.where(ok, sn, s)
    inl = _inliers(cam1, cam2, p1, p2, valid, s2_1, s2_2, R, t, s)
    inl0 = _inliers(cam1, cam2, p1, p2, valid, s2_1, s2_2, R0, t0, s0)
    better = inl.sum() >= inl0.sum()
    R, t, s = torch.where(better, R, R0), torch.where(better, t, t0), torch.where(better, s, s0)
    inl = torch.where(better, inl, inl0)
    return R, t, s, inl, inl.sum(dtype=torch.int32)


def refine_sim3_iterative(cam1, cam2, p1, p2, valid, s2_1, s2_2, R0, t0, s0,
                          fix_scale: bool = False, n_rounds: int = 3):
    """Damped Gauss-Newton rounds on the Sim3 manifold over the Huber
    reprojection error in both cameras, every correspondence re-weighted
    each round (the role of Optimizer::OptimizeSim3); the refined model is
    kept only if it classifies at least as many inliers. Returns (R, t, s,
    inliers [N], n_inliers). One CTA of K10's `sim3_attempt` on CUDA tensors."""
    if not p1.is_cuda:
        if p1.device.type != "cpu":
            raise ValueError(f"unsupported device {p1.device}")
        return refine_sim3_iterative_plain(cam1, cam2, p1, p2, valid, s2_1, s2_2, R0, t0, s0,
                                           fix_scale, n_rounds)
    _check_matches(p1, p2, valid, s2_1, s2_2)
    return _sim3_cuda(SIM3_REFINE, cam1, cam2, p1, p2, valid, s2_1, s2_2, R0=R0, t0=t0, s0=s0,
                      fix_scale=fix_scale, n_rounds=n_rounds)[1]


def combine_sim3(ransac: Sim3RansacResult, refined: tuple) -> tuple:
    """`compute_sim3`'s choice: the refined model (and the larger count)
    where the RANSAC's and the refinement's counts both reach 3, else the
    RANSAC's. Returns (R, t, s, n_inliers)."""
    use = (ransac.n_inliers >= 3) & (refined[4] >= 3)
    return (torch.where(use, refined[0], ransac.R), torch.where(use, refined[1], ransac.t),
            torch.where(use, refined[2], ransac.s),
            torch.where(use, torch.maximum(refined[4], ransac.n_inliers), ransac.n_inliers))


def solve_and_refine_sim3_plain(cam1, cam2, p1, p2, valid, s2_1, s2_2, idx,
                                min_inliers: int = 20, fix_scale: bool = False,
                                n_rounds: int = 3) -> Sim3Attempt:
    r = solve_sim3_ransac_plain(cam1, cam2, p1, p2, valid, s2_1, s2_2, idx, min_inliers,
                                fix_scale)
    f = refine_sim3_iterative_plain(cam1, cam2, p1, p2, valid, s2_1, s2_2, r.R, r.t, r.s,
                                    fix_scale, n_rounds)
    return Sim3Attempt(r, f, *combine_sim3(r, f))


def solve_and_refine_sim3(cam1, cam2, p1, p2, valid, s2_1, s2_2,
                          generator: Optional[torch.Generator] = None, n_hyp: int = 128,
                          min_inliers: int = 20, fix_scale: bool = False,
                          idx: Optional[torch.Tensor] = None, n_rounds: int = 3) -> Sim3Attempt:
    """One Sim3 attempt of `loop_closing.compute_sim3`: the RANSAC
    (`solve_sim3_ransac`, `idx` [n_hyp, 3] overriding the draw), the
    refinement from its model (`refine_sim3_iterative`) and their combine
    (`combine_sim3`). One launch of K10 on CUDA tensors, the plain versions
    in sequence on CPU tensors."""
    if not p1.is_cuda and p1.device.type != "cpu":
        raise ValueError(f"unsupported device {p1.device}")
    if idx is None:
        idx = sample_indices(valid, n_hyp, 3, generator)
    _check_matches(p1, p2, valid, s2_1, s2_2, idx)
    if not p1.is_cuda:
        return solve_and_refine_sim3_plain(cam1, cam2, p1, p2, valid, s2_1, s2_2, idx,
                                           min_inliers, fix_scale, n_rounds)
    ransac, refined, combined = _sim3_cuda(
        SIM3_RANSAC | SIM3_REFINE, cam1, cam2, p1, p2, valid, s2_1, s2_2, idx=idx,
        min_inliers=min_inliers, fix_scale=fix_scale, n_rounds=n_rounds)
    return Sim3Attempt(ransac, refined, *combined)


def _sim3_cuda(mode: int, cam1, cam2, p1, p2, valid, s2_1, s2_2, idx=None, R0=None, t0=None,
               s0=None, min_inliers: int = 20, fix_scale: bool = False, n_rounds: int = 3):
    """One launch of K10's `sim3_attempt` in `mode`: ((R, t, s, inliers,
    n_inliers, ok) of the RANSAC, (R, t, s, inliers, n_inliers) of the
    refinement, (R, t, s, n_inliers) of their combine); only the parts that
    the mode computes are written. The caller has checked the matches
    and the draw (`_check_matches`)."""
    dev, N = p1.device, p1.shape[0]
    check_capacity(N, dev)
    p = kernels.ptr
    H = 0
    if mode & SIM3_RANSAC:
        H = idx.shape[0]
        if H < 1:
            raise ValueError("idx: needs at least one hypothesis")
        start = (p(idx), H, 0, 0, 0)
    else:
        R0, t0, s0 = R0.contiguous(), t0.contiguous(), s0.contiguous()
        kernels.check(R0, "R0", torch.float32, (3, 3), dev)
        kernels.check(t0, "t0", torch.float32, (3,), dev)
        kernels.check(s0, "s0", torch.float32, (), dev)
        start = (0, 0, p(R0), p(t0), p(s0))
    f32 = dict(dtype=torch.float32, device=dev)
    out_f = torch.empty(3, 13, **f32)
    out_i = torch.empty(3, dtype=torch.int32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    inl_r = torch.empty(N, dtype=torch.bool, device=dev)
    inl_f = torch.empty(N, dtype=torch.bool, device=dev)
    models = torch.empty(max(H, 1), 13, **f32)
    work = kernels.workspace("sim3", dev, kernels.stream())
    kernels.launch("sim3", "sim3_attempt", p(p1), p(p2), p(valid), p(s2_1), p(s2_2), N, *start,
                   mode, int(fix_scale), int(n_rounds), int(min_inliers), *_cams(cam1, cam2),
                   p(work), p(models), p(out_f), p(out_i), p(ok), p(inl_r), p(inl_f))

    def model(i):
        return out_f[i, :9].view(3, 3), out_f[i, 9:12], out_f[i, 12]

    return (Sim3RansacResult(*model(0), inl_r, out_i[0], ok), (*model(1), inl_f, out_i[1]),
            (*model(2), out_i[2]))
