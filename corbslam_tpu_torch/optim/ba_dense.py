"""Dense-plane bundle adjustment: Schur-complement PCG Levenberg-Marquardt
over [C, Fb] observation planes (port of `corbslam_tpu/optim/ba_dense.py`:
`BADense`, `build_point_major`, `_linearize`, `lm_step_dense` single-device,
`optimize` / `optimize_core`, `_inv_sigma2_of` as `inv_sigma2_of`,
`problem_from_window`, and global BA's `compact_rows`, `problem_from_map`,
`slice_problem`, `round_up`).

Every per-observation quantity is a plane [C, Fb] (camera slot x feature
slot): camera sums are row reductions, point sums gather through the
point-major table `pm_src` / `pm_ok` ([P, K] flat observation indices).
Each LM iteration linearizes, factors the damped 3x3 point blocks,
preconditions the reduced camera system with the damped 6x6 camera blocks,
solves it by warm-started PCG in residual space (exit on `cg_tol`),
back-substitutes the points, retracts the poses and keeps the step only if
the (robust) cost dropped; after the last robust iteration the observations
are re-classified by their chi2. Same semantics as the reference's g2o
SE3 + XYZ BA with Huber kernels (Optimizer.cc:487, 711-758).

`optimize` and `build_point_major` are the wrappers of kernel K8
(`csrc/ba_dense.cu`): CUDA tensors launch it, CPU tensors take the plain
versions below; `counter` names the launch count they add to (global BA
counts its own).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..geometry import se3
from . import reproj
from .smallmat import chol_solve_factored, chol_unrolled, inv_spd_unrolled

CG_TOL = 0.03


class BADense(NamedTuple):
    """BA problem in dense plane layout: C camera slots x Fb observation
    slots; inactive slots are masked by `obs_active` (their obs_mp must still
    be a valid point row in [0, P))."""

    Tcw: torch.Tensor             # [C, 4, 4]
    pose_fixed: torch.Tensor      # [C] bool
    X: torch.Tensor               # [P, 3]
    point_fixed: torch.Tensor     # [P] bool
    obs_mp: torch.Tensor          # [C, Fb] i32 point row
    obs_uvr: torch.Tensor         # [3, C, Fb] measured u, v, u_right
    obs_inv_sigma2: torch.Tensor  # [C, Fb]
    obs_stereo: torch.Tensor      # [C, Fb] bool
    obs_active: torch.Tensor      # [C, Fb] bool
    pm_src: torch.Tensor | None = None  # [P, K] i32 flat observation index c * Fb + f
    pm_ok: torch.Tensor | None = None   # [P, K] bool


class BADenseResult(NamedTuple):
    Tcw: torch.Tensor     # [C, 4, 4] orthonormalized
    X: torch.Tensor       # [P, 3]
    inlier: torch.Tensor  # [C, Fb] final chi2 classification of obs_active
    cost: torch.Tensor    # 0-dim: chi2 summed over the final active set
    # [n_iters, 2] i32 (CG iterations, step accepted) per LM iteration; not
    # part of the reference's result, kept for comparing runs.
    trace: torch.Tensor | None = None


# ---------------------------------------------------------------------------
# The point-major gather table
# ---------------------------------------------------------------------------

def build_point_major_plain(obs_mp: torch.Tensor, obs_active: torch.Tensor, P: int, K: int):
    """Plain version: stable argsort of the point ids (inactive slots keyed
    P), searchsorted segment bounds, the first K observations of a point or,
    past K, an even stride over its whole span. Returns (pm_src [P, K] i32,
    pm_ok [P, K], active' [C, Fb]) where active' drops the observations the
    table does not hold."""
    C, Fb = obs_mp.shape
    O = C * Fb
    dev = obs_mp.device
    ids = torch.where(obs_active, obs_mp, torch.full_like(obs_mp, P)).reshape(-1).long()
    sorted_ids, order = torch.sort(ids, stable=True)
    pts = torch.arange(P, dtype=torch.long, device=dev)
    start = torch.searchsorted(sorted_ids, pts)
    count = torch.searchsorted(sorted_ids, pts + 1) - start
    k = torch.arange(K, dtype=torch.long, device=dev)
    off = torch.where((count > K)[:, None], (k[None, :] * count[:, None]) // K,
                      k[None, :].expand(P, K))
    pm_ok = off < count[:, None]
    pm_src = order[(start[:, None] + off).clamp(0, O - 1)].to(torch.int32)
    keep = torch.zeros(O + 1, dtype=torch.bool, device=dev)
    keep[torch.where(pm_ok, pm_src.long(), torch.full_like(off, O)).reshape(-1)] = True
    return pm_src, pm_ok, obs_active & keep[:O].reshape(C, Fb)


def _build_point_major_cuda(obs_mp, obs_active, P: int, K: int, counter: str):
    C, Fb = obs_mp.shape
    dev = obs_mp.device
    kernels.check(obs_mp, "obs_mp", torch.int32, (C, Fb), dev)
    kernels.check(obs_active, "obs_active", torch.bool, (C, Fb), dev)
    O = C * Fb
    work = torch.empty(3 * P + O, dtype=torch.int32, device=dev)
    pm_src = torch.empty(P, K, dtype=torch.int32, device=dev)
    pm_ok = torch.empty(P, K, dtype=torch.bool, device=dev)
    active = torch.empty(C, Fb, dtype=torch.bool, device=dev)
    p = kernels.ptr
    kernels.launch(counter, "ba_point_major", p(obs_mp), p(obs_active), C, Fb, P, K, p(work),
                   p(pm_src), p(pm_ok), p(active))
    return pm_src, pm_ok, active


def build_point_major(obs_mp: torch.Tensor, obs_active: torch.Tensor, P: int, K: int,
                      counter: str = "ba_dense"):
    """Point-major gather table of a problem (K8 on CUDA tensors, the plain
    version on CPU tensors). Active observation ids must lie in [0, P)."""
    if obs_mp.is_cuda:
        return _build_point_major_cuda(obs_mp, obs_active, P, K, counter)
    if obs_mp.device.type == "cpu":
        return build_point_major_plain(obs_mp, obs_active, P, K)
    raise ValueError(f"unsupported device {obs_mp.device}")


# ---------------------------------------------------------------------------
# The LM loop (plain version of K8)
# ---------------------------------------------------------------------------

class _Lin(NamedTuple):
    r: list           # 3 x [C, F] residual planes
    Jc: list          # 3 x 6 x [C, F] pose-Jacobian planes
    Jp: list          # 3 x 3 x [C, F] point-Jacobian planes
    w3: list          # 3 x [C, F] row weights (third row 0 for mono)
    depth_ok: torch.Tensor


def _linearize(cam, p: BADense) -> _Lin:
    """Residual and Jacobian planes at the current state: J_pose =
    -A [I | -hat(p)], J_point = -A R, A the projection differential."""
    R = p.Tcw[:, :3, :3]
    t = p.Tcw[:, :3, 3]
    Xg = p.X[p.obs_mp.long()]
    Xs = [Xg[..., j] for j in range(3)]
    x, y, z = (R[:, i, 0, None] * Xs[0] + R[:, i, 1, None] * Xs[1] + R[:, i, 2, None] * Xs[2]
               + t[:, i, None] for i in range(3))
    depth_ok = z > 1e-3
    inv_z = 1.0 / torch.where(depth_ok, z, torch.ones_like(z))
    inv_z2 = inv_z * inv_z
    fx, fy, bf = cam.fx, cam.fy, cam.bf
    u = fx * x * inv_z + cam.cx
    v = fy * y * inv_z + cam.cy
    ur = u - bf * inv_z
    r = [p.obs_uvr[0] - u, p.obs_uvr[1] - v, p.obs_uvr[2] - ur]
    a0 = fx * inv_z
    a2 = -fx * x * inv_z2
    b1 = fy * inv_z
    b2 = -fy * y * inv_z2
    c2 = a2 + bf * inv_z2
    zero = torch.zeros_like(x)
    Jc = [
        [-a0, zero, -a2, -(a2 * y), -(a0 * z - a2 * x), a0 * y],
        [zero, -b1, -b2, -(-b1 * z + b2 * y), b2 * x, -(b1 * x)],
        [-a0, zero, -c2, -(c2 * y), -(a0 * z - c2 * x), a0 * y],
    ]
    Rr = [[R[:, i, j, None] for j in range(3)] for i in range(3)]
    Jp = [
        [-(a0 * Rr[0][j] + a2 * Rr[2][j]) for j in range(3)],
        [-(b1 * Rr[1][j] + b2 * Rr[2][j]) for j in range(3)],
        [-(a0 * Rr[0][j] + c2 * Rr[2][j]) for j in range(3)],
    ]
    wb = p.obs_inv_sigma2 * depth_ok
    w3 = [wb, wb, torch.where(p.obs_stereo, wb, torch.zeros_like(wb))]
    return _Lin(r, Jc, Jp, w3, depth_ok)


def _chi2(lin: _Lin) -> torch.Tensor:
    return lin.r[0] * lin.r[0] * lin.w3[0] + lin.r[1] * lin.r[1] * lin.w3[1] \
        + lin.r[2] * lin.r[2] * lin.w3[2]


def lm_step_dense(cam, p: BADense, active, lam, use_huber: bool, cg_iters: int, x0=None,
                  cg_tol: float = CG_TOL):
    """One LM iteration; returns the proposed (Tcw, X), the chi2 plane at the
    current state, delta2, the camera step dc and the CG iteration count."""
    C, P = p.Tcw.shape[0], p.X.shape[0]
    lin = _linearize(cam, p)
    c2 = _chi2(lin)
    delta2 = reproj.chi2_threshold(p.obs_stereo)
    rw = reproj.huber_weights(c2, delta2) if use_huber else torch.ones_like(c2)
    act_f = active.to(torch.float32)
    Jc, Jp, r = lin.Jc, lin.Jp, lin.r
    w = [lin.w3[i] * (rw * act_f) for i in range(3)]
    Jc_w = [[Jc[i][j] * w[i] for j in range(6)] for i in range(3)]
    Jp_w = [[Jp[i][j] * w[i] for j in range(3)] for i in range(3)]
    free_c = (~p.pose_fixed).to(torch.float32)[:, None]
    free_p = (~p.point_fixed).to(torch.float32)[:, None]
    # Slots that are not ok may index past a sliced problem's C x Fb (global
    # BA cuts the cameras): clamped, as the reference's gather clamps.
    src, ok = p.pm_src.long().clamp(0, p.obs_mp.numel() - 1), p.pm_ok

    def seg_multi(vals):
        """list of [C, F] planes -> [P, len(vals)] summed per point through
        the point-major table."""
        flat = torch.stack([v.reshape(-1) for v in vals], 0)
        g = torch.where(ok[None], flat[:, src], torch.zeros((), device=flat.device))
        return g.sum(dim=-1).T

    sym = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    hp = seg_multi([sum(Jp_w[rr][i] * Jp[rr][j] for rr in range(3)) for i, j in sym])
    e = {s: hp[:, k] for k, s in enumerate(sym)}
    Hpp = torch.stack([torch.stack([e[(min(i, j), max(i, j))] for j in range(3)], -1)
                       for i in range(3)], -2)
    hcc = [[None] * 6 for _ in range(6)]
    for i in range(6):
        for j in range(i, 6):
            hcc[i][j] = sum((Jc_w[rr][i] * Jc[rr][j]).sum(dim=-1) for rr in range(3))
            hcc[j][i] = hcc[i][j]
    Hcc = torch.stack([torch.stack([hcc[i][j] for j in range(6)], -1) for i in range(6)], -2)
    hpp_diag = torch.stack([e[(i, i)] for i in range(3)], -1)
    hcc_diag = torch.stack([hcc[i][i] for i in range(6)], -1)
    eye3 = torch.eye(3, dtype=torch.float32, device=Hpp.device)
    eye6 = torch.eye(6, dtype=torch.float32, device=Hpp.device)
    Lpp = chol_unrolled(Hpp + (lam * hpp_diag + 1e-6)[..., None] * eye3, 3)

    def point_solve(yv):
        return chol_solve_factored(Lpp, yv, 3) * free_p

    def jc_dot(vc):
        return [sum(Jc[rr][j] * vc[:, j, None] for j in range(6)) for rr in range(3)]

    def jp_dot(zp):
        zg = zp[p.obs_mp.long()]
        return [sum(Jp[rr][j] * zg[..., j] for j in range(3)) for rr in range(3)]

    def jcw_T(m3):
        return torch.stack([sum((Jc_w[rr][j] * m3[rr]).sum(dim=-1) for rr in range(3))
                            for j in range(6)], -1)

    def schur_mv(vc):
        vc = vc * free_c
        a = jc_dot(vc)
        zp = point_solve(seg_multi([sum(Jp_w[rr][i] * a[rr] for rr in range(3))
                                    for i in range(3)]))
        jz = jp_dot(zp)
        Sv = jcw_T([a[rr] - jz[rr] for rr in range(3)]) + (lam * hcc_diag + 1e-8) * vc
        return Sv * free_c

    gp = seg_multi([sum(Jp_w[rr][i] * r[rr] for rr in range(3)) for i in range(3)])
    jzg = jp_dot(point_solve(gp))
    b = -jcw_T([r[rr] - jzg[rr] for rr in range(3)]) * free_c
    Minv = inv_spd_unrolled(Hcc + (lam * hcc_diag + 1e-8)[..., None] * eye6, 6)

    def precond(rv):
        return torch.stack([sum(Minv[:, i, j] * rv[:, j] for j in range(6)) for i in range(6)],
                           -1) * free_c

    threshold = (cg_tol * cg_tol) * (b * precond(b)).sum()
    if x0 is None:
        xv, rv = torch.zeros_like(b), b
    else:
        xd = x0 * free_c
        Ad = schur_mv(xd)
        alpha = (b * Ad).sum() / (Ad * Ad).sum().clamp_min(1e-20)
        xv, rv = alpha * xd, b - alpha * Ad
    zz = precond(rv)
    rz = (rv * zz).sum()
    pdir = zz
    k = 0
    # The reference's while_loop: k < cg_iters and rz > threshold.
    while k < cg_iters and bool(rz > threshold):
        Ap = schur_mv(pdir)
        pAp = (pdir * Ap).sum()
        alpha = rz / torch.where(pAp.abs() < 1e-20, torch.full_like(pAp, 1e-20), pAp)
        xv = xv + alpha * pdir
        rv = rv - alpha * Ap
        zz = precond(rv)
        rz_new = (rv * zz).sum()
        beta = rz_new / torch.where(rz.abs() < 1e-20, torch.full_like(rz, 1e-20), rz)
        pdir = zz + beta * pdir
        rz = rz_new
        k += 1
    dc = xv
    jd = jc_dot(dc)
    dp = -point_solve(seg_multi([sum(Jp_w[rr][i] * (r[rr] + jd[rr]) for rr in range(3))
                                 for i in range(3)]))
    T_new = torch.where(p.pose_fixed[:, None, None], p.Tcw, se3.retract(p.Tcw, dc))
    return T_new, p.X + dp, c2, delta2, dc, k


def _total_cost(c2, delta2, act_f, use_huber: bool):
    if use_huber:
        rho = torch.where(c2 > delta2, 2.0 * torch.sqrt(delta2 * c2.clamp_min(1e-12)) - delta2,
                          c2)
    else:
        rho = c2
    return (rho * act_f).sum()


def optimize_plain(cam, problem: BADense, n_iters: int = 10, cg_iters: int = 40,
                   huber_iters: int = 5) -> BADenseResult:
    """Plain version of K8: the reference's LM loop (robust phase, then plain;
    re-classification after the robust phase)."""
    if problem.pm_src is None:
        raise ValueError("optimize: the problem has no point-major table (build_point_major)")
    p = problem
    dev = p.X.device
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    active = p.obs_active
    dc = torch.zeros(p.Tcw.shape[0], 6, dtype=torch.float32, device=dev)
    trace = []
    for it in range(n_iters):
        use_huber = it < huber_iters
        T_new, X_new, c2_old, delta2, dc, n_cg = lm_step_dense(cam, p, active, lam, use_huber,
                                                               cg_iters, x0=dc)
        p_new = p._replace(Tcw=T_new, X=X_new)
        c2_new = _chi2(_linearize(cam, p_new))
        act_f = active.to(torch.float32)
        accept = bool(_total_cost(c2_new, delta2, act_f, use_huber)
                      < _total_cost(c2_old, delta2, act_f, use_huber))
        trace.append((n_cg, int(accept)))
        if accept:
            p = p_new
            lam = torch.clamp_min(lam * 0.5, 1e-9)
        else:
            lam = torch.clamp_max(lam * 5.0, 1e3)
        if it == huber_iters - 1:
            active = active & ((c2_new if accept else c2_old) <= delta2)
    c2 = _chi2(_linearize(cam, p))
    delta2 = reproj.chi2_threshold(p.obs_stereo)
    inlier = problem.obs_active & (c2 <= delta2)
    cost = _total_cost(c2, delta2, active.to(torch.float32), False)
    return BADenseResult(se3.orthonormalize_fast(p.Tcw), p.X, inlier, cost,
                         torch.tensor(trace, dtype=torch.int32).reshape(n_iters, 2))


def _optimize_cuda(cam, pb: BADense, n_iters: int, cg_iters: int, huber_iters: int,
                   counter: str):
    C, Fb = pb.obs_mp.shape
    P = pb.X.shape[0]
    dev = pb.X.device
    if pb.pm_src is None:
        raise ValueError("optimize: the problem has no point-major table (build_point_major)")
    K = pb.pm_src.shape[1]
    chk = kernels.check
    for name, t, dt, shape in (
            ("Tcw", pb.Tcw, torch.float32, (C, 4, 4)), ("pose_fixed", pb.pose_fixed, torch.bool, (C,)),
            ("X", pb.X, torch.float32, (P, 3)), ("point_fixed", pb.point_fixed, torch.bool, (P,)),
            ("obs_mp", pb.obs_mp, torch.int32, (C, Fb)),
            ("obs_uvr", pb.obs_uvr, torch.float32, (3, C, Fb)),
            ("obs_inv_sigma2", pb.obs_inv_sigma2, torch.float32, (C, Fb)),
            ("obs_stereo", pb.obs_stereo, torch.bool, (C, Fb)),
            ("obs_active", pb.obs_active, torch.bool, (C, Fb)),
            ("pm_src", pb.pm_src, torch.int32, (P, K)), ("pm_ok", pb.pm_ok, torch.bool, (P, K))):
        chk(t, name, dt, shape, dev)
    O = C * Fb
    # Per observation 10 floats, per point 15, per camera 136, per 64-slot
    # tile 21, and 9 x 1024 per-CTA partials (the layout in ba_dense.cu).
    n_scratch = 10 * O + 15 * P + 136 * C + 21 * C * -(-Fb // 64) + 9 * 1024
    scratch_f = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    scratch_b = torch.empty(O, dtype=torch.uint8, device=dev)
    Tcw = torch.empty(C, 4, 4, dtype=torch.float32, device=dev)
    X = torch.empty(P, 3, dtype=torch.float32, device=dev)
    inlier = torch.empty(C, Fb, dtype=torch.bool, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    trace = torch.empty(max(n_iters, 1), 2, dtype=torch.int32, device=dev)
    p = kernels.ptr
    kernels.launch(counter, "ba_optimize", p(pb.Tcw), p(pb.pose_fixed), p(pb.X),
                   p(pb.point_fixed), p(pb.obs_mp), p(pb.obs_uvr), p(pb.obs_inv_sigma2),
                   p(pb.obs_stereo), p(pb.obs_active), p(pb.pm_src), p(pb.pm_ok), C, Fb, P, K,
                   n_iters, cg_iters, huber_iters, float(cam.fx), float(cam.fy), float(cam.cx),
                   float(cam.cy), float(cam.bf), p(scratch_f), n_scratch, p(scratch_b), p(Tcw),
                   p(X), p(inlier), p(cost), p(trace))
    return BADenseResult(Tcw, X, inlier, cost, trace[:n_iters])


def optimize(cam, problem: BADense, n_iters: int = 10, cg_iters: int = 40,
             huber_iters: int = 5, counter: str = "ba_dense") -> BADenseResult:
    """LM loop with accept / reject (K8 on CUDA tensors, the plain version on
    CPU tensors). Needs the problem's point-major table."""
    if problem.X.is_cuda:
        return _optimize_cuda(cam, problem, n_iters, cg_iters, huber_iters, counter)
    if problem.X.device.type == "cpu":
        return optimize_plain(cam, problem, n_iters, cg_iters, huber_iters)
    raise ValueError(f"unsupported device {problem.X.device}")


# ---------------------------------------------------------------------------
# Problem builders
# ---------------------------------------------------------------------------

def inv_sigma2_of(octave: torch.Tensor, scale_factor: float) -> torch.Tensor:
    return 1.0 / (scale_factor ** (2.0 * octave.to(torch.float32)))


def problem_from_window(m, sel, scale_factor: float) -> BADense:
    """Local-BA window (`LocalBAInputs`) -> BADense: camera slot = window
    slot, feature slot = feature column, point rows compacted to
    `sel.mp_rows` through an inverse map. Every field is a gathered copy, so
    later writes to the map do not reach the problem. K = W loses nothing: a
    window point has at most W observations unless a row observes it twice."""
    W = sel.kf_rows.shape[0]
    P = sel.mp_rows.shape[0]
    dev = sel.kf_rows.device
    rows = sel.kf_rows.long()
    inv = torch.full((m.mp.capacity,), -1, dtype=torch.int32, device=dev)
    inv[sel.mp_rows.long()] = torch.where(sel.mp_ok, torch.arange(P, dtype=torch.int32, device=dev),
                                          torch.full((P,), -1, dtype=torch.int32, device=dev))
    idx = m.kf.mp_idx[rows]
    ok = (idx >= 0) & m.kf.fvalid[rows] & sel.kf_ok[:, None]
    compact = torch.where(ok, inv[idx.clamp_min(0).long()], torch.full_like(idx, -1))
    ok = ok & (compact >= 0)
    xy = m.kf.xy[rows]
    ur = m.kf.uright[rows]
    obs_mp = compact.clamp_min(0)
    pm_src, pm_ok, ok = build_point_major(obs_mp, ok, P, W)
    return BADense(
        Tcw=m.kf.Tcw[rows], pose_fixed=~(sel.kf_free & sel.kf_ok), X=m.mp.pos[sel.mp_rows.long()],
        point_fixed=~sel.mp_ok | m.mp.fixed[sel.mp_rows.long()], obs_mp=obs_mp,
        obs_uvr=torch.stack([xy[..., 0], xy[..., 1], ur]),
        obs_inv_sigma2=inv_sigma2_of(m.kf.octave[rows], scale_factor), obs_stereo=ur > 0,
        obs_active=ok, pm_src=pm_src, pm_ok=pm_ok)


# ---------------------------------------------------------------------------
# Global BA's problem builders
# ---------------------------------------------------------------------------

def compact_rows(ok: torch.Tensor, budget: int) -> torch.Tensor:
    """[N, F] validity -> [N, budget] column indices, valid entries first in
    their order (a stable sort of ~ok); a row with fewer valid entries points
    its tail at invalid columns (the caller re-checks ok)."""
    return torch.sort((~ok).to(torch.uint8), dim=1, stable=True)[1][:, :budget]


def problem_from_map(m, scale_factor: float, obs_per_kf: int, gauge_row: int = 0,
                     pm_k: int | None = 24, counter: str = "ba_dense") -> BADense:
    """The whole map as a BADense with a per-keyframe observation budget
    (GlobalBundleAdjustemnt's all-keyframes / all-points graph, Optimizer.cc:
    43-54): row c holds keyframe c's first `obs_per_kf` bound observations.
    `pm_k` is the point-major table's K (observations past it are thinned by
    the even-stride rule); None builds no table. Tcw and X are the map's own
    tensors (views): copy the map first where it changes later."""
    idx = m.kf.mp_idx
    ok = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    ok &= torch.where(idx >= 0, m.mp.valid[idx.clamp_min(0).long()], torch.zeros_like(ok))
    sel = compact_rows(ok, obs_per_kf)

    def take(a):
        return torch.gather(a, 1, sel)

    active = take(ok)
    ids = take(idx).clamp_min(0)
    ur = take(m.kf.uright)
    inv_sigma2 = inv_sigma2_of(take(m.kf.octave), scale_factor)
    pm_src = pm_ok = None
    if pm_k is not None:
        pm_src, pm_ok, active = build_point_major(ids, active, m.mp.pos.shape[0], pm_k, counter)
    pose_fixed = ~m.kf.valid | m.kf.fixed
    pose_fixed[gauge_row] = True
    return BADense(
        Tcw=m.kf.Tcw, pose_fixed=pose_fixed, X=m.mp.pos, point_fixed=~m.mp.valid | m.mp.fixed,
        obs_mp=ids, obs_uvr=torch.stack([take(m.kf.xy[..., 0]), take(m.kf.xy[..., 1]), ur]),
        obs_inv_sigma2=inv_sigma2, obs_stereo=ur > 0, obs_active=active, pm_src=pm_src,
        pm_ok=pm_ok)


def slice_problem(p: BADense, Cr: int, Pr: int) -> BADense:
    """The problem cut to its first Cr cameras and Pr points (lossless when
    the active observations lie in them; table rows of cut points go)."""
    return p._replace(
        Tcw=p.Tcw[:Cr], pose_fixed=p.pose_fixed[:Cr], X=p.X[:Pr], point_fixed=p.point_fixed[:Pr],
        obs_mp=p.obs_mp[:Cr].clamp_max(Pr - 1), obs_uvr=p.obs_uvr[:, :Cr].contiguous(),
        obs_inv_sigma2=p.obs_inv_sigma2[:Cr], obs_stereo=p.obs_stereo[:Cr],
        obs_active=p.obs_active[:Cr],
        pm_src=None if p.pm_src is None else p.pm_src[:Pr],
        pm_ok=None if p.pm_ok is None else p.pm_ok[:Pr])


def round_up(n: int, step: int, cap: int) -> int:
    return min(cap, max(step, ((n + step - 1) // step) * step))
