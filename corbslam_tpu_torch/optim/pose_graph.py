"""Sim3 pose-graph (essential graph) optimization (port of
`corbslam_tpu/optim/pose_graph.py`: `PoseGraph`, `edge_residual`,
`linearize_edges`, `optimize`).

Vertices are SoA Sim3 poses; an edge's residual is r = log(S_m o S_i o
S_j^-1) and its Jacobians are the forward-mode derivatives of r in the
tangents of both ends (the reference's `jax.jacfwd`: one forward-mode direction per
pass in the plain version, one dual number per (edge, direction) in the
kernel). `optimize` runs a fixed number of Gauss-Newton iterations, each a
fixed number of block-Jacobi PCG iterations on the matrix-free normal
equations, then two polar steps of the rotations: no tolerance exit, so the
card runs it without a host sync.

On CUDA tensors both run on kernel K11 (`csrc/pose_graph.cu`): the
linearization alone as one launch over (edge, direction) pairs, and the
whole of `optimize` as one cooperative launch (one CTA on each SM) that
linearizes each CTA's range of edges into its shared memory, builds and
inverts the 7x7 blocks of its range of vertices, runs the PCG with grid
barriers between its phases and retracts, with the segment sums taken from
a vertex-major incidence list in a fixed order (no float atomics) and the
dot products added in CTA order, so two runs are bit-equal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..geometry import sim3
from .smallmat import inv_spd_unrolled


class PoseGraph(NamedTuple):
    R: torch.Tensor        # [N, 3, 3] world -> keyframe Sim3 (Scw)
    t: torch.Tensor        # [N, 3]
    s: torch.Tensor        # [N]
    fixed: torch.Tensor    # [N] bool
    e_i: torch.Tensor      # [E] i32
    e_j: torch.Tensor      # [E] i32
    mR: torch.Tensor       # [E, 3, 3] measurement S_ji
    mt: torch.Tensor       # [E, 3]
    ms: torch.Tensor       # [E]
    e_valid: torch.Tensor  # [E] bool
    e_weight: torch.Tensor  # [E] f32


def edge_residual(Si, Sj, Sm):
    """r = log(Sm o Si o Sj^-1), [..., 7]."""
    return sim3.log(sim3.compose(Sm, sim3.compose(Si, sim3.inverse(Sj))))


def _edge_tangent(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    return edge_residual(sim3.retract((Ri, ti, si), xi_i), sim3.retract((Rj, tj, sj), xi_j),
                         (Rm, tm, sm))


def linearize_edges_plain(g: PoseGraph):
    """Forward mode (dual tensors of `torch.autograd.forward_ad`): the 14
    tangent directions (7 of each end) ride a leading batch axis of one
    pass, each carrying its own one-hot tangent, as the kernel's threads do."""
    import torch.autograd.forward_ad as fwAD

    i, j = g.e_i.long(), g.e_j.long()
    E = g.e_i.shape[0]
    dev = g.R.device
    zero = torch.zeros(E, 7, dtype=torch.float32, device=dev)
    ends = (g.R[i], g.t[i], g.s[i], g.R[j], g.t[j], g.s[j], g.mR, g.mt, g.ms)
    r = _edge_tangent(zero, zero, *ends)
    eye = torch.eye(14, dtype=torch.float32, device=dev)[:, None, :].expand(14, E, 14)
    with fwAD.dual_level():
        xi_i = fwAD.make_dual(torch.zeros(14, E, 7, device=dev), eye[..., :7].contiguous())
        xi_j = fwAD.make_dual(torch.zeros(14, E, 7, device=dev), eye[..., 7:].contiguous())
        tan = fwAD.unpack_dual(_edge_tangent(xi_i, xi_j, *ends)).tangent   # [14, E, 7]
    J = tan.permute(1, 2, 0)   # [E, 7, 14]
    return r, J[..., :7].contiguous(), J[..., 7:].contiguous()


def _check_graph(g: PoseGraph):
    dev = g.R.device
    N, E = g.R.shape[0], g.e_i.shape[0]
    for name, t, dt, shape in (
            ("R", g.R, torch.float32, (N, 3, 3)), ("t", g.t, torch.float32, (N, 3)),
            ("s", g.s, torch.float32, (N,)), ("fixed", g.fixed, torch.bool, (N,)),
            ("e_i", g.e_i, torch.int32, (E,)), ("e_j", g.e_j, torch.int32, (E,)),
            ("mR", g.mR, torch.float32, (E, 3, 3)), ("mt", g.mt, torch.float32, (E, 3)),
            ("ms", g.ms, torch.float32, (E,)), ("e_valid", g.e_valid, torch.bool, (E,)),
            ("e_weight", g.e_weight, torch.float32, (E,))):
        kernels.check(t, f"g.{name}", dt, shape, dev)
    return dev, N, E


def _linearize_cuda(g: PoseGraph, R, t, s, r, J):
    p = kernels.ptr
    E = g.e_i.shape[0]
    kernels.launch("pose_graph", "pg_linearize", p(R), p(t), p(s), p(g.e_i), p(g.e_j), p(g.mR),
                   p(g.mt), p(g.ms), E, p(r), p(J))


def linearize_edges(g: PoseGraph):
    """Residuals [E, 7] and Jacobians [E, 7, 7] in the tangents of each
    edge's ends (i, j)."""
    if not g.R.is_cuda:
        if g.R.device.type != "cpu":
            raise ValueError(f"unsupported device {g.R.device}")
        return linearize_edges_plain(g)
    g = PoseGraph(*(x.contiguous() for x in g))
    dev, N, E = _check_graph(g)
    r = torch.empty(E, 7, dtype=torch.float32, device=dev)
    J = torch.empty(E, 2, 7, 7, dtype=torch.float32, device=dev)
    _linearize_cuda(g, g.R, g.t, g.s, r, J)
    return r, J[:, 0], J[:, 1]


def _polar(R):
    I = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape)
    for _ in range(2):
        R = 0.5 * (R @ (3.0 * I - R.transpose(-1, -2) @ R))
    return R


def optimize_plain(g: PoseGraph, n_iters: int = 20, cg_iters: int = 50, lam: float = 1e-6):
    N = g.R.shape[0]
    dev = g.R.device
    free = (~g.fixed).to(torch.float32)[:, None]
    ei, ej = g.e_i.long(), g.e_j.long()
    w = (g.e_valid.to(torch.float32) * g.e_weight)[:, None]
    I7 = torch.eye(7, dtype=torch.float32, device=dev)

    # Each vertex's sum over its edges in edge order (segment_reduce over the
    # edges sorted by vertex): a sequential index_add_'s sums, and on CUDA,
    # where index_add_ adds with atomics in no fixed order, the same from
    # run to run.
    def segment_sum(idx):
        order, cnt = torch.argsort(idx, stable=True), torch.bincount(idx, minlength=N)
        return lambda x: torch.segment_reduce(x[order], "sum", lengths=cnt, axis=0)

    seg_i, seg_j = segment_sum(ei), segment_sum(ej)

    R, t, s = g.R, g.t, g.s
    costs = []
    for _ in range(n_iters):
        r, Ji, Jj = linearize_edges_plain(g._replace(R=R, t=t, s=s))
        Ji_w, Jj_w = Ji * w[:, :, None], Jj * w[:, :, None]
        Hd = (seg_i(torch.einsum("eri,erj->eij", Ji_w, Ji))
              + seg_j(torch.einsum("eri,erj->eij", Jj_w, Jj)))
        Hd = Hd + lam * I7 + 1e-8 * I7
        Minv = inv_spd_unrolled(Hd + 1e-6 * I7, 7)
        b = -(seg_i(torch.einsum("eri,er->ei", Ji_w, r))
              + seg_j(torch.einsum("eri,er->ei", Jj_w, r))) * free

        def Hv(v):
            v = v * free
            a = torch.einsum("eri,ei->er", Ji, v[ei]) + torch.einsum("eri,ei->er", Jj, v[ej])
            a = a * w
            out = (seg_i(torch.einsum("eri,er->ei", Ji, a))
                   + seg_j(torch.einsum("eri,er->ei", Jj, a)))
            return (out + (lam + 1e-8) * v) * free

        def precond(x):
            return torch.einsum("nij,nj->ni", Minv, x) * free

        x = torch.zeros_like(b)
        rr = b
        pp = precond(rr)
        rz = (rr * pp).sum()
        for _ in range(cg_iters):
            Ap = Hv(pp)
            pAp = (pp * Ap).sum()
            alpha = rz / torch.where(pAp.abs() < 1e-20, torch.full_like(pAp, 1e-20), pAp)
            x = x + alpha * pp
            rr = rr - alpha * Ap
            z = precond(rr)
            rz2 = (rr * z).sum()
            beta = rz2 / torch.where(rz.abs() < 1e-20, torch.full_like(rz, 1e-20), rz)
            pp = z + beta * pp
            rz = rz2
        R2, t2, s2 = sim3.retract((R, t, s), x)
        R = torch.where(g.fixed[:, None, None], R, R2)
        t = torch.where(g.fixed[:, None], t, t2)
        s = torch.where(g.fixed, s, s2)
        costs.append(((r * r) * (w * w)).sum())
    return (_polar(R), t, s), torch.stack(costs)


def scratch_floats(N: int, E: int) -> int:
    """Floats of `pg_optimize`'s device-memory scratch (the layout of
    `csrc/pose_graph.cu`: per edge its Jacobians and residual, 2 x 35 block
    terms and 2 x 7 CG terms; per vertex z and two CG directions; 3 x 1024
    per-CTA partials). A vertex's other state lives in its CTA's shared
    memory."""
    return E * (2 * 49 + 7 + 2 * 35 + 14) + N * 3 * 7 + 3 * 1024


def incidence(g: PoseGraph, w: torch.Tensor):
    """Vertex-major incidence list of the weighted edges (w != 0): (off
    [N + 1], inc), inc holding side * E + edge ordered (vertex, side, edge),
    so a segment sum adds the i-side terms in edge order, then the j-side
    terms, as the reference's two segment sums do. Edges of weight 0 add
    exactly 0 there and are left out: they sort past the last vertex's
    segment (without a host sync), so the vertices they default to carry no
    long lists."""
    N, E = g.R.shape[0], g.e_i.shape[0]
    dev = g.R.device
    ends = torch.cat([g.e_i, g.e_j]).long()
    live = torch.cat([w, w]) != 0
    side = torch.cat([torch.zeros(E, dtype=torch.long, device=dev),
                      torch.ones(E, dtype=torch.long, device=dev)])
    edge = torch.arange(E, device=dev).repeat(2)
    key = torch.where(live, ends, torch.full_like(ends, N)) * (2 * E) + side * E + edge
    inc = (side * E + edge)[torch.sort(key)[1]].to(torch.int32)
    off = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    off[1:] = torch.cumsum(torch.bincount(ends, weights=live.to(torch.float32), minlength=N),
                           0).to(torch.int32)
    return off, inc


def optimize(g: PoseGraph, n_iters: int = 20, cg_iters: int = 50, lam: float = 1e-6):
    """Gauss-Newton with fixed damping; returns ((R, t, s), costs [n_iters]).
    On CUDA tensors one cooperative launch of K11; it raises if the card
    cannot hold the grid."""
    if not g.R.is_cuda:
        if g.R.device.type != "cpu":
            raise ValueError(f"unsupported device {g.R.device}")
        return optimize_plain(g, n_iters, cg_iters, lam)
    return _optimize_cuda(g, n_iters, cg_iters, lam)


def _optimize_cuda(g: PoseGraph, n_iters: int, cg_iters: int, lam: float):
    g = PoseGraph(*(x.contiguous() for x in g))
    dev, N, E = _check_graph(g)
    w = (g.e_valid.to(torch.float32) * g.e_weight).contiguous()
    off, inc = incidence(g, w)
    R, t, s = g.R.clone(), g.t.clone(), g.s.clone()
    work = torch.empty(scratch_floats(N, E), dtype=torch.float32, device=dev)
    costs = torch.empty(n_iters, dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("pose_graph", "pg_optimize", p(R), p(t), p(s), p(g.fixed), N, p(g.e_i),
                   p(g.e_j), p(g.mR), p(g.mt), p(g.ms), p(w), E, p(off), p(inc), int(n_iters),
                   int(cg_iters), float(lam), p(costs), p(work), work.numel())
    return (R, t, s), costs
