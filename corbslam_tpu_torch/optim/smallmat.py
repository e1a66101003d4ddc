"""Unrolled fixed-size symmetric linear algebra (port of
`corbslam_tpu/optim/smallmat.py`).

BA needs thousands of tiny SPD solves (per-point 3x3 Hessians, per-camera 6x6
preconditioner blocks). These are Cholesky factorizations written as scalar
recurrences over the leading batch dimensions, in the reference's order and
with its `eps` clamp of the pivots; kernel K8 (`csrc/ba_dense.cu`) inlines the
same recurrences.
"""

from __future__ import annotations

import torch


def chol_unrolled(A: torch.Tensor, n: int, eps: float = 1e-12) -> torch.Tensor:
    """Batched Cholesky factor L (lower) of SPD [..., n, n]."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s.clamp_min(eps)) if i == j else s / L[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


def chol_solve_factored(Lm: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Solve L L^T x = b with a precomputed factor L [..., n, n]; b [..., n]."""
    L = [[Lm[..., i, j] for j in range(n)] for i in range(n)]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def chol_solve_unrolled(A: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """Solve SPD A x = b, A [..., n, n], b [..., n]."""
    return chol_solve_factored(chol_unrolled(A, n), b, n)


def inv_spd_unrolled(A: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of SPD [..., n, n], column by column against the identity."""
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    cols = [chol_solve_unrolled(A, eye[i].expand(*A.shape[:-2], n), n) for i in range(n)]
    return torch.stack(cols, dim=-1)
