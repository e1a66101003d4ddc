"""Closed-form small-matrix spectral ops (port of
`corbslam_tpu/geometry/linalg3.py`: `eigh3x3`, `svd3x3`,
`smallest_eigvec_sym`), batched over leading dimensions.

- `eigh3x3`: Cardano / trigonometric eigenvalues of a symmetric 3x3, the
  eigenvectors of the smallest and largest by cross products of the rows of
  (A - lam I) (the longest of the three, the first on ties, e1 when all
  vanish), the middle one as their cross product.
- `svd3x3`: V from `eigh3x3(M^T M)`, U = M V / s with Gram-Schmidt, U2 the
  cross product of U0 and U1 with its sign aligned to M v2.
- `smallest_eigvec_sym`: 12 inverse-power steps x <- (M + eps I)^-1 x from
  a ones vector, eps = 1e-9 tr(M) + 1e-30, each solve an LU with partial
  pivoting (`torch.linalg.solve`, as `jnp.linalg.solve`).

The determinant is JAX's 3x3 closed form and the cross product jnp.cross's,
in the same order of operations. `csrc/linalg3.cuh` holds the same
functions as `__device__` code for the two-view kernel (K12).
"""

from __future__ import annotations

import math

import torch


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] in `jnp.linalg.det`'s 3x3 closed form."""
    a = [[A[..., i, j] for j in range(3)] for i in range(3)]
    return (a[0][0] * a[1][1] * a[2][2] + a[0][1] * a[1][2] * a[2][0]
            + a[0][2] * a[1][0] * a[2][1] - a[0][2] * a[1][1] * a[2][0]
            - a[0][0] * a[1][2] * a[2][1] - a[0][1] * a[1][0] * a[2][2])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross of [..., 3] vectors."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis of a 3-vector, ((x^2 + y^2) + z^2)."""
    n = torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])
    return n[..., None] if keepdim else n


def _eigvec(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = torch.stack([cross(r0, r1), cross(r0, r2), cross(r1, r2)], dim=-2)
    best = torch.argmax(norm(cands), dim=-1)  # the first maximum
    v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    n = norm(v, keepdim=True)
    e1 = torch.zeros_like(v)
    e1[..., 0] = 1.0
    return torch.where(n > 1e-12, v / n.clamp_min(1e-30), e1)


def eigh3x3(A: torch.Tensor):
    """Eigenvalues (ascending) and eigenvectors of symmetric [..., 3, 3]:
    (w [..., 3], V [..., 3, 3]) with columns V[..., :, i]."""
    A = 0.5 * (A + A.transpose(-1, -2))
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    B = A - q[..., None, None] * eye
    p2 = (B * B).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(1e-30))
    Bn = B / p[..., None, None]
    r = (det3(Bn) / 2.0).clamp(-1.0, 1.0)
    phi = torch.acos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w0 - w2
    w = torch.stack([w0, w1, w2], dim=-1)
    v0 = _eigvec(A, w0)
    v2 = _eigvec(A, w2)
    v1 = cross(v2, v0)
    n1 = norm(v1, keepdim=True)
    v1 = torch.where(n1 > 1e-12, v1 / n1.clamp_min(1e-30), _eigvec(A, w1))
    return w, torch.stack([v0, v1, v2], dim=-1)


def svd3x3(M: torch.Tensor):
    """SVD of [..., 3, 3]: (U, s descending [..., 3], V) with M = U diag(s) V^T."""
    w, V = eigh3x3(M.transpose(-1, -2) @ M)
    s = torch.sqrt(w.flip(-1).clamp_min(0.0))
    V = V.flip(-1)
    MV = M @ V
    U0 = MV[..., :, 0] / s[..., 0:1].clamp_min(1e-12)
    U1 = MV[..., :, 1] / s[..., 1:2].clamp_min(1e-12)
    U0 = U0 / norm(U0, keepdim=True).clamp_min(1e-12)
    U1 = U1 - (U0 * U1).sum(dim=-1, keepdim=True) * U0
    U1 = U1 / norm(U1, keepdim=True).clamp_min(1e-12)
    U2 = cross(U0, U1)
    sgn = torch.sign((U2 * MV[..., :, 2]).sum(dim=-1, keepdim=True))
    U2 = U2 * torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    return torch.stack([U0, U1, U2], dim=-1), s, V


def smallest_eigvec_sym(M: torch.Tensor, n_iters: int = 12) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector of symmetric PSD [..., D, D] by
    inverse power iteration on M + (1e-9 tr + 1e-30) I."""
    D = M.shape[-1]
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(dim=-1)
    eps = (1e-9 * tr + 1e-30)[..., None, None]
    A = M + eps * torch.eye(D, dtype=M.dtype, device=M.device)
    # An exactly singular A (a degenerate sample) factors with a zero pivot,
    # as LAPACK's and XLA's LU do, instead of raising (CUDA's check).
    LU, piv, _ = torch.linalg.lu_factor_ex(A)
    v = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    for _ in range(n_iters):
        v = torch.linalg.lu_solve(LU, piv, v[..., None])[..., 0]
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-30)
    return v
