"""The port's closed-form 3x3 spectral ops (`geometry/linalg3.py`, the plain
versions of the device functions in `csrc/linalg3.cuh`) against
corbslam_tpu/geometry/linalg3.py on seeded batches: general symmetric
matrices, repeated eigenvalues, rank-2 inputs, and 9x9 normal matrices.

Tolerances and why: both sides are f32 with the same closed forms in the
same order, but XLA and PyTorch round the 3-element sums, acos and cos in
other orders (XLA may also fuse a multiply-add, so even the 3x3
determinant differs in the last bits: 1e-5): eigenvalues within 2e-5 of
the largest |w| and eigenvectors within 2e-4 (signs agree). At a double
root acos is evaluated where its slope is unbounded, so f32 rounding moves
the eigenvalues by ~sqrt(eps): 5e-4 of the largest there, and the
eigenvectors are any basis of the root's plane (only A V = V diag(w) is
held) and the simple root's eigenvector is compared. Singular values
within 1e-4 of the largest; in the rank-2 case the second is the square
root of a small eigenvalue of M^T M (1e-3 of s0), the second and third
columns are as ill-conditioned as s1 / s0 is small (f32 eps over a gap of
(s1 / s0)^2), and the third U column is defined only up to sign, so there
the first columns and the sign-free third U column are held; the
reconstruction U diag(s) V^T is held within twice the reference's own error
(plus 2e-3 of s0) on every matrix.
The smallest eigenvector of a 9x9 PSD matrix is held within 5e-5 up to
sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.geometry import linalg3 as jl
from corbslam_tpu_torch.geometry import linalg3 as tl

torch.set_num_threads(2)


def _sym(rng, n):
    A = rng.normal(size=(n, 3, 3)).astype(np.float32)
    return A + A.transpose(0, 2, 1)


def _repeated(rng, n):
    """Q diag(a, a, b) Q^T with a random rotation Q (a double eigenvalue)."""
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    d = np.stack([np.full(n, 2.0), np.full(n, 2.0), rng.uniform(-3, 5, n)], -1)
    return np.einsum("bij,bj,bkj->bik", Q, d, Q).astype(np.float32)


def _rank2(rng, n):
    C = rng.normal(size=(n, 3, 2)).astype(np.float32)
    return C @ C.transpose(0, 2, 1)


def _ours(fn, *xs):
    return [t.numpy() for t in fn(*(torch.from_numpy(x) for x in xs))]


def _ref(fn, *xs):
    return [np.asarray(t) for t in fn(*(jnp.asarray(x) for x in xs))]


@pytest.mark.parametrize("kind", ["general", "repeated", "rank2", "diagonal"])
def test_eigh3x3_equals_the_reference(rng, kind):
    A = {"general": lambda: _sym(rng, 64), "repeated": lambda: _repeated(rng, 32),
         "rank2": lambda: _rank2(rng, 32),
         "diagonal": lambda: np.tile(np.diag([1.0, 1.0, 2.0]).astype(np.float32), (4, 1, 1))}[kind]()
    w, V = _ours(tl.eigh3x3, A)
    wj, Vj = _ref(jl.eigh3x3, A)
    scale = np.abs(wj).max(axis=1, keepdims=True)
    np.testing.assert_allclose(w / scale, wj / scale, rtol=0,
                               atol=5e-4 if kind == "repeated" else 2e-5)
    if kind != "repeated":
        np.testing.assert_allclose(V, Vj, rtol=0, atol=2e-4)
        np.testing.assert_allclose(A @ V, V * w[:, None, :], rtol=0, atol=5e-3 * scale.max())
    else:  # a double root's eigenvectors are any basis of its plane; the simple root's agree
        simple = np.where(wj[:, 2] - wj[:, 1] > wj[:, 1] - wj[:, 0], 2, 0)
        b = np.arange(A.shape[0])
        v, vj = V[b, :, simple], Vj[b, :, simple]
        np.testing.assert_allclose(v * np.sign((v * vj).sum(-1, keepdims=True)), vj, rtol=0,
                                   atol=2e-3)


@pytest.mark.parametrize("kind", ["general", "rank2"])
def test_svd3x3_equals_the_reference(rng, kind):
    M = rng.normal(size=(32, 3, 3)).astype(np.float32) if kind == "general" else _rank2(rng, 32)
    U, s, V = _ours(tl.svd3x3, M)
    Uj, sj, Vj = _ref(jl.svd3x3, M)
    s0 = sj[:, :1]
    keep = 3 if kind == "general" else 2
    np.testing.assert_allclose(s[:, :keep] / s0, sj[:, :keep] / s0, rtol=0,
                               atol=1e-4 if kind == "general" else 1e-3)
    np.testing.assert_allclose(U[..., :keep - 1], Uj[..., :keep - 1], rtol=0, atol=2e-3)
    np.testing.assert_allclose(V[..., :keep - 1], Vj[..., :keep - 1], rtol=0, atol=2e-3)
    np.testing.assert_allclose(np.abs((U[..., 2] * Uj[..., 2]).sum(-1)), 1.0, atol=1e-4)
    def rec_err(U, s, V):
        return np.abs(np.einsum("bij,bj,bkj->bik", U, s, V) - M).max(axis=(1, 2))

    # As exact a factorization as the reference's own on every matrix.
    assert (rec_err(U, s, V) <= 2 * rec_err(Uj, sj, Vj) + 2e-3 * s0[:, 0]).all()


def test_smallest_eigvec_sym_equals_the_reference(rng):
    A = rng.normal(size=(16, 9, 9)).astype(np.float32)
    M = A @ A.transpose(0, 2, 1)
    v, = _ours(lambda x: (tl.smallest_eigvec_sym(x),), M)
    vj = np.asarray(jl.smallest_eigvec_sym(jnp.asarray(M)))
    sign = np.sign((v * vj).sum(-1, keepdims=True))
    np.testing.assert_allclose(v * sign, vj, rtol=0, atol=5e-5)


def test_det3_and_cross_equal_jaxs_closed_forms(rng):
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    a, b = rng.normal(size=(2, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(tl.det3(torch.from_numpy(A)).numpy(),
                               np.asarray(jnp.linalg.det(A)), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tl.cross(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jnp.cross(a, b)), rtol=0, atol=1e-6)
