"""Parity of the port's descriptor ops and stereo matcher (plain PyTorch
versions, CPU) with the JAX reference.

Tolerances and why:
  * descriptor ops (pack/unpack, popcount, Hamming, best match, mutual
    check): exact — integer arithmetic, ties to the lower index.
  * stereo_match against the reference's match_stereo_features on identical
    Features: `ok` exact; u_right and depth within 1e-3 — the 121-term SAD
    sums differ in order. At the edge cases also the best match's index and
    distance exact.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.config import OrbConfig as JOrbConfig
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.ops import descriptors as JD
from corbslam_tpu.ops import orb as jorb
from corbslam_tpu.ops import stereo as jstereo
from corbslam_tpu_torch.kernel_times import stereo_edge_cases
from corbslam_tpu_torch.ops import descriptors as D
from corbslam_tpu_torch.ops import stereo
from corbslam_tpu_torch.ops.orb import Features

torch.set_num_threads(2)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def descs():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, size=(40, 32), dtype=np.uint8)
    b = rng.integers(0, 256, size=(50, 32), dtype=np.uint8)
    b[5] = b[9]            # duplicate columns: equal distances tie
    b[17] = a[3]           # an exact match
    b[18] = a[3]           # ... twice (tie at distance 0)
    a[11] = a[12]          # duplicate rows: column-wise ties
    mask = rng.random((40, 50)) < 0.7
    return a, b, mask


@jax.jit
def _jax_desc_ops(a, b, mask):
    d = JD.masked_hamming_matrix(a, b, extra_mask=mask)
    out = dict(bits=JD.unpack_bits(a), packed=JD.pack_bits(JD.unpack_bits(a)),
               pop=JD.popcount_desc(a), ham=JD.hamming_matrix(a, b), masked=d,
               pair=JD.hamming_pairwise(a, b[:40]))
    for r in (1.0, 0.8):
        out[f"best{r}"] = JD.best_match(d, 300, ratio=r)
        out[f"best_col{r}"] = JD.best_match(d, 300, ratio=r, axis=0)
        out[f"mutual{r}"] = JD.mutual_best(d, 300, ratio=r)
    return out


@pytest.fixture(scope="module")
def jax_desc(descs):
    a, b, mask = descs
    return jax.tree.map(np.asarray, _jax_desc_ops(a, b, mask))


def test_pack_unpack_popcount_exact(descs, jax_desc):
    a = T(descs[0])
    np.testing.assert_array_equal(D.unpack_bits(a).numpy(), jax_desc["bits"])
    np.testing.assert_array_equal(D.pack_bits(D.unpack_bits(a)).numpy(), jax_desc["packed"])
    np.testing.assert_array_equal(D.popcount_desc(a).numpy(), jax_desc["pop"])


def test_hamming_matrices_exact(descs, jax_desc):
    a, b, mask = map(T, descs)
    np.testing.assert_array_equal(D.hamming_matrix(a, b).numpy(), jax_desc["ham"])
    np.testing.assert_array_equal(D.masked_hamming_matrix(a, b, extra_mask=mask).numpy(),
                                  jax_desc["masked"])
    np.testing.assert_array_equal(D.hamming_pairwise(a, b[:40]).numpy(), jax_desc["pair"])


@pytest.mark.parametrize("ratio", [1.0, 0.8])
def test_best_match_and_mutual_exact_with_ties(descs, jax_desc, ratio):
    a, b, mask = map(T, descs)
    d = D.masked_hamming_matrix(a, b, extra_mask=mask)
    for key, got in ((f"best{ratio}", D.best_match(d, 300, ratio=ratio)),
                     (f"best_col{ratio}", D.best_match(d, 300, ratio=ratio, axis=0)),
                     (f"mutual{ratio}", D.mutual_best(d, 300, ratio=ratio))):
        for g, r in zip(got, jax_desc[key]):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=key)


def _to_port(f) -> Features:
    return Features(*(T(np.asarray(v)) for v in f))


@pytest.fixture(scope="module")
def stereo_features():
    """JAX features of a 160x320 stereo pair (right = left rolled by 9 px)."""
    img = jsynthetic.random_texture(160, 320, seed=21)
    cfg = JOrbConfig(n_features=512, n_levels=3)
    fl = jorb.extract_jit(jnp.asarray(img), cfg)
    fr = jorb.extract_jit(jnp.asarray(np.roll(img, -9, axis=1).copy()), cfg)
    return fl, fr, np.asarray(cfg.scales(), np.float32)


@partial(jax.jit, static_argnames=("bf",))
def _jax_stereo(fl, fr, scales, bf):
    return jstereo.match_stereo_features(fl, fr, scales, bf)


def _check_stereo(jl, jr, scales, bf=386.1448):
    ur_j, depth_j, ok_j = map(np.asarray, _jax_stereo(jl, jr, jnp.asarray(scales), bf))
    m = stereo.stereo_match(_to_port(jl), _to_port(jr), T(scales), bf)
    np.testing.assert_array_equal(m.ok.numpy(), ok_j)
    np.testing.assert_allclose(m.u_right.numpy(), ur_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(m.depth.numpy(), depth_j, rtol=0, atol=1e-3)
    return ok_j


def test_match_stereo_features_on_identical_features(stereo_features):
    fl, fr, scales = stereo_features
    ok = _check_stereo(fl, fr, scales)
    assert 0 < ok.sum() < ok.size  # some features fail: the median cut is inert


@pytest.mark.parametrize("n", [64, 63])
def test_stereo_median_cut_when_every_feature_passes(n):
    """Every left feature has an exact right twin 7 px to the left, so all
    pass and the reference's 2.1 x median SAD cut is live (the two middle
    values averaged for even n); noisy right patches of a few make them fail
    it."""
    rng = np.random.default_rng(n)
    xy_l = np.stack([rng.uniform(60, 300, n), rng.uniform(20, 140, n)], -1).astype(np.float32)
    xy_r = xy_l - np.array([7.0, 0.0], np.float32)
    desc = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    patch_l = rng.uniform(0, 255, size=(n, 32, 32)).astype(np.float32)
    patch_r = patch_l + rng.normal(0, 1.0, size=patch_l.shape).astype(np.float32)
    patch_r[:6] += rng.normal(0, 40.0, size=(6, 32, 32)).astype(np.float32)
    zeros, ones = np.zeros(n, np.int32), np.ones(n, bool)
    jl = jorb.Features(jnp.asarray(xy_l), jnp.zeros(n), jnp.zeros(n), jnp.asarray(zeros),
                       jnp.asarray(desc), jnp.asarray(ones), jnp.asarray(patch_l))
    jr = jl._replace(xy=jnp.asarray(xy_r), patch=jnp.asarray(patch_r))
    ok = _check_stereo(jl, jr, np.asarray([1.0, 1.2], np.float32))
    assert 0 < (~ok).sum() <= 6  # the cut removed some, and only noisy ones


EDGE_N, EDGE_M = 24, 48  # every edge case padded to one shape for the reference


@partial(jax.jit, static_argnames=("bf",))
def _jax_stereo_full(fl, fr, scales, bf):
    """The reference's outputs, and its best match by the candidate mask of
    match_stereo_features' first step (ops/stereo.py:53-61), which it does
    not return."""
    u_right, depth, ok = jstereo.match_stereo_features(fl, fr, scales, bf)
    row_tol = 2.0 * scales[fr.octave]
    disp = fl.xy[:, None, 0] - fr.xy[None, :, 0]
    mask = (jnp.abs(fl.xy[:, None, 1] - fr.xy[None, :, 1]) <= row_tol[None, :])
    mask &= (disp >= -1.0) & (disp <= 192.0)
    mask &= jnp.abs(fl.octave[:, None] - fr.octave[None, :]) <= 1
    mask &= fl.valid[:, None] & fr.valid[None, :]
    idx, dist, _ = JD.best_match(JD.masked_hamming_matrix(fl.desc, fr.desc, extra_mask=mask), 80)
    return idx, dist, u_right, depth, ok


def _edge_features(side: dict, n: int):
    """(JAX Features padded with invalid rows at (0, 0) to n, port Features)."""
    k = side["xy"].shape[0]
    zeros = np.zeros(k, np.float32)
    port = Features(T(side["xy"]), T(zeros), T(zeros), T(side["octave"]), T(side["desc"]),
                    T(side["valid"]), T(side["patch"]))
    padded = {f: np.concatenate([v, np.zeros((n - k, *v.shape[1:]), v.dtype)])
              for f, v in side.items()}
    zn = jnp.zeros(n)
    ref = jorb.Features(jnp.asarray(padded["xy"]), zn, zn, jnp.asarray(padded["octave"]),
                        jnp.asarray(padded["desc"]), jnp.asarray(padded["valid"]),
                        jnp.asarray(padded["patch"]))
    return ref, port


@pytest.mark.parametrize("case", sorted(stereo_edge_cases()))
def test_stereo_match_at_its_edges(case):
    """K4's plain version against the reference on the edge inputs that
    chip_smoke.py holds K4 to on the card (`kernel_times.stereo_edge_cases`):
    the row tolerance, disparity and octave bounds exact and one float
    beyond, ties across rows, rows with no candidate, one right row, padded
    rows at (0, 0) and M = 1. idx, dist and ok exact; u_right and depth
    within 1e-3. The reference runs with both sides padded by invalid rows
    (EDGE_N x EDGE_M; M = 1 alone is not a shape it takes): an invalid row
    is never a candidate, and since some real feature fails in every case,
    no median cut is live that a padded row could disable."""
    left, right, scales = stereo_edge_cases()[case]
    n = left["xy"].shape[0]
    jl, pl = _edge_features(left, EDGE_N)
    jr, pr = _edge_features(right, EDGE_M)
    bf = 386.1448
    idx_j, dist_j, ur_j, depth_j, ok_j = (np.asarray(v)[:n] for v in _jax_stereo_full(
        jl, jr, jnp.asarray(scales), bf))
    m = stereo.stereo_match(pl, pr, T(scales), bf)
    assert not ok_j.all()
    np.testing.assert_array_equal(m.idx.numpy(), idx_j)
    np.testing.assert_array_equal(m.dist.numpy(), dist_j)
    np.testing.assert_array_equal(m.ok.numpy(), ok_j)
    np.testing.assert_allclose(m.u_right.numpy(), ur_j, rtol=0, atol=1e-3)
    np.testing.assert_allclose(m.depth.numpy(), depth_j, rtol=0, atol=1e-3)
    if case != "no_candidate":
        assert (dist_j < 512).any()
