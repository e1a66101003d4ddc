"""Parity of the port's map state and local-map helpers (`mapstate/`, and
`_candidate_local_kfs`, `local_map_window_plain`: the plain version of
kernel K7) with the JAX reference. Everything is integer or copied data, so
all comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu import config as jconfig
from corbslam_tpu.frontend import track_ops as jtrack
from corbslam_tpu.mapstate import covisibility as jcovis
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu_torch import config, interop
from corbslam_tpu_torch.frontend import track_ops
from corbslam_tpu_torch.mapstate import covisibility as covis
from corbslam_tpu_torch.mapstate import mapstate as ms

torch.set_num_threads(2)

T = torch.from_numpy
CAP = dict(max_keyframes=6, max_map_points=40, max_features=24, local_window_kfs=4,
           local_window_mps=16)


def _same_map(got: ms.MapState, ref) -> None:
    d = interop.map_to_numpy(got)
    for part in ("kf", "mp"):
        for name, a in d[part].items():
            np.testing.assert_array_equal(a, np.asarray(getattr(getattr(ref, part), name)),
                                          err_msg=f"{part}.{name}")
    assert d["n_kf"] == int(ref.n_kf) and d["n_mp"] == int(ref.n_mp)


def test_empty_equals_the_reference():
    _same_map(ms.empty(config.CapacityConfig(**CAP)), jms.empty(jconfig.CapacityConfig(**CAP)))


def _kf_payload(rng, F, i):
    return dict(
        Tcw=np.array(np.eye(4, dtype=np.float32) + i), xy=rng.uniform(0, 300, (F, 2)).astype(np.float32),
        octave=rng.integers(0, 4, F).astype(np.int32), angle=rng.uniform(-3, 3, F).astype(np.float32),
        desc=rng.integers(0, 256, (F, 32), dtype=np.uint8), uright=rng.uniform(-1, 300, F).astype(np.float32),
        depth=rng.uniform(0, 20, F).astype(np.float32), fvalid=rng.random(F) < 0.8,
        mp_idx=rng.integers(-1, 40, F).astype(np.int32))


def test_insert_keyframe_and_add_map_points_drop_at_capacity():
    """7 keyframes into 6 slots and 3 x 16 points into 40: the writes past
    the capacity are dropped (kf_row == capacity, rows NO_MP)."""
    rng = np.random.default_rng(0)
    jm = jms.empty(jconfig.CapacityConfig(**CAP))
    pm = ms.empty(config.CapacityConfig(**CAP))
    ins_j = jax.jit(jms.insert_keyframe, static_argnames=("client", "fixed"))
    add_j = jax.jit(jms.add_map_points, static_argnames=("client", "fixed"))
    for i in range(7):
        p = _kf_payload(rng, 24, i)
        args = [p[k] for k in ("Tcw", "xy", "octave", "angle", "desc", "uright", "depth",
                               "fvalid", "mp_idx")]
        jm, jrow = ins_j(jm, *map(jnp.asarray, args), i + 10, 0.5 * i, client=2)
        pm, prow = ms.insert_keyframe(pm, *map(T, args), i + 10, 0.5 * i, client=2)
        assert int(prow) == int(jrow) == min(i, 6)
    for i in range(3):
        K = 16
        pos = rng.normal(size=(K, 3)).astype(np.float32)
        desc = rng.integers(0, 256, (K, 32), dtype=np.uint8)
        nrm = rng.normal(size=(K, 3)).astype(np.float32)
        dmin, dmax = rng.uniform(0, 1, K).astype(np.float32), rng.uniform(1, 9, K).astype(np.float32)
        create = rng.random(K) < 0.9
        args = [pos, desc, nrm, dmin, dmax]
        jm, jrows = add_j(jm, *map(jnp.asarray, args), ref_kf=i, create=jnp.asarray(create))
        pm, prows = ms.add_map_points(pm, *map(T, args), ref_kf=torch.tensor(i, dtype=torch.int32),
                                      create=T(create))
        np.testing.assert_array_equal(prows.numpy(), np.asarray(jrows))
    assert int(pm.n_mp) == 40 and (prows.numpy() == -1).sum() > 0
    _same_map(pm, jm)


def _random_map(rng, n_kf, N=16, F=32, M=200):
    cap = dict(max_keyframes=N, max_map_points=M, max_features=F, local_window_kfs=8,
               local_window_mps=64)
    jm = jms.empty(jconfig.CapacityConfig(**cap))
    mp_idx = rng.integers(-1, M // 2, (N, F)).astype(np.int32)
    kf = jm.kf._replace(
        valid=jnp.asarray(np.arange(N) < n_kf), fvalid=jnp.asarray(rng.random((N, F)) < 0.9),
        mp_idx=jnp.asarray(np.where(np.arange(N)[:, None] < n_kf, mp_idx, -1)))
    mp = jm.mp._replace(valid=jnp.asarray(rng.random(M) < 0.8),
                        ref_kf=jnp.asarray(rng.integers(-1, n_kf + 1, M).astype(np.int32)))
    return jm._replace(kf=kf, mp=mp, n_kf=jnp.int32(n_kf), n_mp=jnp.int32(M // 2)), cap


def test_local_map_mask_equals_the_reference():
    rng = np.random.default_rng(3)
    jm, _ = _random_map(rng, 10)
    rows = np.array([3, 7, 7, 0, 12], np.int32)
    ok = np.array([True, True, False, True, True])
    ref = jax.jit(jcovis.local_map_mask)(jm, jnp.asarray(rows), jnp.asarray(ok))
    got = covis.local_map_mask(interop.map_from_numpy(jm), T(rows), T(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 10 < int(got.sum()) < 200


@pytest.mark.parametrize("n, n_true, k", [(1000, 5, 64), (1000, 300, 64), (4096 * 3 + 77, 900, 512),
                                          (5000, 0, 64), (6000, 64, 64), (4096, 4096, 100)],
                         ids=["fewer_than_k", "more_than_k", "ragged_tiles", "all_false",
                              "exactly_k_true", "all_true"])
def test_compact_indices_newest_first(n, n_true, k):
    """The plain compaction (what `compact_indices` runs on the CPU) against
    the reference's; K7 tiles [M] in 4096 rows from the top, so the cases
    include a ragged top tile, no True row, exactly k True rows and every row
    True."""
    rng = np.random.default_rng(n_true)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, n_true, replace=False)] = True
    ref_rows, ref_ok = jax.jit(jcovis.compact_indices, static_argnames=("k",))(
        jnp.asarray(mask), k=k)
    rows, ok = covis.compact_indices(T(mask), k)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    assert int(ok.sum()) == min(n_true, k)


def test_dedupe_candidate_weights_keeps_the_first_valid():
    cand = np.array([4, 2, 4, 0, 2, 9, 4, 0, 0], np.int32)
    ok = np.array([False, True, True, True, True, True, True, False, True])
    w = np.arange(1, 10, dtype=np.int32)
    ref = jcovis.dedupe_candidate_weights(jnp.asarray(cand), jnp.asarray(w), jnp.asarray(ok))
    got = covis.dedupe_candidate_weights(T(cand), T(w), T(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), [1, 2, 3, 4, 0, 6, 0, 8, 0])


@pytest.mark.parametrize("n_kf", [3, 14], ids=["n_kf_below_K1", "n_kf_above_K1"])
def test_candidate_local_kfs_equals_the_reference(n_kf):
    """Row 0 repeats when n_kf < K1, and the previous window overlaps the
    newest rows: local rows, their ok flags, the new reference keyframe and
    the tracked-point mask are exact."""
    rng = np.random.default_rng(n_kf)
    jm, cap = _random_map(rng, n_kf)
    F = cap["max_features"]
    mp_idx = rng.integers(-1, 100, F).astype(np.int32)
    prev_rows = np.array([n_kf - 1, 0, 1, 2, n_kf - 1, 5, 6, 0], np.int32) % max(n_kf, 1)
    prev_ok = np.array([True, True, False, True, True, False, True, True])
    ref = jax.jit(jtrack._candidate_local_kfs, static_argnames=("K1",))(
        jm, jnp.asarray(mp_idx), jnp.asarray(prev_rows), jnp.asarray(prev_ok), jnp.int32(1), K1=8)
    got = track_ops._candidate_local_kfs(interop.map_from_numpy(jm), T(mp_idx), T(prev_rows),
                                         T(prev_ok), torch.tensor(1, dtype=torch.int32), 8)
    for g, r, name in zip(got, ref, ("local_rows", "local_ok", "ref_new", "cur_mask")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert int(got[1].sum()) >= min(n_kf, 2)


def test_map_round_trip():
    rng = np.random.default_rng(9)
    jm, _ = _random_map(rng, 7)
    pm = interop.map_from_numpy(jm)
    _same_map(pm, jm)
    assert pm.n_kf.dtype == torch.int32 and pm.n_kf.dim() == 0
    back = interop.map_from_numpy(interop.map_to_numpy(pm))
    _same_map(back, jm)
    assert back.kf.desc.data_ptr() != pm.kf.desc.data_ptr()


def _covis_map(n_kf, N):
    """A random map where keyframe q = n_kf - 1 anchors most of its points,
    so q is its own top anchor, its newest row and the extra [q]."""
    rng = np.random.default_rng(N * 100 + n_kf)
    jm, _ = _random_map(rng, n_kf, N=N)
    q = n_kf - 1
    idx = np.asarray(jm.kf.mp_idx[q])
    ref = np.array(jm.mp.ref_kf)
    ref[idx[idx >= 0][::2]] = q
    return jm._replace(mp=jm.mp._replace(ref_kf=jnp.asarray(ref))), q


_jtop = jax.jit(jcovis.top_covisible_of, static_argnames=("k", "min_weight", "self_weight"))


@pytest.mark.parametrize("self_weight", [0, 2 ** 30], ids=["self_0", "self_pinned"])
@pytest.mark.parametrize("N,n_kf,k", [(16, 12, 8), (16, 12, 16), (16, 5, 32), (4, 4, 12)],
                         ids=["k8", "k16", "k32_few_kfs", "k_above_C"])
def test_top_covisible_of_equals_the_reference(self_weight, N, n_kf, k):
    """Exact rows and flags, including every copy of q: pinned (2**30) it
    fills up to three slots (anchor, newest row, extra), all ok; with
    weight 0 its copies are not ok. k above the candidate count pads."""
    jm, q = _covis_map(n_kf, N)
    ref_rows, ref_ok = _jtop(jm, q, k=k, self_weight=self_weight)
    rows, ok = covis.top_covisible_of(interop.map_from_numpy(jm), q, k, self_weight=self_weight)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    q_ok = int((ok.numpy() & (rows.numpy() == q)).sum())
    if self_weight:
        assert q_ok == 3 and bool(ok[0]) and int(rows[0]) == q
    else:
        assert q_ok == 0 and int(ok.sum()) >= 1


def test_compact_equals_the_reference():
    rng = np.random.default_rng(21)
    jm, _ = _random_map(rng, 12)
    kv = np.array(jm.kf.valid)
    kv[[2, 5, 6]] = False
    first = rng.integers(0, 12, jm.mp.capacity).astype(np.int32)
    jm = jm._replace(kf=jm.kf._replace(valid=jnp.asarray(kv)),
                     mp=jm.mp._replace(first_kf=jnp.asarray(first)))
    ref = jax.jit(jms.compact)(jm)
    got = ms.compact(interop.map_from_numpy(jm))
    _same_map(got.m, ref.m)
    for f in ("kf_old2new", "mp_old2new", "kf_order", "mp_order"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert int(got.m.n_kf) == 9 and bool((got.m.kf.mp_idx[:9] >= -1).all())


def test_cull_keyframes_in_place_equals_the_reference():
    rng = np.random.default_rng(22)
    jm, _ = _random_map(rng, 10)
    kill = rng.random(16) < 0.3
    ref = jms.cull_keyframes(jm, jnp.asarray(kill))
    pm = interop.map_from_numpy(jm)
    got = ms.cull_keyframes(pm, T(kill))
    _same_map(got, ref)
    assert got.kf.valid.data_ptr() == pm.kf.valid.data_ptr()
