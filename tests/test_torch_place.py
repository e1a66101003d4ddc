"""The port's place recognition (`place/vocab.py`, `place/database.py`: kernel
K9's plain versions) against the JAX package, on the shipped vocabulary
(`assets/vocab32k.npz`, with its 2-level tree) and on a synthetic map given to
both packages through `interop.map_from_numpy`.

Tolerances and why: word ids, candidate rows and ok flags are integer
decisions on integer Hamming distances and are exact (the shipped file's
centres are packed MSB-first; the port repacks them LSB-first like
descriptors, and the ids prove the bit order). BoW vectors, sparse weights
and L1 scores within 1e-6: the same f32 products, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.config import CapacityConfig as JCapacity
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu.ops import descriptors as JD
from corbslam_tpu.place import database as JDB
from corbslam_tpu.place import vocab as JV
from corbslam_tpu_torch import interop
from corbslam_tpu_torch.place import database, vocab

torch.set_num_threads(2)


def t_(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def vocs():
    return JV.load_default(), vocab.load_default("cpu")


def corrupt(rng, desc, n_bits):
    out = desc.copy()
    for i in range(out.shape[0]):
        for b in rng.integers(0, 256, n_bits):
            out[i, b // 8] ^= np.uint8(1 << (b % 8))
    return out


def descriptors(rng, voc_port, n=512):
    """Random descriptors and ones one to three bits from a word centre
    (near-ties between words and between groups)."""
    near = voc_port.words.numpy()[rng.integers(0, voc_port.n_words, n // 2)]
    near = corrupt(rng, near, 2)
    return np.concatenate([rng.integers(0, 256, (n - n // 2, 32), dtype=np.uint8), near])


_assign_tree = jax.jit(lambda d, v: JV._assign_tree(JD.unpack_bits(d), v))


def test_vocabulary_from_the_references_fields_equals_the_loaded_one(vocs):
    jv, pv = vocs
    ov = interop.vocab_from_numpy(jv)
    for a, b in zip(ov, pv):
        assert torch.equal(a, b)
    assert pv.words.shape == (32768, 32) and pv.groups.shape == (1024, 32)


def test_word_ids_on_the_shipped_tree_are_exact(vocs):
    jv, pv = vocs
    d = descriptors(np.random.default_rng(0), pv)
    ref = np.asarray(_assign_tree(jnp.asarray(d), jv))
    assert np.array_equal(vocab.assign(pv, t_(d)).numpy(), ref)


def test_flat_assignment_and_bow_on_a_1024_word_subset(vocs):
    jv, pv = vocs
    rng = np.random.default_rng(1)
    jflat = JV.Vocabulary(word_bits=jv.word_bits[:1024], idf=jv.idf[:1024])
    pflat = vocab.Vocabulary(pv.words[:1024].contiguous(), pv.idf[:1024].contiguous())
    d = descriptors(rng, pflat)
    ref = np.asarray(jax.jit(lambda a, w: JV._assign(JD.unpack_bits(a), w))(
        jnp.asarray(d), jflat.word_bits))
    assert np.array_equal(vocab.assign(pflat, t_(d)).numpy(), ref)
    valid = rng.random(d.shape[0]) < 0.8
    np.testing.assert_allclose(vocab.transform(pflat, t_(d), t_(valid)).numpy(),
                               np.asarray(JV.transform(jflat, jnp.asarray(d), jnp.asarray(valid))),
                               rtol=0, atol=1e-6)


def test_bow_sparse_and_scores_on_the_shipped_tree(vocs):
    jv, pv = vocs
    rng = np.random.default_rng(2)
    d = descriptors(rng, pv)
    valid = rng.random(d.shape[0]) < 0.8
    v = vocab.transform(pv, t_(d), t_(valid))
    vj = np.asarray(JV.transform(jv, jnp.asarray(d), jnp.asarray(valid)))
    np.testing.assert_allclose(v.numpy(), vj, rtol=0, atol=1e-6)
    ids, vals = vocab.transform_sparse(pv, t_(d), t_(valid))
    idj, vaj = JV.transform_sparse(jv, jnp.asarray(d), jnp.asarray(valid))
    assert np.array_equal(ids.numpy(), np.asarray(idj))
    np.testing.assert_allclose(vals.numpy(), np.asarray(vaj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(vocab.densify_bow(pv.n_words, ids, vals).numpy(), vj, atol=1e-6)
    db = np.stack([vj, np.zeros_like(vj), np.asarray(JV.transform(
        jv, jnp.asarray(corrupt(rng, d, 20)), jnp.asarray(valid)))])
    q = np.stack([vj, db[2]])
    np.testing.assert_allclose(vocab.l1_scores_batch(t_(q), t_(db)).numpy(),
                               np.asarray(JV.l1_scores_batch(jnp.asarray(q), jnp.asarray(db))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(vocab.l1_scores(t_(vj), t_(db)).numpy(),
                               np.asarray(JV.l1_scores(jnp.asarray(vj), jnp.asarray(db))),
                               rtol=0, atol=1e-6)


N_KF, F, M = 32, 64, 1024


def synthetic_state(jv, rng):
    """A 28-keyframe map (two culled rows) whose neighbours share points,
    keyframe 25 revisiting keyframe 3's view (its descriptors, not its
    points: a loop before fusion), and a database of every live
    row but the query's (its loop stage still queued) and one stale row."""
    cap = JCapacity(max_keyframes=N_KF, max_map_points=M, max_features=F, local_window_kfs=8,
                    local_window_mps=256)
    n = 28
    mp_idx = np.full((N_KF, F), -1, np.int32)
    for i in range(n):
        mp_idx[i, :50] = rng.choice(np.arange(i * 30, i * 30 + 90) % M, 50, replace=False)
    fvalid = np.zeros((N_KF, F), bool)
    fvalid[:n, :56] = True
    valid = np.zeros(N_KF, bool)
    valid[:n] = True
    valid[[7, 19]] = False
    mp_idx[[7, 19]] = -1
    desc = rng.integers(0, 256, (N_KF, F, 32), dtype=np.uint8)
    desc[25] = corrupt(rng, desc[3], 6)
    desc[24] = corrupt(rng, desc[4], 10)
    m = jms.empty(cap)
    m = m._replace(
        kf=m.kf._replace(mp_idx=jnp.asarray(mp_idx), fvalid=jnp.asarray(fvalid),
                         valid=jnp.asarray(valid), desc=jnp.asarray(desc)),
        mp=m.mp._replace(valid=jnp.ones(M, bool),
                         ref_kf=jnp.asarray(np.minimum(np.arange(M) // 30, n - 1), jnp.int32)),
        n_kf=jnp.int32(n), n_mp=jnp.int32(M))
    bows = np.asarray(jax.vmap(lambda d, v: JV.transform(jv, d, v))(
        jnp.asarray(desc), jnp.asarray(fvalid)))
    dbv = valid.copy()
    dbv[25] = False
    bow = np.where(dbv[:, None], bows, 0.0).astype(np.float32)
    bow[19] = bows[3]  # a stale row of a culled keyframe
    return m, JDB.BowDatabase(jnp.asarray(bow), jnp.asarray(dbv)), bows[25]


def test_loop_and_relocalization_candidates_are_exact(vocs):
    jv, pv = vocs
    m, jdb, q = synthetic_state(jv, np.random.default_rng(3))
    pm = interop.map_from_numpy(m)
    pdb = interop.db_from_numpy(jdb)
    rows, ok = database.detect_loop_candidates(pdb, pm, 25, t_(q), k=8)
    rj, oj = JDB.detect_loop_candidates(jdb, m, 25, jnp.asarray(q), k=8)
    assert np.array_equal(rows.numpy(), np.asarray(rj)) and np.array_equal(ok.numpy(), np.asarray(oj))
    assert ok.any() and 3 in rows[ok].tolist()
    rows, ok = database.detect_relocalization_candidates(pdb, pm, t_(q), k=8)
    rj, oj = JDB.detect_relocalization_candidates(jdb, m, jnp.asarray(q), k=8)
    assert np.array_equal(rows.numpy(), np.asarray(rj)) and np.array_equal(ok.numpy(), np.asarray(oj))


def test_database_add_remove_reorder_are_exact(vocs):
    jv, _ = vocs
    m, jdb, _ = synthetic_state(jv, np.random.default_rng(4))
    pdb = interop.db_from_numpy(jdb)
    rng = np.random.default_rng(5)
    kill = rng.random(N_KF) < 0.3
    a, b = pdb.remove(t_(kill)), jdb.remove(jnp.asarray(kill))
    assert torch.equal(a.valid, t_(b.valid))
    order = rng.permutation(N_KF).astype(np.int32)
    a, b = a.reorder(t_(order), 20), b.reorder(jnp.asarray(order), 20)
    assert np.array_equal(interop.db_to_numpy(a)["bow"], np.asarray(b.bow))
    assert np.array_equal(a.valid.numpy(), np.asarray(b.valid))
    rows = np.array([3, 5, 3, 9, 31, 5], np.int32)   # duplicates: the last lane wins
    ok = np.array([True, True, True, False, True, True])
    vs = rng.random((6, a.bow.shape[1])).astype(np.float32)
    a, b = a.add_batch(t_(rows), t_(vs), t_(ok)), b.add_batch(jnp.asarray(rows), jnp.asarray(vs),
                                                               jnp.asarray(ok))
    assert np.array_equal(a.bow.numpy(), np.asarray(b.bow))
    assert np.array_equal(a.valid.numpy(), np.asarray(b.valid))
    a, b = a.add(11, t_(vs[0])), b.add(11, jnp.asarray(vs[0]))
    assert np.array_equal(a.bow.numpy(), np.asarray(b.bow))
