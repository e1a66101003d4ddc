"""Vocabulary training of the port (`place/vocab.py`: `kmajority`, `train`,
`train_chunked`, `train_hierarchical`, `build_tree`, `save`) against the JAX
package on the CPU, where every wrapper runs its plain version (K14's on the
card is held against it by chip_smoke.py).

The corpus is structured: 48 random prototypes, each descriptor one of them
with about 10 % of its bits flipped. The initial centres of the two packages
come from different generators (jax.random vs torch.Generator), so the port
gets JAX's own index array (`init_idx`); level 2 of `train_hierarchical`
draws with numpy in both.

Tolerances and why: centre bits, counts, word ids, groups and child tables
exact (integer sums and first-minimum argmins); idf within 1e-6 (the same
f32 log(N / count), each library's own log).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.ops import descriptors as JD
from corbslam_tpu.place import vocab as JV
from corbslam_tpu_torch import interop
from corbslam_tpu_torch.ops import descriptors as D
from corbslam_tpu_torch.place import vocab

torch.set_num_threads(2)


def corpus(n=1500, n_proto=48, flip=0.1, seed=0):
    rng = np.random.default_rng(seed)
    proto = rng.integers(0, 2, (n_proto, 256), dtype=np.uint8)
    bits = proto[rng.integers(0, n_proto, n)] ^ (rng.random((n, 256)) < flip).astype(np.uint8)
    return np.packbits(bits, axis=1, bitorder="little")


def jax_choice(seed, n, k):
    return np.array(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=n < k))


def bits_of(words):
    """Port centres (packed LSB-first) as the reference's 0/1 [W, 256]."""
    return D.unpack_bits(words).numpy().astype(np.int8)


def same_vocab(p, j, tree=False):
    np.testing.assert_array_equal(bits_of(p.words), np.asarray(j.word_bits))
    np.testing.assert_allclose(p.idf.numpy(), np.asarray(j.idf), rtol=0, atol=1e-6)
    if tree:
        np.testing.assert_array_equal(bits_of(p.groups), np.asarray(j.group_bits))
        np.testing.assert_array_equal(p.child_idx.numpy(), np.asarray(j.child_idx))


@pytest.fixture(scope="module")
def desc():
    return corpus()


@pytest.mark.parametrize("W,n_iters", [(64, 5), (256, 3)])
def test_kmajority_and_train_equal_the_reference(desc, W, n_iters):
    idx = jax_choice(0, len(desc), W)
    jbits = JD.unpack_bits(jnp.asarray(desc))
    jw, jc = JV._kmajority(jbits, jbits[idx], W, n_iters)
    d = torch.from_numpy(desc)
    pw, pc = vocab.kmajority(d, d[torch.from_numpy(idx).long()], n_iters)
    np.testing.assert_array_equal(bits_of(pw), np.asarray(jw))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc[-1]))
    same_vocab(vocab.train(d, n_words=W, n_iters=n_iters, init_idx=idx),
               JV.train(jnp.asarray(desc), n_words=W, n_iters=n_iters, seed=0))


def test_the_k_majority_rules_on_crafted_cases():
    """First minimum on ties, 0 on a tied vote, an empty centre keeps its
    bits, the counts (hence idf) come from the last assignment, made against
    the centres before the last update, and a row votes with its weight
    (0 for padding); the first four also against the reference."""
    z = np.zeros(256, np.uint8)

    def pk(*rows):
        return np.packbits(np.stack(rows), axis=1, bitorder="little")

    c0, c1, c2 = z.copy(), z.copy(), z.copy()
    c1[:8] = 1           # distance 8 from c0
    c2[200:] = 1         # far from everything below: stays empty
    a, b = z.copy(), z.copy()
    a[0:4] = 1           # distance 4 to c0 and to c1: a tie, c0 wins
    b[4:8] = 1           # distance 4 to both as well
    x = z.copy()
    x[100] = 1           # nearest c0; with a (which lacks bit 100) a 1-1 vote on bit 100
    desc = pk(a, b, x)
    init = pk(c0, c1, c2)
    d, i = torch.from_numpy(desc), torch.from_numpy(init)
    w1, n1 = vocab.kmajority(d, i, 1)
    assert n1.tolist() == [3, 0, 0]                     # ties go to the first minimum
    bits = bits_of(w1)
    assert bits[0, 100] == 0 and bits[0, :8].sum() == 0  # 1 of 3 and 1 of 3: 2 ones > 3 fails
    np.testing.assert_array_equal(bits[1], c1)           # empty centres keep their bits
    np.testing.assert_array_equal(bits[2], c2)
    # Two rows voting 1-1 on a bit give 0 (2 x 1 > 2 is false).
    w2, n2 = vocab.kmajority(torch.from_numpy(pk(a, x)), torch.from_numpy(pk(c0, c2)), 1)
    assert n2.tolist() == [2, 0] and bits_of(w2)[0].sum() == 0
    for dd, ii in ((desc, init), (pk(a, x), pk(c0, c2))):
        jb = JD.unpack_bits(jnp.asarray(dd))
        jw, jc = JV._kmajority(jb, JD.unpack_bits(jnp.asarray(ii)), ii.shape[0], 1)
        pw, pc = vocab.kmajority(torch.from_numpy(dd), torch.from_numpy(ii), 1)
        np.testing.assert_array_equal(bits_of(pw), np.asarray(jw))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc[-1]))
    # The last counts are those of the assignment against the centres
    # before the last update, not against the final ones.
    rnd = corpus(n=600, n_proto=12, flip=0.2, seed=4)
    r = torch.from_numpy(rnd)
    init = r[:64].clone()
    w_prev, _ = vocab.kmajority(r, init, 2)
    w_last, counts = vocab.kmajority(r, init, 3)
    before = torch.bincount(vocab.assign_flat(r, w_prev).long(), minlength=64)
    after = torch.bincount(vocab.assign_flat(r, w_last).long(), minlength=64)
    assert torch.equal(counts.long(), before) and not torch.equal(before, after)
    idf = vocab.idf_of(counts)
    np.testing.assert_allclose(idf.numpy(), np.log(600.0 / np.maximum(before.numpy(), 1)),
                               rtol=1e-6)
    # Row weights: a row of weight w votes as w copies of it, and rows of
    # weight 0 (the reference's chunk padding) vote for nothing.
    w = torch.from_numpy(np.random.default_rng(5).integers(0, 3, 600).astype(np.int32))
    ww, wc = vocab.kmajority(r, init, 3, weight=w)
    rw, rc = vocab.kmajority(r.repeat_interleave(w.long(), dim=0), init, 3)
    assert torch.equal(ww, rw) and torch.equal(wc, rc) and int(wc.sum()) == int(w.sum())


def edge_case(name):
    """(packed rows, packed initial centres, iterations, row weights) at one
    of K14's edges: centres tied across its staging passes of 1024 and
    inside a tile of 8 (a row one bit from each of two centres, a row on a
    centre that repeats), every row identical, N and W off the tile widths
    (1013 x 77), row weights 0-2."""
    rng = np.random.default_rng(11)
    pk = lambda b: np.packbits(b, axis=1, bitorder="little")  # noqa: E731
    if name == "cross_tile_tie":
        init = rng.integers(0, 2, (1100, 256), dtype=np.uint8)
        init[1030] = init[5]
        init[1027] = init[3]
        init[1027, :2] ^= 1
        init[12] = init[9]
        init[12, 100:102] ^= 1
        bits = rng.integers(0, 2, (300, 256), dtype=np.uint8)
        bits[0] = init[3]
        bits[0, 0] ^= 1
        bits[1] = init[9]
        bits[1, 100] ^= 1
        bits[2] = init[5]
        return pk(bits), pk(init), 2, None
    if name == "identical":
        return np.repeat(corpus(n=1, seed=3), 3000, 0), corpus(n=16, seed=4), 3, None
    if name == "ragged":
        return corpus(n=1013, seed=5), corpus(n=77, seed=6), 4, None
    d = corpus(n=900, seed=7)
    return d, d[rng.choice(900, 96, replace=False)], 3, rng.integers(0, 3, 900).astype(np.int32)


@pytest.mark.parametrize("name", ["cross_tile_tie", "identical", "ragged", "zero_weights"])
def test_kmajority_at_the_kernels_edges_equals_the_reference(name):
    """The plain version K14 is held to, against JAX's `_kmajority`, at the
    kernel's edges; a weighted row votes as that many copies of itself in
    the reference (weight 0: left out)."""
    desc, init, n_iters, w = edge_case(name)
    jd = desc if w is None else np.repeat(desc, w, 0)
    jb = JD.unpack_bits(jnp.asarray(jd))
    jw, jc = JV._kmajority(jb, JD.unpack_bits(jnp.asarray(init)), init.shape[0], n_iters)
    pw, pc = vocab.kmajority(torch.from_numpy(desc), torch.from_numpy(init), n_iters,
                             weight=None if w is None else torch.from_numpy(w))
    np.testing.assert_array_equal(bits_of(pw), np.asarray(jw))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc[-1]))
    if name == "cross_tile_tie":  # the first of two equidistant centres wins
        a = vocab.assign_flat(torch.from_numpy(desc), torch.from_numpy(init))
        assert a[:3].tolist() == [3, 9, 5]
        assert a.tolist() == np.asarray(JV._assign(jb, JD.unpack_bits(jnp.asarray(init)))).tolist()
    elif name == "identical":
        assert int(pc.max()) == 3000


def test_train_hierarchical_with_empty_groups_equals_the_reference():
    """Every row one of 3 exact prototypes, so at least 5 of the 8 level-1
    centres are repeats that never win: their level-2 blocks have no member
    and keep the group centre."""
    proto = corpus(n=3, flip=0.0, seed=8)
    desc = proto[np.random.default_rng(9).integers(0, 3, 700)]
    G, B, seed = 8, 4, 2
    j = JV.train_hierarchical(desc, n_groups=G, words_per_group=B, n_iters=3, seed=seed,
                              chunk=512)
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    idx = np.array(jax.random.choice(k1, len(desc), (G,), replace=len(desc) < G))
    p = vocab.train_hierarchical(torch.from_numpy(desc), n_groups=G, words_per_group=B,
                                 n_iters=3, seed=seed, chunk=512, init_idx=idx)
    same_vocab(p, j, tree=True)
    grp = vocab.assign_flat(torch.from_numpy(desc), p.groups)
    assert len(set(grp.tolist())) <= 3


def test_train_chunked_reaches_the_references_fixed_point(desc):
    W, chunk = 128, 512  # 1500 rows: the last chunk is partial (padded in JAX)
    j = JV.train_chunked(desc, n_words=W, n_iters=4, seed=3, chunk=chunk)
    p = vocab.train_chunked(torch.from_numpy(desc), n_words=W, n_iters=4, chunk=chunk,
                            init_idx=jax_choice(3, len(desc), W))
    same_vocab(p, j)
    flat = vocab.train(torch.from_numpy(desc), n_words=W, n_iters=4,
                       init_idx=jax_choice(3, len(desc), W))
    assert torch.equal(flat.words, p.words) and torch.equal(flat.idf, p.idf)


def test_train_hierarchical_equals_the_reference():
    desc = corpus(n=2000, seed=1)
    G, B, seed = 8, 4, 5
    j = JV.train_hierarchical(desc, n_groups=G, words_per_group=B, n_iters=4, seed=seed,
                              chunk=512)
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    idx = np.array(jax.random.choice(k1, len(desc), (G,), replace=len(desc) < G))
    p = vocab.train_hierarchical(torch.from_numpy(desc), n_groups=G, words_per_group=B,
                                 n_iters=4, seed=seed, chunk=512, init_idx=idx)
    same_vocab(p, j, tree=True)
    # Word ids through the tree (top-2 descent) agree as well.
    q = torch.from_numpy(desc[:300])
    pj = interop.vocab_from_numpy(j)
    assert torch.equal(vocab.assign(p, q), vocab.assign(pj, q))


def test_build_tree_equals_the_reference(desc):
    base = JV.train(jnp.asarray(desc), n_words=256, n_iters=3, seed=2)
    j = JV.build_tree(base, n_groups=16, n_iters=4, seed=0)
    idx = jax_choice(101, 256, 16)
    p = vocab.build_tree(interop.vocab_from_numpy(base), n_groups=16, n_iters=4, init_idx=idx)
    same_vocab(p, j, tree=True)


def test_a_saved_port_vocabulary_loads_in_the_reference(desc, tmp_path):
    d = torch.from_numpy(desc)
    p = vocab.train_hierarchical(d, n_groups=4, words_per_group=8, n_iters=3, seed=9)
    path = str(tmp_path / "voc.npz")
    vocab.save(p, path)
    j = JV.load(path)
    same_vocab(p, j, tree=True)
    back = vocab.load(path, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, p))


def test_the_ports_own_draw_is_seeded_and_follows_the_replacement_rule(desc):
    d = torch.from_numpy(desc[:100])
    a, b = vocab.train(d, 64, 2, seed=4), vocab.train(d, 64, 2, seed=4)
    assert torch.equal(a.words, b.words) and torch.equal(a.idf, b.idf)
    idx = vocab._draw(100, 64, 4, torch.device("cpu"), None)
    assert len(set(idx.tolist())) == 64                  # n >= W: distinct rows
    idx = vocab._draw(10, 64, 4, torch.device("cpu"), None)
    assert idx.shape == (64,) and int(idx.max()) < 10    # n < W: with replacement
