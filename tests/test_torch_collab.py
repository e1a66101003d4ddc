"""The port's collaboration layer (`corbslam_tpu_torch.collab`, `apps.run_collab`)
against the JAX package's, on the CPU, with the same numpy inputs and the
small configuration of tests/test_collab.py.

Held: the chunk insertions exactly; `transform_map` / `transform_poses` to
1e-5; the weighted Horn's plain version (the order of K10's weighted-Horn
kernel: its sums' order and its squared power tail) to 1e-5 in R and s and
1e-5 m in t (with weights, all weights 0, K = 1, fix_scale both ways, a
small eigengap, points 100 m from the origin); the batched BoW transform
(the order of K9's batched launch: its word ids, the norm over the sorted
runs) to 1e-6 with word ids exact (one row, F 61, no valid feature, every
descriptor equal); the fusion pairs exactly, ties
included; `detect_overlap` with JAX's PnP sample (inliers exact, R and t to
1e-4). Then the two-client rig of tests/test_collab.py through both
packages' servers and caches, built once per side (the port's PnP draws are
JAX's, handed in): alignments to 1e-4, fused flags, global keyframes and
points exact, the seam fuse and essential-graph counts, the foreign
entities after the broadcast, keyframe poses to 1e-4; then, on the same
rigs, the pose-update round trip, the late-join resync, compaction under
collaboration and a failed uplink's retry, with the reference test bodies'
assertions on both sides and the outcomes compared. Then the foreign
keyframes' BoW in a loop closer's database, ten clients
uplinking from their own threads while the server fuses (its lock must lose
no entity), and `run_collab` on the CPU with two clients over 8 frames,
held to its invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_collab as J
from corbslam_tpu.collab import fusion_ops as jfo
from corbslam_tpu.collab.client_cache import ClientCache as JCache
from corbslam_tpu.collab.server import MapFusionServer as JServer
from corbslam_tpu.collab.transport import InProcTransport as JTransport
from corbslam_tpu.geometry import sim3 as jsim3
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu.ops import descriptors as jD
from corbslam_tpu.place import database as jdb
from corbslam_tpu.place import vocab as jvocab
from corbslam_tpu.solvers import sim3_solver as jsolver
from corbslam_tpu_torch import config, interop
from corbslam_tpu_torch.collab import fusion_ops
from corbslam_tpu_torch.collab import server as server_mod
from corbslam_tpu_torch.collab.client_cache import ClientCache
from corbslam_tpu_torch.collab.server import MapFusionServer
from corbslam_tpu_torch.collab.transport import InProcTransport
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.mapstate import mapstate as ms
from corbslam_tpu_torch.ops import descriptors as D
from corbslam_tpu_torch.place import database, vocab
from corbslam_tpu_torch.solvers import sim3_solver

torch.set_num_threads(2)

CAM = camera.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320,
                               height=240)
CFG = config.SlamConfig(
    orb=config.OrbConfig(n_features=128, n_levels=4),
    capacity=config.CapacityConfig(max_keyframes=32, max_map_points=2048, max_features=128,
                                   local_window_kfs=8, local_window_mps=512),
)


def t_(a):
    return torch.from_numpy(np.array(a))


def close(a, b, tol):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=tol)


class Tracker:
    """Map holder standing in for StereoTracker (ClientCache needs `.map`)."""

    def __init__(self, m):
        self.map = m


def port_map(jm):
    return interop.map_from_numpy(jm, "cpu")


@pytest.fixture(scope="module")
def vocs():
    rng = np.random.default_rng(3)
    jv = jvocab.train(jnp.asarray(rng.integers(0, 256, (2000, 32), dtype=np.uint8)),
                      n_words=128, n_iters=4)
    return jv, interop.vocab_from_numpy(jv, "cpu")


def shared_desc():
    return np.random.default_rng(7).integers(0, 256, (60, 32), dtype=np.uint8)


def client_maps():
    """The reference test's two client maps (JAX), client 2 in its own frame."""
    t1 = J.build_client_map(np.random.default_rng(1), 1, np.eye(4, dtype=np.float32),
                            shared_desc())
    t2 = J.build_client_map(np.random.default_rng(2), 2, J.T2_world(), shared_desc())
    return t1.map, t2.map


# ---------------------------------------------------------------------------
# fusion_ops
# ---------------------------------------------------------------------------

def test_insert_chunks_equal_the_reference():
    """Chunks with unused lanes in the middle, into a map that already holds
    rows: every table exact, rows -1 on the unused lanes."""
    jm, _ = client_maps()
    m = port_map(jm)
    rng = np.random.default_rng(5)
    C, F = 12, CFG.capacity.max_features
    use = rng.random(C) < 0.6
    use[0] = True
    fixed = rng.random(C) < 0.5
    mp_args = [rng.normal(size=(C, 3)).astype(np.float32), rng.normal(size=(C, 3)).astype(np.float32),
               rng.integers(0, 256, (C, 32), dtype=np.uint8), rng.random(C).astype(np.float32),
               rng.random(C).astype(np.float32) + 2, np.full(C, 3, np.int32),
               rng.integers(0, 3, C).astype(np.int32)]
    jm2, jrows = jfo.insert_mp_chunk(jm, *map(jnp.asarray, mp_args), jnp.asarray(use),
                                     jnp.asarray(fixed))
    m2, rows = fusion_ops.insert_mp_chunk(m, *map(t_, mp_args), t_(use), t_(fixed))
    kf_args = [np.tile(np.eye(4, dtype=np.float32), (C, 1, 1)), rng.random((C, F, 2)).astype(np.float32),
               rng.integers(0, 4, (C, F)).astype(np.int32), rng.random((C, F)).astype(np.float32),
               rng.integers(0, 256, (C, F, 32), dtype=np.uint8), rng.random((C, F)).astype(np.float32),
               rng.random((C, F)).astype(np.float32), rng.random((C, F)) < 0.5,
               rng.integers(-1, 100, (C, F)).astype(np.int32), np.full(C, 3, np.int32),
               np.arange(C, dtype=np.int32), np.arange(C, dtype=np.float32)]
    jm3, jkrows = jfo.insert_kf_chunk(jm2, *map(jnp.asarray, kf_args), jnp.asarray(use),
                                      jnp.asarray(fixed))
    m3, krows = fusion_ops.insert_kf_chunk(m2, *map(t_, kf_args), t_(use), t_(fixed))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(krows.numpy(), np.asarray(jkrows))
    a, b = interop.map_to_numpy(m3), interop.map_to_numpy(port_map(jm3))
    assert (a["n_kf"], a["n_mp"]) == (b["n_kf"], b["n_mp"])
    for part in ("kf", "mp"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part}.{k}")


def test_transform_map_and_poses_equal_the_reference():
    jm, _ = client_maps()
    m = port_map(jm)
    xi = np.asarray([0.5, 0.2, -0.1, 0.1, 0.2, 0.3, 0.4], np.float32)
    jS = jsim3.exp(jnp.asarray(xi))
    S = tuple(t_(x) for x in jS)
    jm2 = jfo.transform_map(jm, *jS)
    m2 = fusion_ops.transform_map(m, *S)
    a, b = interop.map_to_numpy(m2), interop.map_to_numpy(port_map(jm2))
    for part in ("kf", "mp"):
        for k in a[part]:
            close(a[part][k], b[part][k], 1e-5)
    np.testing.assert_array_equal(interop.map_to_numpy(m)["mp"]["pos"],
                                  np.asarray(jm.mp.pos))  # the input map is left as it was
    T = np.asarray(jm.kf.Tcw[:3])
    close(fusion_ops.transform_poses(t_(T), S), jfo.transform_poses(jnp.asarray(T), jS), 1e-5)


def power_share(p1, p2, w) -> float:
    """The second eigenvector's share in the reference's 100 shifted power
    iterations of Horn's N, in float64 (how far they are from converged)."""
    wn = w / max(w.sum(), 1e-12)
    q1 = (p1 - (p1 * wn[:, None]).sum(0)) * np.sqrt(wn)[:, None]
    q2 = (p2 - (p2 * wn[:, None]).sum(0)) * np.sqrt(wn)[:, None]
    (Sxx, Sxy, Sxz), (Syx, Syy, Syz), (Szx, Szy, Szz) = q2.T @ q1
    N = np.array([[Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
                  [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
                  [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
                  [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]])
    d = np.diag(N)
    Ns = N + max(-(d - (np.abs(N).sum(1) - np.abs(d))).min(), 0.0) * np.eye(4)
    v = np.ones(4)
    for _ in range(100):
        v = Ns @ v
        v /= np.linalg.norm(v)
    return float(abs(np.linalg.eigh(Ns)[1][:, -2] @ v))


@pytest.mark.parametrize("K,weights", [(1, "ones"), (3, "ones"), (7, "random"), (300, "random"),
                                       (700, "random"), (40, "zero"), (64, "small_gap"),
                                       (300, "far")])
def test_weighted_horn_plain_equals_the_reference(K, weights):
    """Also with a small eigengap (points near a line: 100 iterations leave
    the second eigenvector's share above 1e-3, so the squared tail must give
    the truncated answer, not the converged one) and with points about 100 m
    from the origin (the centroids' cancellation). There t is held to 1e-4 m:
    an f32 ulp at 100 m is 7.6e-6 m, and any other order of the centroid
    sums (XLA's) moves t by a few of them."""
    rng = np.random.default_rng(K)
    p2 = rng.normal(size=(K, 3)).astype(np.float32) * 4
    if weights == "small_gap":
        p2 = (np.outer(rng.uniform(-5, 5, K), [0.6, 0.8, 0.0])
              + rng.normal(size=(K, 3)) * 0.3).astype(np.float32)
    if weights == "far":
        p2 = p2 + np.asarray([60.0, -70.0, 40.0], np.float32)
    jS = jsim3.exp(jnp.asarray(rng.normal(size=7).astype(np.float32) * 0.3))
    p1 = np.asarray(jsim3.transform(jS, jnp.asarray(p2))) + rng.normal(size=(K, 3)).astype(
        np.float32) * 0.01
    w = {"ones": np.ones(K), "zero": np.zeros(K), "small_gap": np.ones(K),
         "random": (rng.random(K) > 0.3) * rng.random(K),
         "far": (rng.random(K) > 0.3) * 1.0}[weights].astype(np.float32)
    if weights == "small_gap":
        assert power_share(p1.astype(np.float64), p2.astype(np.float64), w.astype(np.float64)) > 1e-3
    if weights == "far":
        assert np.linalg.norm(p2.mean(0)) > 90
    for fix in (True, False):
        a = sim3_solver.horn_sim3(t_(p1), t_(p2), fix, w=t_(w))
        b = jsolver.horn_sim3(jnp.asarray(p1), jnp.asarray(p2), fix, w=jnp.asarray(w))
        for x, y, tol in zip(a, b, (1e-5, 1e-4 if weights == "far" else 1e-5, 1e-5)):
            close(x, y, tol)
    assert torch.equal(sim3_solver.horn_sim3(t_(p1), t_(p2), False, w=t_(w))[0],
                       sim3_solver.horn_weighted_plain(t_(p1), t_(p2), t_(w), False)[0])


@pytest.mark.parametrize("ex", [-100, 100])
def test_weighted_horn_tail_holds_at_any_scale(ex):
    """The squared tail scales Ns before its first product, so a matrix at
    2^-100 or 2^100 (products that would under- or overflow f32) gives the
    vector it gives at scale 1, bit for bit, within 1e-5 of the reference's
    normalized 100 iterations in float64."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(4, 4))
    N = A + A.T
    d = np.diag(N)
    Ns = N + max(-(d - (np.abs(N).sum(1) - np.abs(d))).min(), 0.0) * np.eye(4)
    v = np.ones(4)
    for _ in range(100):
        v = Ns @ v
        v /= np.linalg.norm(v)
    Nt = t_(Ns.astype(np.float32))
    base = sim3_solver.horn_power_tail(Nt)
    scaled = sim3_solver.horn_power_tail(Nt * 2.0 ** ex)
    assert torch.isfinite(scaled).all() and torch.equal(scaled, base)
    close(scaled, v, 1e-5)


# ---------------------------------------------------------------------------
# place: the batched BoW transform and the fusion pairs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tree_vocs():
    return (jvocab.load(jvocab.default_artifact_path()),
            vocab.load(vocab.default_artifact_path(), device="cpu"))


@pytest.mark.parametrize("tree", [False, True])
def test_the_tree_layout_is_made_with_the_vocabulary(vocs, tree_vocs, tree, monkeypatch):
    """A loaded tree carries its child blocks group by group for the batched
    launch: slot j of group g holds word child_idx[g, j] (zeros where
    padded) and the key (popc + 256) << 16 | j (0xFFFF << 16 | j padded, -1
    past C); a flat vocabulary carries none. On the card a tree without
    them raises (checked here with CUDA tensors faked)."""
    pv = (tree_vocs if tree else vocs)[1]
    if not tree:
        assert pv.child_words is None and pv.child_keys is None
        return
    G, C = pv.child_idx.shape
    Cp = -(-C // 8) * 8
    assert pv.child_words.shape == (G, Cp, 32) and pv.child_keys.shape == (G, Cp)
    kid = pv.child_idx.long()
    real = kid >= 0
    want = torch.where(real[..., None], pv.words[kid.clamp_min(0)], torch.zeros((), dtype=torch.uint8))
    assert torch.equal(pv.child_words[:, :C], want)
    assert not pv.child_words[:, C:].any()
    j = torch.arange(C).expand(G, C)
    keys = pv.child_keys[:, :C].long() & 0xFFFFFFFF
    pop = D.popcount_desc(want).long()
    assert torch.equal(keys, torch.where(real, ((pop + 256) << 16) | j, (0xFFFF << 16) | j))
    assert (pv.child_keys[:, C:] == -1).all()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(vocab.kernels, "check", lambda *a, **k: None)
    with pytest.raises(ValueError, match="child_words"):
        vocab.transform_batch_words(pv._replace(child_words=None),
                                    torch.zeros(1, 16, 32, dtype=torch.uint8),
                                    torch.ones(1, 16, dtype=torch.bool))


@pytest.mark.parametrize("case", ["rows", "b1", "f61", "all_invalid", "all_equal"])
@pytest.mark.parametrize("tree", [False, True])
def test_transform_batch_equals_the_reference(vocs, tree_vocs, tree, case):
    """[B, F] descriptors of B keyframes: the rig's 128-word vocabulary, and
    the shipped vocab32k tree; rows with no valid feature and a padded row;
    one row; F 61, off every tile width; every row invalid; every descriptor
    equal (one word takes every count). Word ids exact (-1 where invalid),
    BoW 1e-6."""
    jv, pv = tree_vocs if tree else vocs
    rng = np.random.default_rng(11)
    B, F = {"b1": (1, 64), "f61": (3, 61)}.get(case, (5, 64))
    desc = rng.integers(0, 256, (B, F, 32), dtype=np.uint8)
    valid = rng.random((B, F)) < 0.8
    if case == "rows":
        desc[3] = desc[2]
        valid[1] = False
    if case == "all_invalid":
        valid[:] = False
    if case == "all_equal":
        desc[:] = desc[0, 0]
    a, words = vocab.transform_batch_words(pv, t_(desc), t_(valid))
    b = jvocab.transform_batch(jv, jnp.asarray(desc), jnp.asarray(valid))
    assert a.shape == (B, pv.n_words)
    close(a, b, 1e-6)
    assert torch.equal(a, vocab.transform_batch(pv, t_(desc), t_(valid)))
    if case == "rows":
        close(vocab.transform_many(pv, t_(desc), t_(valid)), jvocab.transform_many(
            jv, jnp.asarray(desc), jnp.asarray(valid)), 1e-6)
    if case == "all_equal":
        assert ((a > 0).sum(dim=1) == 1).all()
    for r in range(B):
        bits = jD.unpack_bits(jnp.asarray(desc[r]))
        ref = np.asarray(jvocab._assign_tree(bits, jv) if tree else jvocab._assign(
            bits, jv.word_bits))
        np.testing.assert_array_equal(words[r].numpy(), np.where(valid[r], ref, -1))


def test_detect_map_fusion_pairs_equal_the_reference(vocs):
    """Duplicated database rows and duplicated queries make tied scores: the
    flat order (lower index first) must match lax.top_k's."""
    jv, pv = vocs
    rng = np.random.default_rng(2)
    N, Q, F = 12, 6, 40
    desc = rng.integers(0, 256, (N, F, 32), dtype=np.uint8)
    desc[5], desc[9] = desc[1], desc[1]
    valid = np.ones((N, F), bool)
    bow = np.asarray(jvocab.transform_batch(jv, jnp.asarray(desc), jnp.asarray(valid)))
    dbv = np.ones(N, bool)
    dbv[7] = False
    kfv = np.ones(N, bool)
    kfv[10] = False
    q = np.concatenate([bow[[1, 1, 3, 9]], bow[[0, 0]]])
    q_ok = np.asarray([True, True, True, True, True, False])
    jd = jdb.BowDatabase(jnp.asarray(bow), jnp.asarray(dbv))
    b = jdb.detect_map_fusion_pairs(jd, jnp.asarray(kfv), jnp.asarray(q), jnp.asarray(q_ok))
    a = database.detect_map_fusion_pairs(database.BowDatabase(t_(bow), t_(dbv)), t_(kfv), t_(q),
                                         t_(q_ok))
    for x, y in zip(a[:2] + a[3:], b[:2] + b[3:]):  # (query, row) pairs and ok exact
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    close(a[2], b[2], 1e-6)  # the scores, summed in another order
    jm = jms.empty(J.CFG.capacity)
    jm = jm._replace(kf=jm.kf._replace(valid=jnp.ones(32, bool)))
    pm = port_map(jm)
    bow32 = np.zeros((32, bow.shape[1]), np.float32)
    bow32[:N] = bow
    dbv32 = np.zeros(32, bool)
    dbv32[:N] = dbv
    rb, ob = jdb.detect_map_fusion_candidates(jdb.BowDatabase(jnp.asarray(bow32),
                                                              jnp.asarray(dbv32)), jm,
                                              jnp.asarray(bow[3]))
    ra, oa = database.detect_map_fusion_candidates(database.BowDatabase(t_(bow32), t_(dbv32)),
                                                   pm, t_(bow[3]))
    np.testing.assert_array_equal(ra.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(oa.numpy(), np.asarray(ob))


# ---------------------------------------------------------------------------
# The two-client rig, once per side
# ---------------------------------------------------------------------------

def jax_sample(key, hit: torch.Tensor) -> torch.Tensor:
    """The PnP sample the JAX detect_overlap draws from `key` (its first
    split) over the matched features `hit`."""
    k1, _ = jax.random.split(key)
    probs = jnp.asarray(hit.numpy()).astype(jnp.float32)
    idx = jax.random.choice(k1, hit.shape[0], shape=(256, 6),
                            p=probs / jnp.maximum(jnp.sum(probs), 1.0))
    return torch.from_numpy(np.array(idx, np.int32))


class JaxDraws:
    """Hands the port server's detect_overlap calls the samples that the JAX
    server (seed 0) draws for its calls in the same order."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)
        self.real = fusion_ops.detect_overlap

    def __call__(self, cam, gmap, cand_row, sub, query_row, cfg, generator=None,
                 fix_scale=True, idx=None):
        self.key, k = jax.random.split(self.key)
        hit = fusion_ops.overlap_matches(gmap, cand_row, sub, query_row, cfg).hit
        return self.real(cam, gmap, cand_row, sub, query_row, cfg, fix_scale=fix_scale,
                         idx=jax_sample(k, hit))


def build_rig(jv, pv, jax_side: bool, drop_calls: int = 0):
    jm1, jm2 = client_maps()
    if jax_side:
        tr = JTransport(serialize=True, drop_calls=drop_calls)
        srv = JServer(J.CAM, J.CFG, jv, tr, run_gba=False)
        caches = [JCache(J.FakeTracker(), tr, c, J.CFG) for c in (1, 2)]
        caches[0].tracker.map, caches[1].tracker.map = jm1, jm2
    else:
        tr = InProcTransport(serialize=True, drop_calls=drop_calls)
        srv = MapFusionServer(CAM, CFG, pv, tr, run_gba=False, device="cpu")
        caches = [ClientCache(Tracker(port_map(m)), tr, c, CFG) for c, m in ((1, jm1), (2, jm2))]
    return tr, srv, caches


@pytest.fixture(scope="module")
def rigs(vocs):
    """Both rigs after: client 1 uplinks, fuse (seed), client 2 uplinks, fuse
    (align + merge), broadcast, both downlinks. Also the global map and
    client 2's sub-map between its uplink and the second fuse."""
    jv, pv = vocs
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(server_mod.fusion_ops, "detect_overlap", JaxDraws())
    try:
        for side in ("jax", "port"):
            tr, srv, (c1, c2) = build_rig(jv, pv, side == "jax")
            assert c1.uplink_step() and srv.fuse_step()
            assert c2.uplink_step()
            before = (interop.map_to_numpy(srv.gmap), interop.map_to_numpy(srv.sub[2].map))
            assert srv.fuse_step()
            srv.broadcast_step()
            n_kf_1 = int(c1.tracker.map.n_kf)
            c1.downlink_step()
            c2.downlink_step()
            out[side] = dict(tr=tr, srv=srv, c1=c1, c2=c2, before=before, n_kf_1=n_kf_1)
    finally:
        mp.undo()
    return out


def test_detect_overlap_equals_the_reference(rigs):
    """Global map and client 2's sub-map just before the alignment, keyframe
    0 of each: matches and PnP inliers exact, the Sim3 to 1e-4."""
    g_np, sub_np = rigs["jax"]["before"]
    to_j = lambda d: jms.MapState(  # noqa: E731
        jms.KeyFrames(**{k: jnp.asarray(v) for k, v in d["kf"].items()}),
        jms.MapPoints(**{k: jnp.asarray(v) for k, v in d["mp"].items()}),
        jnp.int32(d["n_kf"]), jnp.int32(d["n_mp"]))
    jg, jsub = to_j(g_np), to_j(sub_np)
    key = jax.random.PRNGKey(42)
    b = jfo.detect_overlap(J.CAM, jg, 0, jsub, 0, key, J.CFG)
    g, sub = port_map(g_np), port_map(sub_np)
    hit = fusion_ops.overlap_matches(g, 0, sub, 0, CFG).hit
    a = fusion_ops.detect_overlap(CAM, g, 0, sub, 0, CFG, idx=jax_sample(key, hit))
    assert int(a.n_matches) == int(b.n_matches) and int(a.n_inliers) == int(b.n_inliers)
    assert bool(a.ok) == bool(b.ok) and bool(a.ok)
    close(a.R, b.R, 1e-4)
    close(a.t, b.t, 1e-4)
    close(a.s, b.s, 1e-4)


def _valid_count(t):
    return int(np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t).sum())


def test_rig_fusion_equals_the_reference(rigs):
    j, p = rigs["jax"], rigs["port"]
    js, ps = j["srv"], p["srv"]
    assert sorted(ps.transMs) == sorted(js.transMs) == [1, 2]
    for cid in (1, 2):
        for x, y in zip(ps.transMs[cid], js.transMs[cid]):
            close(x, y, 1e-4)
    assert {c: s.fused for c, s in ps.sub.items()} == {c: s.fused for c, s in js.sub.items()}
    assert ps.stats == js.stats
    assert ps.stats["seam_fuses"] == ps.stats["essential_graph_runs"] == 1
    assert int(ps.gmap.n_kf) == int(js.gmap.n_kf)
    assert _valid_count(ps.gmap.kf.valid) == _valid_count(js.gmap.kf.valid)
    assert _valid_count(ps.gmap.mp.valid) == _valid_count(js.gmap.mp.valid)
    np.testing.assert_array_equal(ps.gmap.mp.valid.numpy(), np.asarray(js.gmap.mp.valid))
    close(ps.gmap.kf.Tcw, js.gmap.kf.Tcw, 1e-4)
    np.testing.assert_array_equal(ps.g_kf_ids.gid_of_row, js.g_kf_ids.gid_of_row)
    # Client 1 received client 2's keyframes, fixed; both sides alike.
    for side in (j, p):
        m1 = side["c1"].tracker.map
        rows = np.arange(side["n_kf_1"], int(m1.n_kf))
        assert len(rows) == 3
        assert np.asarray(m1.kf.fixed[rows] if not isinstance(m1.kf.fixed, torch.Tensor)
                          else m1.kf.fixed[rows].numpy()).all()
    for c in ("c1", "c2"):
        assert p[c].stats == j[c].stats
        assert p[c].Ttrans is not None and j[c].Ttrans is not None
        for x, y in zip(p[c].Ttrans, j[c].Ttrans):
            close(x, y, 1e-4)
        pm, jm = p[c].tracker.map, j[c].tracker.map
        assert int(pm.n_mp) == int(jm.n_mp) and int(pm.n_kf) == int(jm.n_kf)
        np.testing.assert_array_equal(pm.mp.fixed.numpy(), np.asarray(jm.mp.fixed))
        close(pm.mp.pos, jm.mp.pos, 1e-3)


def test_rig_pose_update_roundtrip(rigs):
    """Client 1 moves one of its keyframes; client 2 sees it in its own
    frame (the reference test's body, both sides)."""
    got = {}
    for side in ("jax", "port"):
        r = rigs[side]
        c1, c2, srv = r["c1"], r["c2"], r["srv"]
        m1 = c1.tracker.map
        if side == "jax":
            T_new = np.asarray(m1.kf.Tcw[1]).copy()
            T_new[0, 3] += 0.5
            c1.tracker.map = m1._replace(kf=m1.kf._replace(Tcw=m1.kf.Tcw.at[1].set(T_new)))
        else:
            T_new = m1.kf.Tcw[1].numpy().copy()
            T_new[0, 3] += 0.5
            m1.kf.Tcw[1] = t_(T_new)
        n0 = srv.stats["kf_updates"]
        assert c1.uplink_step()
        assert srv.stats["kf_updates"] >= n0 + 1
        srv.broadcast_step()
        c2.downlink_step()
        gid = c1.kf_ids.gid_of_row[1]
        row2 = int(c2.kf_ids.rows_for(np.asarray([gid]))[0])
        m2 = c2.tracker.map
        g = np.asarray(m2.kf.Tcw[row2]) if side == "jax" else m2.kf.Tcw[row2].numpy()
        R2, t2, s2 = c2.Ttrans
        Sinv = jsim3.inverse((jnp.asarray(R2), jnp.asarray(t2), jnp.float32(s2)))
        expect = np.asarray(jfo.transform_poses(jnp.asarray(T_new), Sinv))
        np.testing.assert_allclose(g, expect, atol=1e-4)
        got[side] = g
    close(got["port"], got["jax"], 1e-4)


def test_rig_late_join_full_resync(rigs):
    """A client joining after the broadcast gets the whole global map by a
    resync (the reference test's body, both sides)."""
    counts = {}
    for side in ("jax", "port"):
        r = rigs[side]
        tr, srv, c1 = r["tr"], r["srv"], r["c1"]
        if side == "jax":
            t3 = J.FakeTracker()
            c3 = JCache(t3, tr, 3, J.CFG)
        else:
            t3 = Tracker(ms.empty(CFG.capacity))
            c3 = ClientCache(t3, tr, 3, CFG)
        srv.broadcast_step()
        c3.downlink_step()
        assert int(t3.map.n_kf) == 0
        assert c3.request_resync()
        for _ in range(64):
            srv.broadcast_step()
            c3.downlink_step()
            if srv._resync_kf is None and srv._resync_mp is None:
                break
        g, m3 = srv.gmap, t3.map
        assert _valid_count(m3.kf.valid) == _valid_count(g.kf.valid)
        assert _valid_count(m3.mp.valid) == _valid_count(g.mp.valid)
        gp = np.asarray(g.mp.pos.cpu() if side == "port" else g.mp.pos)[
            np.asarray(g.mp.valid.cpu() if side == "port" else g.mp.valid)]
        p3 = np.asarray(m3.mp.pos.cpu() if side == "port" else m3.mp.pos)[
            np.asarray(m3.mp.valid.cpu() if side == "port" else m3.mp.valid)]
        d = np.linalg.norm(p3[:, None] - gp[None], axis=-1).min(axis=1)
        assert float(d.max()) < 1e-4
        n1 = int(c1.tracker.map.n_kf)
        c1.downlink_step()
        assert int(c1.tracker.map.n_kf) == n1
        counts[side] = (int(m3.n_kf), int(m3.n_mp), c3.stats)
    assert counts["port"] == counts["jax"]


def test_rig_compaction_under_collaboration(rigs):
    """Cull five synced points of client 1, compact and remap: a surviving
    keyframe's pose delta reaches the right server entity, and new points in
    reclaimed rows get fresh gids (the reference test's body, both sides)."""
    out = {}
    for side in ("jax", "port"):
        r = rigs[side]
        c1, srv = r["c1"], r["srv"]
        m = c1.tracker.map
        gid_kf1 = c1.kf_ids.gid_of_row[1]
        if side == "jax":
            kill = np.nonzero(np.asarray(m.mp.valid & ~m.mp.fixed))[0][:5]
            c1.tracker.map = m._replace(mp=m.mp._replace(valid=m.mp.valid.at[kill].set(False)))
            res = jms.compact(c1.tracker.map)
        else:
            kill = np.nonzero((m.mp.valid & ~m.mp.fixed).numpy())[0][:5]
            m.mp.valid[t_(kill)] = False
            res = ms.compact(m)
        c1.tracker.map = res.m
        c1.remap_rows(res)
        new_row1 = int(np.asarray(res.kf_old2new)[1])
        assert new_row1 >= 0 and c1.kf_ids.gid_of_row[new_row1] == gid_kf1
        m = c1.tracker.map
        T_new = np.array(m.kf.Tcw[new_row1]).copy()
        T_new[1, 3] += 0.25
        if side == "jax":
            c1.tracker.map = m._replace(kf=m.kf._replace(Tcw=m.kf.Tcw.at[new_row1].set(T_new)))
        else:
            m.kf.Tcw[new_row1] = t_(T_new)
        upd0 = srv.stats["kf_updates"]
        assert c1.uplink_step()
        assert srv.stats["kf_updates"] > upd0
        srv_row = int(srv.g_kf_ids.rows_for(np.asarray([gid_kf1]))[0])
        got = np.array(srv.gmap.kf.Tcw[srv_row])
        assert srv_row >= 0 and abs(got[1, 3] - T_new[1, 3]) < 1e-4
        m = c1.tracker.map
        if side == "jax":
            m2, rows = jms.add_map_points(m, jnp.ones((8, 3)) * 3.0, jnp.zeros((8, 32), jnp.uint8),
                                          jnp.ones((8, 3)), jnp.ones(8), jnp.ones(8) * 9.0,
                                          ref_kf=0, create=jnp.ones(8, bool), client=1)
        else:
            m2, rows = ms.add_map_points(m, torch.ones(8, 3) * 3.0,
                                         torch.zeros(8, 32, dtype=torch.uint8), torch.ones(8, 3),
                                         torch.ones(8), torch.ones(8) * 9.0, ref_kf=0,
                                         create=torch.ones(8, dtype=torch.bool), client=1)
        c1.tracker.map = m2
        assert c1.uplink_step()
        new_gid = c1.mp_ids.gid_of_row[int(np.asarray(rows)[0])]
        vals = c1.mp_ids.gid_of_row[c1.mp_ids.gid_of_row >= 0]
        assert new_gid >= 0 and len(np.unique(vals)) == len(vals)
        out[side] = (new_row1, srv_row, new_gid, srv.stats, c1.stats)
    assert out["port"] == out["jax"]


def test_failed_uplink_retries_without_loss(vocs):
    jv, pv = vocs
    got = {}
    for side in ("jax", "port"):
        tr, srv, (c1, _) = build_rig(jv, pv, side == "jax", drop_calls=1)
        assert not c1.uplink_step()
        assert c1.stats["failed_calls"] == 1
        assert c1.uplink_step()
        assert srv.stats["kfs_received"] == 3 and srv.stats["mps_received"] == 100
        got[side] = (srv.stats, c1.stats)
    assert got["port"] == got["jax"]


def test_foreign_keyframes_join_the_loop_closers_database(vocs):
    """A client with a loop closer files the broadcast's foreign keyframes
    in its BoW database from the server's sparse BoW: the rows equal the
    batched transform of the keyframes it received."""
    from corbslam_tpu_torch.loop.loop_closing import LoopCloser

    _, pv = vocs
    jm1, jm2 = client_maps()
    tr = InProcTransport()
    srv = MapFusionServer(CAM, CFG, pv, tr, run_gba=False, device="cpu")
    lc = LoopCloser(CAM, CFG, pv, run_gba=False)
    c1 = ClientCache(Tracker(port_map(jm1)), tr, 1, CFG, loop_closer=lc)
    c2 = ClientCache(Tracker(port_map(jm2)), tr, 2, CFG)
    assert c1.uplink_step() and srv.fuse_step() and c2.uplink_step() and srv.fuse_step()
    srv.broadcast_step()
    c1.downlink_step()
    m = c1.tracker.map
    rows = torch.nonzero(m.kf.fixed & m.kf.valid)[:, 0]
    assert len(rows) == 3 and bool(lc.db.valid[rows].all())
    close(lc.db.bow[rows], vocab.transform_batch(pv, m.kf.desc[rows], m.kf.fvalid[rows]), 1e-7)


def test_server_handlers_on_many_threads_lose_nothing(vocs):
    """Ten clients uplink at once from their own threads (more than this
    machine's cores, a short switch interval) while the main thread runs
    fuse and broadcast steps: the server's lock must keep every keyframe
    and point of every client, each once."""
    import sys
    import threading

    _, pv = vocs
    tr = InProcTransport(serialize=True)
    srv = MapFusionServer(CAM, CFG, pv, tr, run_gba=False, device="cpu")
    caches = []
    maps = client_maps()
    for cid in range(1, 11):
        m = port_map(maps[cid % 2])  # the two clients' maps, relabelled
        m.kf.client.fill_(cid)
        m.mp.client.fill_(cid)
        caches.append(ClientCache(Tracker(m), tr, cid, CFG))
    acks = {}
    threads = [threading.Thread(target=lambda c=c: acks.update({c.cid: c.uplink_step()}))
               for c in caches]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        steps = 0
        while any(t.is_alive() for t in threads) and steps < 4:  # each fusion ~1-2 s here
            srv.fuse_step()
            srv.broadcast_step()
            steps += 1
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and all(acks.values()) and len(acks) == 10
    assert srv.stats["kfs_received"] == sum(c.stats["kfs_pushed"] for c in caches) == 30
    assert srv.stats["mps_received"] == sum(c.stats["mps_pushed"] for c in caches) == 1000
    # Every entity once: in the global map, or in its client's sub-map until
    # that is fused (a fused sub-map is emptied and keeps its old id table).
    live = [sm for sm in srv.sub.values() if not sm.fused]
    n_kf = _valid_count(srv.gmap.kf.valid) + sum(_valid_count(sm.map.kf.valid) for sm in live)
    assert n_kf == 30
    for attr, n in (("kf_ids", 30), ("mp_ids", 1000)):
        gids = np.concatenate([getattr(srv, "g_" + attr).gid_of_row]
                              + [getattr(sm, attr).gid_of_row for sm in live])
        gids = gids[gids >= 0]
        assert len(np.unique(gids)) == len(gids) == n, attr


# ---------------------------------------------------------------------------
# The runner on the CPU
# ---------------------------------------------------------------------------

def test_run_collab_on_the_cpu_keeps_its_invariants():
    """`apps.run_collab` with two clients over 8 frames on the CPU: every
    frame tracked, every client's keyframes reach the server, gids unique
    on every map, poses and points finite."""
    from corbslam_tpu_torch.apps import run_collab

    server, clients = run_collab.main(["--clients", "2", "--frames", "8", "--device", "cpu"])
    assert server.stats["kfs_received"] == sum(c.cache.stats["kfs_pushed"] for c in clients) > 0
    assert server.stats["fusions"] >= 1 and 1 in server.transMs
    for c in clients:
        assert [s.name for s in c.tracker.frame_states] == ["OK"] * 8
        assert c.cache.stats["failed_calls"] == 0
        for ids in (c.cache.kf_ids, c.cache.mp_ids):
            g = ids.gid_of_row[ids.gid_of_row >= 0]
            assert len(np.unique(g)) == len(g)
        m = c.tracker.map
        assert bool(torch.isfinite(m.kf.Tcw[m.kf.valid]).all())
        assert bool(torch.isfinite(m.mp.pos[m.mp.valid]).all())
    for ids in (server.g_kf_ids, server.g_mp_ids):
        g = ids.gid_of_row[ids.gid_of_row >= 0]
        assert len(np.unique(g)) == len(g)
    g = server.gmap
    assert bool(torch.isfinite(g.kf.Tcw[g.kf.valid]).all())
