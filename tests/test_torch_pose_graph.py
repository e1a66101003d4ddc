"""The port's Sim3 pose graph (`optim/pose_graph.py`), covisibility count and
spanning chain (`mapstate/covisibility.py`) and essential graph
(`loop/loop_closing.build_essential_graph`) — kernel K11's plain versions —
against the JAX package, on graphs and maps made from a seed with numpy.

The optimizer runs on a noisy loop ring and on a graph in the essential
graph's layout (unweighted tail edges at vertex 0, unused loop slots), and
the incidence list the kernel sums from is held against a direct build.

Tolerances and why: residuals and Jacobians within 1e-4 of each array's
largest entry (the reference differentiates with jax.jacfwd, the port with
one forward-mode direction per pass, through the same f32 formulas);
optimized vertices within 1e-4 m / rad and costs within 1e-3 (relative) after
20 Gauss-Newton x 40 CG iterations (sums in another order); shared-point
counts, parents and edge lists are integers and exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.config import CapacityConfig as JCapacity
from corbslam_tpu.loop import loop_closing as jlc
from corbslam_tpu.mapstate import covisibility as jcovis
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu.optim import pose_graph as jpg
from corbslam_tpu_torch import interop
from corbslam_tpu_torch.geometry import sim3
from corbslam_tpu_torch.loop import loop_closing as lc
from corbslam_tpu_torch.mapstate import covisibility as covis
from corbslam_tpu_torch.optim import pose_graph as pg

torch.set_num_threads(2)


def t_(a):
    return torch.from_numpy(np.array(a))


def graph_to_port(g):
    return pg.PoseGraph(*(t_(x) for x in g))


def exp_np(xi):
    """Sim3 exp of numpy tangents, as numpy (R, t, s) (inputs only)."""
    return tuple(x.numpy() for x in sim3.exp(torch.from_numpy(np.asarray(xi, np.float32))))


def jgraph(V, ei, ej, Mm, fixed, e_valid):
    j = jnp.asarray
    return jpg.PoseGraph(j(V[0]), j(V[1]), j(V[2]), j(fixed), j(ei), j(ej), j(Mm[0]), j(Mm[1]),
                         j(Mm[2]), j(e_valid), jnp.ones(len(ei), jnp.float32))


def rel_close(a, b, tol):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1.0), np.abs(a - b).max()


def test_linearize_edges_equals_jacfwd():
    rng = np.random.default_rng(0)
    N, E = 24, 96
    V = exp_np(rng.normal(size=(N, 7)) * 0.5)
    Mm = exp_np(rng.normal(size=(E, 7)) * 0.3)
    ei = rng.integers(0, N, E).astype(np.int32)
    ej = rng.integers(0, N, E).astype(np.int32)
    g = jgraph(V, ei, ej, Mm, np.zeros(N, bool), np.ones(E, bool))
    ref = jax.jit(jpg.linearize_edges)(g)
    out = pg.linearize_edges(graph_to_port(g))
    for a, b in zip(out, ref):
        rel_close(a.numpy(), b, 1e-4)


def loop_graph(rng, N=64):
    """A noisy odometry ring: chain edges, covisibility edges (i, i+2),
    (i, i+3), and 2 loop edges closing the ring; vertices start from the
    drifted chain."""
    th = 2 * np.pi * np.arange(N) / N
    xi = np.zeros((N, 7), np.float32)
    xi[:, 0], xi[:, 2], xi[:, 4] = 5 * np.cos(th), 5 * np.sin(th), th
    gt = sim3.exp(torch.from_numpy(xi))
    pairs = [(i, i + 1) for i in range(N - 1)] + [(i, i + 2) for i in range(N - 2)]
    pairs += [(i, i + 3) for i in range(0, N - 3, 2)] + [(N - 1, 0), (N - 2, 1)]
    ei = np.array([p[0] for p in pairs], np.int32)
    ej = np.array([p[1] for p in pairs], np.int32)
    E = len(pairs)
    noise = rng.normal(size=(E, 7)) * [0.02, 0.02, 0.02, 0.01, 0.01, 0.01, 0.0]
    take = lambda S, idx: tuple(x[torch.from_numpy(idx).long()] for x in S)  # noqa: E731
    meas = sim3.compose(sim3.exp(torch.from_numpy(noise.astype(np.float32))),
                        sim3.compose(take(gt, ej), sim3.inverse(take(gt, ei))))
    drift = rng.normal(size=(N, 7)) * [0.05, 0.05, 0.05, 0.02, 0.02, 0.02, 0.0]
    V0 = sim3.compose(sim3.exp(torch.from_numpy(drift.astype(np.float32))), gt)
    fixed = np.zeros(N, bool)
    fixed[0] = True
    e_valid = np.ones(E, bool)
    e_valid[5] = False
    return jgraph(tuple(x.numpy() for x in V0), ei, ej, tuple(x.numpy() for x in meas), fixed,
                  e_valid)


def essential_graph(rng, N=48, covis_k=8, n_loop_slots=4):
    """A graph in `build_essential_graph`'s layout (E = N + N covis_k +
    n_loop_slots): the spanning chain (row 0 without a parent, its edge
    unweighted and defaulting to vertex 0), each row's covisibility edges
    to rows i + 2 .. i + covis_k + 1 (the tail past the last row unweighted,
    defaulting to vertex 0), two of four loop slots closing the ring (the
    rest unweighted at vertex 0); row 0 fixed. Vertices are the drifted
    truth on a 4 m ring, measurements the truth with noise."""
    th = 2 * np.pi * np.arange(N) / N
    xi = np.zeros((N, 7), np.float32)
    xi[:, 0], xi[:, 2], xi[:, 4] = 4 * np.cos(th), 4 * np.sin(th), th
    gt = sim3.exp(torch.from_numpy(xi))
    rows = np.arange(N)
    cv_j = rows[:, None] + 2 + np.arange(covis_k)[None, :]
    cv_ok = cv_j < N
    lp_i, lp_j = np.zeros(n_loop_slots, np.int32), np.zeros(n_loop_slots, np.int32)
    lp_i[:2], lp_j[:2] = (N - 1, N - 2), (0, 1)
    ei = np.concatenate([np.maximum(rows - 1, 0), np.repeat(rows, covis_k), lp_i]).astype(np.int32)
    ej = np.concatenate([rows, np.where(cv_ok, cv_j, 0).reshape(-1), lp_j]).astype(np.int32)
    e_valid = np.concatenate([rows > 0, cv_ok.reshape(-1), np.arange(n_loop_slots) < 2])
    E = len(ei)
    noise = rng.normal(size=(E, 7)) * [0.02, 0.02, 0.02, 0.01, 0.01, 0.01, 0.0]
    take = lambda S, idx: tuple(x[torch.from_numpy(idx).long()] for x in S)  # noqa: E731
    meas = sim3.compose(sim3.exp(torch.from_numpy(noise.astype(np.float32))),
                        sim3.compose(take(gt, ej), sim3.inverse(take(gt, ei))))
    drift = rng.normal(size=(N, 7)) * [0.05, 0.05, 0.05, 0.02, 0.02, 0.02, 0.0]
    V0 = sim3.compose(sim3.exp(torch.from_numpy(drift.astype(np.float32))), gt)
    fixed = rows == 0
    return jgraph(tuple(x.numpy() for x in V0), ei, ej, tuple(x.numpy() for x in meas), fixed,
                  e_valid)


@pytest.mark.parametrize("layout", ["loop", "essential"])
def test_optimize_on_a_loop_graph(layout):
    rng = np.random.default_rng(1)
    g = loop_graph(rng) if layout == "loop" else essential_graph(rng)
    (R, t, s), costs = jpg.optimize(g, n_iters=20, cg_iters=40)
    (Rp, tp, sp), cp = pg.optimize(graph_to_port(g), n_iters=20, cg_iters=40)
    np.testing.assert_allclose(tp.numpy(), np.asarray(t), rtol=0, atol=1e-4)
    np.testing.assert_allclose(Rp.numpy(), np.asarray(R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(sp.numpy(), np.asarray(s), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cp.numpy(), np.asarray(costs), rtol=1e-3)
    assert float(cp[-1]) < 0.1 * float(cp[0])


def test_incidence_list_is_vertex_side_edge_order_of_the_weighted_edges():
    """The incidence list K11 sums from (`pose_graph.incidence`), held
    against a direct build: for each vertex its weighted edges' codes side
    * E + edge, the i-side ones in edge order, then the j-side ones."""
    g = graph_to_port(essential_graph(np.random.default_rng(4), N=20, n_loop_slots=4))
    w = g.e_valid.to(torch.float32) * g.e_weight
    w[7] = 0.0
    off, inc = pg.incidence(g, w)
    N, E = g.R.shape[0], g.e_i.shape[0]
    ref = [[side * E + e for side, ends in enumerate((g.e_i, g.e_j)) for e in range(E)
            if int(ends[e]) == v and float(w[e]) != 0.0] for v in range(N)]
    assert off.tolist() == np.cumsum([0] + [len(r) for r in ref]).tolist()
    assert inc[:int(off[-1])].tolist() == [c for r in ref for c in r]
    assert sorted(inc.tolist()) == sorted(range(2 * E)) and inc.dtype == torch.int32
    assert pg.scratch_floats(N, E) == E * 189 + N * 21 + 3 * 1024


N_KF, F, M = 32, 192, 2048


def covis_map(rng):
    """28 live rows of two interleaved clients (two culled), each keyframe
    observing 170 of a 200-point window shifted 30 points a row (neighbours
    share ~100-125 points), one point seen twice by one keyframe."""
    cap = JCapacity(max_keyframes=N_KF, max_map_points=M, max_features=F, local_window_kfs=8,
                    local_window_mps=256)
    n = 28
    mp_idx = np.full((N_KF, F), -1, np.int32)
    for i in range(n):
        mp_idx[i, :170] = rng.choice(np.arange(i * 30, i * 30 + 200), 170, replace=False)
    mp_idx[4, 170] = mp_idx[4, 0]
    fvalid = np.zeros((N_KF, F), bool)
    fvalid[:n, :180] = True
    fvalid[6, 10:20] = False
    valid = np.zeros(N_KF, bool)
    valid[:n] = True
    valid[[9, 20]] = False
    client = (rng.random(N_KF) < 0.25).astype(np.int32)
    T = sim3.to_matrix(sim3.exp(torch.from_numpy(
        (rng.normal(size=(N_KF, 7)) * [1, 1, 1, 0.2, 0.2, 0.2, 0]).astype(np.float32)))).numpy()
    m = jms.empty(cap)
    return m._replace(
        kf=m.kf._replace(mp_idx=jnp.asarray(mp_idx), fvalid=jnp.asarray(fvalid),
                         valid=jnp.asarray(valid), client=jnp.asarray(client),
                         Tcw=jnp.asarray(T)),
        mp=m.mp._replace(valid=jnp.ones(M, bool)), n_kf=jnp.int32(n), n_mp=jnp.int32(M))


def test_covis_matrix_and_spanning_parents_are_exact():
    m = covis_map(np.random.default_rng(2))
    pm = interop.map_from_numpy(m)
    W = covis.covis_matrix(pm)
    Wj = np.asarray(JCOVIS(m))
    assert np.array_equal(W.numpy(), Wj) and Wj.max() >= 100
    assert np.array_equal(covis.obs_matrix(pm).numpy(), np.asarray(jcovis.obs_matrix(m)))
    par = covis.spanning_parents(pm)
    assert np.array_equal(par.numpy(), np.asarray(jax.jit(jcovis.spanning_parents)(m)))
    rows = np.array([3, 4, 9, 27], np.int32)
    assert np.array_equal(covis.covis_weights_matrix_rows(pm, t_(rows)).numpy(),
                          np.asarray(jcovis.covis_weights_matrix_rows(m, jnp.asarray(rows))))
    grp, ok = covis.covis_groups_rows(pm, t_(rows), n_group=6)
    gj, oj = jcovis.covis_groups_rows(m, jnp.asarray(rows), n_group=6)
    assert np.array_equal(grp.numpy(), np.asarray(gj)) and np.array_equal(ok.numpy(), np.asarray(oj))


def edge_map(case: str):
    """`covis_map` changed at one of the covisibility count's edges: a row
    observing one point ten times, dead rows and invalid features holding
    stale point ids, no live row, one live row, a point observed by all 32
    rows (more than the kernel keeps inline)."""
    m = covis_map(np.random.default_rng(6))
    idx, fv, valid = (np.array(x) for x in (m.kf.mp_idx, m.kf.fvalid, m.kf.valid))
    if case == "observed_twice":
        idx[3, 171:181] = idx[3, 5]
    elif case == "stale_rows":
        idx[~valid] = 7
        idx[valid.nonzero()[0][:4], 185] = 11  # on features that are not valid
    elif case == "no_live":
        valid[:] = False
    elif case == "one_live":
        valid[:] = np.arange(N_KF) == 5
    else:  # point_in_every_row: point 1999 in every row, every row live
        valid[:] = True
        fv[:, 181] = True
        idx[:, 181] = 1999
    return m._replace(kf=m.kf._replace(mp_idx=jnp.asarray(idx), fvalid=jnp.asarray(fv),
                                       valid=jnp.asarray(valid)))


@pytest.mark.parametrize("case", ["observed_twice", "stale_rows", "no_live", "one_live",
                                  "point_in_every_row"])
def test_covis_matrix_is_exact_at_its_edges(case):
    m = edge_map(case)
    W = covis.covis_matrix(interop.map_from_numpy(m)).numpy()
    Wj = np.asarray(JCOVIS(m))
    assert np.array_equal(W, Wj)
    if case == "no_live":
        assert not Wj.any()
    elif case == "one_live":
        assert Wj[5, 5] > 0 and Wj.sum() == Wj[5, 5]
    elif case == "point_in_every_row":
        assert Wj.min() >= 1


JCOVIS = jax.jit(jcovis.covis_matrix)


def test_build_essential_graph_edge_lists_are_exact():
    rng = np.random.default_rng(3)
    m = covis_map(rng)
    pm = interop.map_from_numpy(m)
    S = exp_np(rng.normal(size=(2, 7)) * 0.1)
    le = jlc.LoopEdges.empty()
    loops = le._replace(i=le.i.at[:2].set(jnp.asarray([2, 5], jnp.int32)),
                        j=le.j.at[:2].set(jnp.asarray([26, 24], jnp.int32)),
                        R=le.R.at[:2].set(S[0]), t=le.t.at[:2].set(S[1]), s=le.s.at[:2].set(S[2]),
                        valid=le.valid.at[:2].set(True))
    meas = np.asarray(m.kf.Tcw) + rng.normal(size=m.kf.Tcw.shape).astype(np.float32) * 1e-3
    build = jax.jit(jlc.build_essential_graph)
    gj = build(m, loops, 2, jnp.asarray(meas))
    gp = lc.build_essential_graph(pm, interop.loop_edges_from_numpy(loops), 2, t_(meas))
    for name in ("e_i", "e_j", "e_valid", "fixed"):
        assert np.array_equal(getattr(gp, name).numpy(), np.asarray(getattr(gj, name))), name
    assert int(gp.e_valid.sum()) > 26 + 2
    for name in ("R", "t", "s", "mR", "mt", "ms", "e_weight"):
        np.testing.assert_allclose(getattr(gp, name).numpy(), np.asarray(getattr(gj, name)),
                                   rtol=0, atol=1e-5, err_msg=name)
