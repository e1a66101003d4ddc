"""Global BA of the port (`loop/gba.py`, `optim/ba_dense.problem_from_map` and
its helpers, `LoopCloser(run_gba=True)`, `system.CorbslamClient`) against
the JAX package on the CPU, on the synthetic loop map of
`test_torch_loop.py` given to both through `interop.map_from_numpy`, its
points moved by 2 cm and its keypoints by 0.5 px of seeded noise so that BA
has work to do and a cost left at its optimum.

Tolerances and why: the problem's selection, active set, K and point-major
table exact (integer work); one 2-iteration chunk within K8's tolerances
(poses 1e-4 m / rad, 99.5 % of the points within 1e-3 m, cost 1e-3
relative: the same f32 LM summed in another order); the merge within 1e-5
(a few f32 products per row); a synchronous runner equal to its own chunks
exactly (the same plain code). A loop closure with global BA on both sides,
from the reference's Sim3: poses and points within 1e-4 m, as the closure
without it in test_torch_loop.py (the correction, the fuse and a 20 x 40
pose graph, then 10 LM iterations that move the points up to 0.46 m).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.config import LoopConfig as JLoop
from corbslam_tpu.loop import gba as jgba
from corbslam_tpu.loop import loop_closing as jlc
from corbslam_tpu.optim import ba_dense as jba
from corbslam_tpu.place import vocab as JV
from corbslam_tpu_torch import config, entry, interop
from corbslam_tpu_torch.geometry import se3
from corbslam_tpu_torch.loop import gba
from corbslam_tpu_torch.loop import loop_closing as lc
from corbslam_tpu_torch.mapstate import mapstate as ms
from corbslam_tpu_torch.optim import ba_dense
from corbslam_tpu_torch.place import vocab
from corbslam_tpu_torch.system import CorbslamClient
from test_torch_loop import CAM, CFG, JCAM, JCFG, N_KF, close, jax_map, loop_map, t_

torch.set_num_threads(2)

N_SNAP = 16  # keyframes of the snapshot in the merge test


@pytest.fixture(scope="module")
def noisy():
    d, _, _ = loop_map()
    rng = np.random.default_rng(7)
    n = d["n_mp"]
    d["mp"]["pos"][:n] += rng.normal(0.0, 0.02, (n, 3)).astype(np.float32)
    xy = d["kf"]["xy"]
    d["kf"]["xy"] = xy + rng.normal(0.0, 0.5, xy.shape).astype(np.float32) * d["kf"]["fvalid"][..., None]
    return d


def thin(cfg, jcfg, obs):
    """Configs with a per-keyframe observation budget of `obs`."""
    return (cfg.replace(loop=config.LoopConfig(gba_obs_per_kf=obs)),
            jcfg.replace(loop=JLoop(gba_obs_per_kf=obs)))


@pytest.mark.parametrize("obs", [64, 512])
def test_the_global_problem_equals_the_references(noisy, obs):
    cfg, jcfg = thin(CFG, JCFG, obs)
    jm, pm = jax_map(noisy), interop.map_from_numpy(noisy)
    jp = jgba.build_global_problem_dense(jm, jcfg, n_kf_hint=N_KF, n_mp_hint=noisy["n_mp"])
    pp = gba.build_global_problem_dense(pm, cfg, n_kf_hint=N_KF, n_mp_hint=noisy["n_mp"])
    assert gba.point_major_k(pm) == jp.pm_src.shape[1] == 8
    pn = interop.problem_to_numpy(pp)
    for name in jba.BADense._fields:
        a, b = pn[name], np.asarray(getattr(jp, name))
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert np.array_equal(a, b), name
    sel = ba_dense.compact_rows(pm.kf.fvalid & (pm.kf.mp_idx >= 0), obs)
    jsel = jba.compact_rows(jm.kf.fvalid & (jm.kf.mp_idx >= 0), obs)
    assert np.array_equal(sel.numpy(), np.asarray(jsel))


def wide_map(n_kf, n_mp=1200, F=16, seed=11):
    """numpy fields of a map past 256 keyframes: n_kf keyframes of a
    640-row table advancing along z, each observing a sliding window of F of
    n_mp points (of 9000 rows) with 0.5 px noise."""
    cap = config.CapacityConfig(max_keyframes=640, max_map_points=9000, max_features=F,
                                local_window_kfs=8, local_window_mps=512)
    d = interop.map_to_numpy(ms.empty(cap))
    rng = np.random.default_rng(seed)
    kf, mp = d["kf"], d["mp"]
    z = np.linspace(0.0, 30.0, n_kf).astype(np.float32)
    X = np.stack([rng.uniform(-4, 4, n_mp), rng.uniform(-2, 2, n_mp),
                  rng.uniform(4, 12, n_mp) + np.linspace(0, 30, n_mp)], -1).astype(np.float32)
    mp["pos"][:n_mp], mp["valid"][:n_mp] = X, True
    stride = (n_mp - F) // (n_kf - 1)
    for k in range(n_kf):
        pts = k * stride + np.arange(F)
        pc = X[pts] - np.float32([0.0, 0.0, z[k]])
        uv = pc[:, :2] / pc[:, 2:] * 320.0 + [160.0, 120.0] + rng.normal(0, 0.5, (F, 2))
        kf["Tcw"][k, 2, 3], kf["valid"][k] = -z[k], True
        kf["xy"][k], kf["fvalid"][k], kf["mp_idx"][k] = uv, True, pts
        kf["uright"][k] = uv[:, 0] - 160.0 / pc[:, 2]
    d["n_kf"], d["n_mp"] = n_kf, n_mp
    return d


@pytest.mark.parametrize("n_kf", [300, 512])
def test_the_global_problem_past_256_keyframes_is_cut_as_the_references(n_kf):
    """300 or 512 keyframes: both packages cut the problem to 512 cameras and
    8192 points (the used rows rounded up, below the capacities) and agree on
    every field, and one LM iteration on it within K8's tolerances. At 512
    the table's slots that are not ok point past the cut cameras' slots."""
    d = wide_map(n_kf)
    jp = jgba.build_global_problem_dense(jax_map(d), JCFG, n_kf_hint=n_kf, n_mp_hint=d["n_mp"])
    pp = gba.build_global_problem_dense(interop.map_from_numpy(d), CFG, n_kf_hint=n_kf,
                                        n_mp_hint=d["n_mp"])
    assert pp.Tcw.shape[0] == np.asarray(jp.Tcw).shape[0] == 512
    assert pp.X.shape[0] == 8192 and pp.obs_mp.shape == (512, 16)
    assert int(pp.obs_active.sum()) == n_kf * 16
    assert (int(pp.pm_src.max()) >= 512 * 16) == (n_kf == 512)
    pn = interop.problem_to_numpy(pp)
    for name in jba.BADense._fields:
        a, b = pn[name], np.asarray(getattr(jp, name))
        assert a.shape == b.shape, name
        assert np.array_equal(a, b), name
    rj = jba.optimize(JCAM, jp, n_iters=1, cg_iters=CFG.loop.gba_cg_iters, huber_iters=1)
    rp = ba_dense.optimize(CAM, pp, n_iters=1, cg_iters=CFG.loop.gba_cg_iters, huber_iters=1)
    close(rp.Tcw[:, :3, 3], np.asarray(rj.Tcw)[:, :3, 3], 1e-4)
    close(rp.Tcw[:, :3, :3], np.asarray(rj.Tcw)[:, :3, :3], 1e-4)
    dx = np.abs(rp.X.numpy() - np.asarray(rj.X)).max(axis=1)
    assert (dx <= 1e-3).mean() >= 0.995
    assert abs(float(rp.cost) - float(rj.cost)) <= 1e-3 * abs(float(rj.cost))


def test_one_gba_chunk_equals_the_references(noisy):
    jm, pm = jax_map(noisy), interop.map_from_numpy(noisy)
    jp = jgba.build_global_problem_dense(jm, JCFG, n_kf_hint=N_KF, n_mp_hint=noisy["n_mp"])
    pp = gba.build_global_problem_dense(pm, CFG, n_kf_hint=N_KF, n_mp_hint=noisy["n_mp"])
    rj = jba.optimize(JCAM, jp, n_iters=2, cg_iters=CFG.loop.gba_cg_iters, huber_iters=2)
    rp = ba_dense.optimize(CAM, pp, n_iters=2, cg_iters=CFG.loop.gba_cg_iters, huber_iters=2)
    close(rp.Tcw[:, :3, 3], np.asarray(rj.Tcw)[:, :3, 3], 1e-4)
    close(rp.Tcw[:, :3, :3], np.asarray(rj.Tcw)[:, :3, :3], 1e-4)
    dx = np.abs(rp.X.numpy() - np.asarray(rj.X)).max(axis=1)
    assert (dx <= 1e-3).mean() >= 0.995
    assert abs(float(rp.cost) - float(rj.cost)) <= 1e-3 * abs(float(rj.cost))
    assert float(rp.cost) < float(ba_dense.optimize(CAM, pp, n_iters=0).cost)  # BA did work


def test_the_merge_equals_the_references(noisy):
    """Keyframes N_SNAP.. and their points were made after the snapshot:
    they follow their snapshot ancestor / reference keyframe."""
    jm, pm = jax_map(noisy), interop.map_from_numpy(noisy)
    rng = np.random.default_rng(3)
    N, M = noisy["kf"]["Tcw"].shape[0], noisy["mp"]["pos"].shape[0]
    n_mp_snap = int(np.nonzero(noisy["mp"]["ref_kf"][:noisy["n_mp"]] >= N_SNAP)[0][0])
    xi = rng.normal(0, 0.01, (N, 6)).astype(np.float32)
    T_opt = (se3.exp(t_(xi)) @ t_(noisy["kf"]["Tcw"])).numpy()
    X_opt = noisy["mp"]["pos"] + rng.normal(0, 0.01, (M, 3)).astype(np.float32)
    mj = jgba.merge_gba_result(jm, jnp.asarray(T_opt), jnp.asarray(X_opt), jnp.int32(N_SNAP),
                               jnp.int32(n_mp_snap))
    mp_ = gba.merge_gba_result(pm, t_(T_opt), t_(X_opt), N_SNAP, n_mp_snap)
    close(mp_.kf.Tcw, mj.kf.Tcw, 1e-5)
    close(mp_.mp.pos, mj.mp.pos, 1e-5)
    moved = np.abs(mp_.kf.Tcw.numpy() - noisy["kf"]["Tcw"]).max(axis=(1, 2))
    assert (moved[1:N_KF] > 1e-4).all() and (moved[N_KF:] == 0).all()
    assert mp_.kf.Tcw is not pm.kf.Tcw and torch.equal(pm.kf.Tcw, t_(noisy["kf"]["Tcw"]))


def test_the_runner_synchronous_abort_and_no_result(noisy):
    pm = interop.map_from_numpy(noisy)
    run = gba.GlobalBARunner(CAM, CFG, synchronous=True)
    assert run.try_merge(pm) is pm
    run.launch(pm)
    assert (run.runs_started, run.runs_finished, run.runs_aborted) == (1, 1, 0)
    merged = run.try_merge(pm)
    # The same run by hand: the problem, 5 chunks of 2 iterations, the merge.
    prob = gba.build_global_problem_dense(pm, CFG, n_kf_hint=N_KF, n_mp_hint=noisy["n_mp"])
    for _ in range(CFG.loop.global_ba_iters // 2):
        r = ba_dense.optimize(CAM, prob, n_iters=2, cg_iters=CFG.loop.gba_cg_iters, huber_iters=2)
        prob = prob._replace(Tcw=r.Tcw, X=r.X)
    T = pm.kf.Tcw.clone()
    T[:prob.Tcw.shape[0]] = prob.Tcw
    X = pm.mp.pos.clone()
    X[:prob.X.shape[0]] = prob.X
    hand = gba.merge_gba_result(pm, T, X, N_KF, noisy["n_mp"])
    assert torch.equal(merged.kf.Tcw, hand.kf.Tcw) and torch.equal(merged.mp.pos, hand.mp.pos)
    assert run.try_merge(merged) is merged  # consumed
    # Asynchronous, aborted during its first chunk: no result, one abort.
    run = gba.GlobalBARunner(CAM, CFG)
    started, chunk = threading.Event(), run._chunk

    def slow_chunk(prob, k):
        started.set()
        run._abort.wait(30)
        return chunk(prob, k)

    run._chunk = slow_chunk
    run.launch(pm)
    assert started.wait(30) and run.busy()
    run.abort()
    assert not run.busy() and run.runs_aborted == 1 and run.runs_finished == 0
    assert run.try_merge(pm) is pm


def test_a_closure_with_global_ba_equals_the_references(noisy):
    d, _, _ = loop_map()
    jm, pm = jax_map(d), interop.map_from_numpy(d)
    kf_q, kf_c = N_KF - 1, 0
    sj = jlc.compute_sim3(JCAM, jm, kf_q, kf_c, jax.random.PRNGKey(0), JCFG, fix_scale=True)
    assert bool(sj.ok)
    sp = lc.Sim3Between(*(t_(np.asarray(getattr(sj, f))) for f in lc.Sim3Between._fields))
    jc = jlc.LoopCloser(JCAM, JCFG, JV.load_default(), run_gba=True, seed=0)
    pc = lc.LoopCloser(CAM, CFG, vocab.load_default("cpu"), run_gba=True, seed=0)
    jc.gba_runner.synchronous = pc.gba_runner.synchronous = True
    jm1 = jc.try_merge_gba(jc.close_loop(jm, kf_q, kf_c, sj))
    m1 = pc.close_loop(pm, kf_q, kf_c, sp)
    pm1 = pc.try_merge_gba(m1)
    assert pm1 is not m1 and pc.gba_runner.runs_finished == jc.gba_runner.runs_finished == 1
    close(pm1.kf.Tcw, jm1.kf.Tcw, 1e-4)
    close(pm1.mp.pos, jm1.mp.pos, 1e-4, mask=np.asarray(jm1.mp.valid))
    assert float((pm1.kf.Tcw - m1.kf.Tcw).abs().max()) > 1e-3  # global BA moved the map
    # Another closure aborts nothing (the run finished); a reset aborts a
    # running one and keeps the counts.
    pc.reset()
    assert pc.gba_runner.runs_aborted == 0 and pc.gba_runner.try_merge(pm1) is pm1


def test_the_client_on_the_cpu_runs_global_ba_and_merges_at_shutdown(tmp_path):
    c, ee = entry.e2e_entry("stereo", "cpu", n_words=64, n_iters=2)
    c._metrics = open(tmp_path / "metrics.jsonl", "a")
    assert c.loop_closer.fix_scale and c.loop_closer.gba_runner.synchronous
    entry.run_e2e(c, ee, n=10, step=lambda i, fn: fn() if i is not None else None)
    tr = c.tracker
    assert [s.name for s in tr.frame_states] == ["OK"] * 10
    g = c.loop_closer.gba_runner
    g.synchronous = False
    g.launch(tr.map)
    before = tr.map
    c.shutdown()
    assert g.runs_finished == 1 and g._result is None and tr.map is not before
    lines = [json.loads(x) for x in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 10 and all(x["state"] == "OK" for x in lines)
    assert set(lines[0]) == {"t", "frame", "state", "track_ms", "n_kf", "n_mp", "inliers"}
    T = tr.map.kf.Tcw[tr.map.kf.valid]
    assert bool(torch.isfinite(T).all()) and float((T - before.kf.Tcw[tr.map.kf.valid]).abs().max()) > 0
    from corbslam_tpu_torch.collab.client_cache import ClientCache
    from corbslam_tpu_torch.collab.transport import InProcTransport

    collab = CorbslamClient(CAM, CFG, voc=c.voc, transport=InProcTransport(), device="cpu")
    assert isinstance(collab.cache, ClientCache) and collab.cache.tracker is collab.tracker
    assert collab.tracker.on_compact == [collab.cache.remap_rows]
    assert collab.tracker.on_reset == [collab.cache.handle_reset]
    collab.shutdown()
    mono = CorbslamClient(ee.cam, ee.cfg, sensor="mono", voc=c.voc, device="cpu")
    assert mono.loop_closer.fix_scale is False
