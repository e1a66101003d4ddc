"""The port's loop closing (`loop/loop_closing.py`, global BA off) and
relocalization (`frontend/reloc.py`) against the JAX package, on one
synthetic map given to both through `interop.map_from_numpy`: keyframes 0-3
see a scene A, 4-15 their own scenes, and 16-19 revisit A with a duplicated
landmark cloud placed by their drifted poses (the state a loop closer
meets). The shipped vocabulary scores the keyframes.

The RANSAC draws of the two packages cannot be the same (jax.random vs a
torch.Generator): where a step is compared value for value, the port gets
JAX's own index array; the loop closer's whole sequence is compared by
outcome (groups, detections, attempts, closure).

Tolerances and why: counts, flags, rows and consistency groups exact; poses
and points within 1e-4 (m, rad): the same f32 arithmetic summed in another
order, through RANSAC refinement, three pose LMs and a 20 x 40 pose graph.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.config import CapacityConfig as JCapacity
from corbslam_tpu.config import OrbConfig as JOrb
from corbslam_tpu.config import SlamConfig as JSlam
from corbslam_tpu.frontend import frame as jframe
from corbslam_tpu.frontend import reloc as jreloc
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.loop import loop_closing as jlc
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu.matching import matcher as jmatcher
from corbslam_tpu.place import vocab as JV
from corbslam_tpu_torch import config, interop
from corbslam_tpu_torch.frontend import frame, reloc
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.loop import loop_closing as lc
from corbslam_tpu_torch.mapstate import mapstate as ms
from corbslam_tpu_torch.place import vocab

torch.set_num_threads(2)

KW = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)
CAP = dict(max_keyframes=32, max_map_points=2048, max_features=128, local_window_kfs=8,
           local_window_mps=512)
JCFG = JSlam(orb=JOrb(n_features=128, n_levels=4), capacity=JCapacity(**CAP))
CFG = config.SlamConfig(orb=config.OrbConfig(n_features=128, n_levels=4),
                        capacity=config.CapacityConfig(**CAP))
N_KF, N_PTS, F = 20, 100, 128


def t_(a):
    return torch.from_numpy(np.array(a))


def loop_map(seed=0, drift=0.02):
    """numpy fields of the map (see the module docstring), and the true and
    estimated Tcw of each keyframe."""
    rng = np.random.default_rng(seed)
    N, M = CAP["max_keyframes"], CAP["max_map_points"]
    gt, est = [], []
    for i in range(N_KF):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = -2.0 * np.sin(np.pi * i / (N_KF - 1))
        gt.append(T)
        e = T.copy()
        e[0, 3] += drift * i
        est.append(e)
    kf = dict(Tcw=np.tile(np.eye(4, dtype=np.float32), (N, 1, 1)), valid=np.zeros(N, bool),
              fixed=np.zeros(N, bool), client=np.zeros(N, np.int32),
              frame_id=np.zeros(N, np.int32), timestamp=np.zeros(N, np.float32),
              xy=np.zeros((N, F, 2), np.float32), octave=np.zeros((N, F), np.int32),
              angle=np.zeros((N, F), np.float32), desc=np.zeros((N, F, 32), np.uint8),
              uright=np.full((N, F), -1.0, np.float32), depth=np.zeros((N, F), np.float32),
              fvalid=np.zeros((N, F), bool), mp_idx=np.full((N, F), -1, np.int32))
    mp = dict(pos=np.zeros((M, 3), np.float32), valid=np.zeros(M, bool), fixed=np.zeros(M, bool),
              client=np.zeros(M, np.int32), desc=np.zeros((M, 32), np.uint8),
              normal=np.zeros((M, 3), np.float32), min_dist=np.zeros(M, np.float32),
              max_dist=np.zeros(M, np.float32), ref_kf=np.zeros(M, np.int32),
              first_kf=np.zeros(M, np.int32), n_visible=np.ones(M, np.int32),
              n_found=np.ones(M, np.int32))
    n_mp = [0]

    def add_points(X, desc, ref):
        T = est[ref]
        pc = X @ T[:3, :3].T + T[:3, 3]
        dist = np.linalg.norm(pc, axis=1)
        ctr = -T[:3, :3].T @ T[:3, 3]
        nrm = X - ctr
        rows = np.arange(n_mp[0], n_mp[0] + len(X))
        n_mp[0] += len(X)
        mp["pos"][rows], mp["desc"][rows], mp["valid"][rows] = X, desc, True
        mp["normal"][rows] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
        mp["max_dist"][rows], mp["min_dist"][rows] = dist, dist / 1.2 ** 3
        mp["ref_kf"][rows] = mp["first_kf"][rows] = ref
        return rows

    def observe(i, X, desc, rows):
        T = est[i]
        pc = X @ T[:3, :3].T + T[:3, 3]
        uv = pc[:, :2] / pc[:, 2:] * 320.0 + [160.0, 120.0]
        k = len(X)
        kf["Tcw"][i], kf["valid"][i], kf["frame_id"][i] = T, True, i
        kf["xy"][i, :k], kf["desc"][i, :k], kf["fvalid"][i, :k] = uv, desc, True
        kf["depth"][i, :k], kf["uright"][i, :k] = pc[:, 2], uv[:, 0] - 160.0 / pc[:, 2]
        kf["mp_idx"][i, :k] = rows

    X0 = np.stack([rng.uniform(-4, 4, N_PTS), rng.uniform(-3, 3, N_PTS),
                   rng.uniform(6, 14, N_PTS)], -1).astype(np.float32)
    desc0 = rng.integers(0, 256, (N_PTS, 32), dtype=np.uint8)
    rows0 = add_points(X0, desc0, 0)
    for i in range(4):
        observe(i, X0, desc0, rows0)
    for i in range(4, 16):
        Xi = X0 + np.float32([2.0 * np.sin(np.pi * i / (N_KF - 1)), 0, 0])
        pc = Xi @ gt[i][:3, :3].T + gt[i][:3, 3]
        Xe = ((pc - est[i][:3, 3]) @ est[i][:3, :3]).astype(np.float32)
        di = rng.integers(0, 256, (N_PTS, 32), dtype=np.uint8)
        observe(i, Xe, di, add_points(Xe, di, i))
    T_e, T_g = est[-4], gt[-4]
    pc = X0 @ T_g[:3, :3].T + T_g[:3, 3]
    X_dup = ((pc - T_e[:3, 3]) @ T_e[:3, :3]).astype(np.float32)
    rows_dup = add_points(X_dup, desc0, N_KF - 4)
    for i in range(N_KF - 4, N_KF):
        est[i] = est[N_KF - 4].copy()
        observe(i, X_dup, desc0, rows_dup)
    return dict(kf=kf, mp=mp, n_kf=N_KF, n_mp=n_mp[0]), np.stack(gt), np.stack(est)


def jax_map(d):
    return jms.MapState(jms.KeyFrames(**{k: jnp.asarray(v) for k, v in d["kf"].items()}),
                        jms.MapPoints(**{k: jnp.asarray(v) for k, v in d["mp"].items()}),
                        jnp.int32(d["n_kf"]), jnp.int32(d["n_mp"]))


def close(a, b, atol, mask=None):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def state():
    d, gt, est = loop_map()
    return d, gt, est


@jax.jit
def _draw(desc_q, valid_q, desc_c, mp_c, valid_c, key, k_hyp):
    """jax.random.choice of the reference's RANSAC on a descriptor match set:
    the index array its solver draws inside (k_hyp: a [256, k] template)."""
    res = jmatcher.search_by_descriptor(desc_q, valid_q, desc_c, valid_c & (mp_c >= 0),
                                        max_dist=JCFG.matcher.th_low, ratio=0.75)
    p = ((res.idx >= 0) & (mp_c[jnp.clip(res.idx, 0)] >= 0)).astype(jnp.float32)
    return jax.random.choice(key, F, shape=k_hyp.shape, p=p / jnp.maximum(p.sum(), 1.0))


def sim3_draw(jm, kf_q, kf_c, key):
    """The index array jlc.compute_sim3 draws inside solve_sim3_ransac."""
    mp_q = jm.kf.mp_idx[kf_q]
    idx = _draw(jm.kf.desc[kf_q], jm.kf.fvalid[kf_q] & (mp_q >= 0), jm.kf.desc[kf_c],
                jm.kf.mp_idx[kf_c], jm.kf.fvalid[kf_c], key, jnp.zeros((256, 3)))
    return t_(np.asarray(idx, np.int32))


def test_compute_sim3_and_the_correction_with_the_references_draw(state):
    d, gt, est = state
    jm, pm = jax_map(d), interop.map_from_numpy(d)
    kf_q, kf_c = N_KF - 1, 0
    key = jax.random.PRNGKey(0)
    sj = jlc.compute_sim3(JCAM, jm, kf_q, kf_c, key, JCFG, fix_scale=True)
    sp = lc.compute_sim3(CAM, pm, kf_q, kf_c, CFG, fix_scale=True,
                         sample=sim3_draw(jm, kf_q, kf_c, key))
    assert bool(sj.ok) and bool(sp.ok)
    for name in ("n_bow", "n_total", "n_inliers"):
        assert int(getattr(sp, name)) == int(getattr(sj, name)), name
    close(sp.R, sj.R, 1e-4)
    close(sp.t, sj.t, 1e-4)
    # The correction from the reference's Sim3 on both maps.
    meas = jm.kf.Tcw
    jm1, wj = jlc.correct_window(jm, kf_q, kf_c, sj.R, sj.t, sj.s, JCFG)
    pm1, wp = lc.correct_window(pm, kf_q, kf_c, t_(sj.R), t_(sj.t), t_(sj.s), CFG)
    assert np.array_equal(wp.numpy(), np.asarray(wj))
    close(pm1.kf.Tcw, jm1.kf.Tcw, 1e-4)
    close(pm1.mp.pos, jm1.mp.pos, 1e-4)
    jm2 = jlc.fuse_loop_points(JCAM, jm1, kf_q, kf_c, JCFG)
    pm2 = lc.fuse_loop_points(CAM, pm1, kf_q, kf_c, CFG)
    assert np.array_equal(pm2.kf.mp_idx.numpy(), np.asarray(jm2.kf.mp_idx))
    assert np.array_equal(pm2.mp.valid.numpy(), np.asarray(jm2.mp.valid))
    assert int(pm2.mp.valid.sum()) < d["n_mp"]  # duplicates merged
    loops_j = jlc.LoopEdges.empty().add(0, kf_c, kf_q, sj.R, sj.t, sj.s)
    loops_p = lc.LoopEdges.empty().add(0, kf_c, kf_q, t_(sj.R), t_(sj.t), t_(sj.s))
    jm3, cj = jlc.optimize_essential_graph(jm2, loops_j, kf_c, meas, JCFG, n_iters=20)
    pm3, cp = lc.optimize_essential_graph(pm2, loops_p, kf_c, t_(meas), CFG, n_iters=20)
    close(pm3.kf.Tcw, jm3.kf.Tcw, 1e-4)
    close(pm3.mp.pos, jm3.mp.pos, 1e-4, mask=np.asarray(jm3.mp.valid))
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-3, atol=1e-6)
    # The loop removed most of the drift at the query (whose view is the
    # true pose of keyframe 16, where the revisit began).
    err = np.abs(pm3.kf.Tcw[kf_q, 0, 3].item() - gt[N_KF - 4][0, 3])
    assert err < 0.3 * abs(est[kf_q][0, 3] - gt[N_KF - 4][0, 3])


def groups(closer):
    return [(sorted(g.rows), g.count) for g in closer.consistent_groups]


def test_loop_closer_sequence_compaction_and_relocalization(state):
    d, _, _ = state
    jm, pm = jax_map(d), interop.map_from_numpy(d)
    jv, pv = JV.load_default(), vocab.load_default("cpu")
    jc = jlc.LoopCloser(JCAM, JCFG, jv, fix_scale=True, run_gba=False, seed=0)
    pc = lc.LoopCloser(CAM, CFG, pv, fix_scale=True, run_gba=False, seed=0)
    for row in range(N_KF):
        jm = jc.process_keyframe(jm, row)
        pm = pc.process_keyframe(pm, row)
        assert groups(pc) == groups(jc), row
        for name in ("n_detections", "n_sim3_attempts", "n_loops_closed", "last_loop"):
            assert getattr(pc.stats, name) == getattr(jc.stats, name), (row, name)
    assert pc.stats.n_loops_closed == 1 and pc.last_loop_kf == jc.last_loop_kf
    close(pc.db.bow, jc.db.bow, 1e-6)
    assert np.array_equal(pc.db.valid.numpy(), np.asarray(jc.db.valid))
    assert np.array_equal(pc.loops.valid.numpy(), np.asarray(jc.loops.valid))
    close(pm.kf.Tcw, jm.kf.Tcw, 1e-3)
    # A compaction after two culled keyframes: the closer follows the rows.
    kill = np.zeros(CAP["max_keyframes"], bool)
    kill[[5, 8]] = True
    rj = jms.compact(jms.cull_keyframes(jm, jnp.asarray(kill)))
    rp = ms.compact(ms.cull_keyframes(pm, t_(kill)))
    jc.remap_rows(rj)
    pc.remap_rows(rp)
    close(pc.db.bow, jc.db.bow, 1e-6)
    assert np.array_equal(pc.db.valid.numpy(), np.asarray(jc.db.valid))
    for name in ("i", "j", "valid"):
        assert np.array_equal(getattr(pc.loops, name).numpy(), np.asarray(getattr(jc.loops, name)))
    assert pc.last_loop_kf == jc.last_loop_kf
    # Relocalization of a frame seeing scene A (keyframe 2's features, no pose).
    m, jmc = rp.m, rj.m
    fd = {f: np.asarray(getattr(jmc.kf, f)[2]) for f in ("xy", "octave", "angle", "desc",
                                                          "fvalid", "uright", "depth")}
    jf = jframe.FrameData(**{k: jnp.asarray(v) for k, v in fd.items()}, Tcw=jnp.eye(4),
                          mp_idx=jnp.full(F, -1, jnp.int32))
    pf = frame.FrameData(**{k: t_(v) for k, v in fd.items()}, Tcw=torch.eye(4),
                         mp_idx=torch.full((F,), -1, dtype=torch.int32))
    key = jax.random.PRNGKey(5)
    cand = 0
    rj_ = jreloc.try_relocalize_against(JCAM, jmc, cand, jf, key, JCFG)
    idx = _draw(jf.desc, jf.fvalid, jmc.kf.desc[cand], jmc.kf.mp_idx[cand], jmc.kf.fvalid[cand],
                key, jnp.zeros((256, 6)))
    rp_ = reloc.try_relocalize_against(CAM, m, cand, pf, CFG,
                                       sample=t_(np.asarray(idx, np.int32)))
    assert bool(rp_.ok) == bool(rj_.ok) and bool(rp_.ok)
    assert int(rp_.n_inliers) == int(rj_.n_inliers)
    assert np.array_equal(rp_.mp_idx.numpy(), np.asarray(rj_.mp_idx))
    close(rp_.Tcw, rj_.Tcw, 1e-4)
    out = reloc.relocalize(CAM, m, pc.db, pv, pf, CFG, generator=torch.Generator().manual_seed(0))
    assert out is not None and bool(out.ok)
    close(out.Tcw, jmc.kf.Tcw[2], 1e-2)


def test_loop_closer_with_global_ba_and_the_trackers_take_it_on_the_cpu():
    """A closer with global BA (and one without) in the stereo tracker, a
    reset, and a mono tracker with a free-scale closer over a few frames of
    the room orbit."""
    from corbslam_tpu_torch import entry
    from corbslam_tpu_torch.frontend.tracking import StereoTracker
    from corbslam_tpu_torch.io import synthetic

    pv = vocab.load_default("cpu")
    for run_gba in (True, False):
        closer = lc.LoopCloser(CAM, CFG, pv, run_gba=run_gba)
        assert (closer.gba_runner is not None) == run_gba
        tr = StereoTracker(CAM, CFG, loop_closer=closer, device="cpu")
        assert tr.loop_closer is closer and tr.loop_closer.try_merge_gba(tr.map) is tr.map
        tr.reset()
        assert closer.n_loops == 0 and not bool(closer.db.valid.any())
        assert dataclasses.asdict(tr.stats)["n_relocalizations"] == 0
    world = synthetic.MultiPlaneWorld.room(CAM, half=14.0, height=3.0, seed=2)
    mono = StereoTracker(CAM, CFG, loop_closer=lc.LoopCloser(CAM, CFG, pv, fix_scale=False),
                         device="cpu")
    for i in range(4):
        mono.process_mono(world.render(entry.orbit_pose(i)), 0.1 * i)
    assert len(mono.frame_states) == 4 and mono.loop_closer.gba_runner.runs_started == 0
