"""The port's endurance run (`entry.endurance_entry` / `run_endurance`)
against the reference's (bench.py:118-206) on the CPU: its setup, and a map
compaction that meets a running global BA.

The whole 1050-frame run is compared by outcome on the card
(`chip_smoke.py`, against tests/yardstick_endurance.py's CPU run of the
reference), never frame by frame here: the vocabulary's draw, the noise and
the RANSAC draws differ by construction.

The compaction: the synthetic loop map of test_torch_loop.py with two
keyframes culled, the same BoW database rows, loop edges and last loop on
both sides, each side's global BA held in its first chunk until its abort
flag is raised (the hold of test_torch_gba.py), then the tracker's
`_compact_map`. Both must count one abort, keep no result, merge nothing,
and leave the same rows, loop edges, database and row references (exact:
integer work and row moves).
"""

import dataclasses
import threading
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

from corbslam_tpu.config import CapacityConfig as JCapacity
from corbslam_tpu.config import MappingConfig as JMapping
from corbslam_tpu.config import OrbConfig as JOrb
from corbslam_tpu.config import SlamConfig as JSlam
from corbslam_tpu.config import TrackingConfig as JTracking
from corbslam_tpu.frontend.tracking import StereoTracker as JTracker
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.loop import gba as jgba
from corbslam_tpu.loop import loop_closing as jlc
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu.place import database as jdb
from corbslam_tpu.place import vocab as JV
from corbslam_tpu_torch import entry, interop
from corbslam_tpu_torch.frontend.tracking import StereoTracker
from corbslam_tpu_torch.loop import loop_closing as lc
from corbslam_tpu_torch.mapstate import mapstate as ms
from corbslam_tpu_torch.place import vocab
from test_torch_loop import CAM, CAP, CFG, JCAM, JCFG, N_KF, jax_map, loop_map, t_

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parent.parent / "bench.py"


def test_endurance_setup_is_the_benchs():
    """The entry's camera, config, world, orbit, frame count, warm-up and
    training frames are bench.py:135-160's (the bench's own lines, read from
    its source, and its config rebuilt in the JAX package)."""
    src = BENCH.read_text()
    for line in ("fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5",
                 "width=320, height=240",
                 "orb=OrbConfig(n_features=512, n_levels=4, cell_size=12)",
                 "tracking=TrackingConfig(th_depth=40.0, max_frames_between_kf=10)",
                 "mapping=MappingConfig(local_ba_window=8, local_ba_iters=6)",
                 "max_keyframes=256, max_map_points=32768, max_features=512",
                 "local_window_kfs=8, local_window_mps=2048",
                 "cam, half=14.0, height=3.0, n_boxes=5, box_ring=8.0, seed=3)",
                 "step, radius, n_frames = 0.05, 6.0, 1050",
                 "for i in (0, n_frames // 7, 2 * n_frames // 7):",
                 "n_words=1024, n_iters=6",
                 "enable_loop_closing=True, run_gba=True",
                 "if i == 100:"):
        assert line in src, line
    jcfg = JSlam(orb=JOrb(n_features=512, n_levels=4, cell_size=12),
                 tracking=JTracking(th_depth=40.0, max_frames_between_kf=10),
                 mapping=JMapping(local_ba_window=8, local_ba_iters=6),
                 capacity=JCapacity(max_keyframes=256, max_map_points=32768, max_features=512,
                                    local_window_kfs=8, local_window_mps=2048))
    assert dataclasses.asdict(entry.loop_config()) == dataclasses.asdict(jcfg)
    jcam = jcamera.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5,
                                     width=320, height=240)
    assert tuple(entry.LOOP_CAM) == tuple(jcam)
    assert entry.ENDURANCE_WORLD == dict(half=14.0, height=3.0, n_boxes=5, box_ring=8.0, seed=3)
    assert (entry.ENDURANCE_STEP, entry.ENDURANCE_RADIUS, entry.ENDURANCE_FRAMES,
            entry.ENDURANCE_WARM, entry.E2E_WORDS, entry.E2E_TRAIN_ITERS) == (
        0.05, 6.0, 1050, 100, 1024, 6)
    for i in (0, 125, 1049):  # the bench's gt_pose(i)
        th = 0.05 * i
        ref = jse3.inverse(jse3.compose(
            jse3.exp(jnp.asarray([0, 0, 0, 0.0, th, 0.0], jnp.float32)),
            jse3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -6.0]))))
        np.testing.assert_allclose(
            entry.orbit_pose(i, entry.ENDURANCE_STEP, entry.ENDURANCE_RADIUS).numpy(),
            np.asarray(ref), atol=1e-6)


def test_a_compaction_meets_a_held_global_ba_as_the_reference(monkeypatch):
    d, _, _ = loop_map()
    kill = np.zeros(CAP["max_keyframes"], bool)
    kill[[5, 8]] = True
    jm = jms.cull_keyframes(jax_map(d), jnp.asarray(kill))
    pm = ms.cull_keyframes(interop.map_from_numpy(d), t_(kill))
    jv, pv = JV.load_default(), vocab.load_default("cpu")
    jc = jlc.LoopCloser(JCAM, JCFG, jv, fix_scale=True, run_gba=True, seed=0)
    pc = lc.LoopCloser(CAM, CFG, pv, fix_scale=True, run_gba=True, seed=0)
    rng = np.random.default_rng(3)
    bow = rng.random((CAP["max_keyframes"], jv.n_words), dtype=np.float32)
    valid = d["kf"]["valid"].copy()
    jc.db = jdb.BowDatabase(jnp.asarray(bow), jnp.asarray(valid))
    pc.db = interop.db_from_numpy(dict(bow=bow, valid=valid))
    for n, (kf_c, kf_q) in enumerate([(2, 19), (5, 17), (0, 12)]):  # 5 is culled
        jc.loops = jc.loops.add(n, kf_c, kf_q, jnp.eye(3), jnp.zeros(3), 1.0)
        pc.loops = pc.loops.add(n, kf_c, kf_q, torch.eye(3), torch.zeros(3), torch.tensor(1.0))
    jc.last_loop_kf = pc.last_loop_kf = 19
    jt = JTracker(JCAM, JCFG, loop_closer=jc)
    pt = StereoTracker(CAM, CFG, loop_closer=pc, device="cpu")
    jt.map, pt.map = jm, pm
    jt.ref_kf = pt.ref_kf = 19
    jt._ref_kf_dev, pt._ref_kf_dev = jnp.int32(19), torch.tensor(19, dtype=torch.int32)
    jt._kf_cursor_est = pt._kf_cursor_est = N_KF
    jg, pg = jc.gba_runner, pc.gba_runner
    assert not jg.synchronous and not pg.synchronous
    started = dict(jax=threading.Event(), port=threading.Event())

    def jax_hold(cam, prob, **kw):  # the reference's chunk, held until the abort
        started["jax"].set()
        jg._abort.wait(30)
        return types.SimpleNamespace(cost=jnp.zeros(()), Tcw=prob.Tcw, X=prob.X)

    monkeypatch.setattr(jgba.ba_dense, "optimize", jax_hold)
    chunk = pg._chunk

    def port_hold(prob, k):
        started["port"].set()
        pg._abort.wait(30)
        return chunk(prob, k)

    pg._chunk = port_hold
    jg.launch(jt.map)
    pg.launch(pt.map)
    assert started["jax"].wait(30) and started["port"].wait(30) and jg.busy() and pg.busy()
    jt._compact_map()
    pt._compact_map()
    for g in (jg, pg):
        assert (g.runs_started, g.runs_finished, g.runs_aborted) == (1, 0, 1)
        assert not g.busy() and g._result is None
    assert pc.try_merge_gba(pt.map) is pt.map and jc.try_merge_gba(jt.map) is jt.map
    assert pt.stats.n_compactions == jt.stats.n_compactions == 1
    assert (pt.map_epoch, pt.ref_kf, pt._kf_cursor_est, int(pt._ref_kf_dev)) == (
        jt.map_epoch, jt.ref_kf, jt._kf_cursor_est, int(jt._ref_kf_dev))
    assert int(pt.map.n_kf) == int(jt.map.n_kf) == N_KF - 2
    for part, names in (("kf", ("valid", "frame_id", "Tcw", "mp_idx")),
                        ("mp", ("valid", "ref_kf", "first_kf", "pos"))):
        for name in names:
            np.testing.assert_array_equal(getattr(getattr(pt.map, part), name).numpy(),
                                          np.asarray(getattr(getattr(jt.map, part), name)),
                                          err_msg=f"{part}.{name}")
    for name in ("i", "j", "valid"):
        np.testing.assert_array_equal(getattr(pc.loops, name).numpy(),
                                      np.asarray(getattr(jc.loops, name)), err_msg=name)
    assert pc.loops.valid.sum() == 2 and pc.last_loop_kf == jc.last_loop_kf == 17
    np.testing.assert_array_equal(pc.db.bow.numpy(), np.asarray(jc.db.bow))
    np.testing.assert_array_equal(pc.db.valid.numpy(), np.asarray(jc.db.valid))
    np.testing.assert_array_equal(pt._local_rows.numpy(), np.asarray(jt._local_rows))
    client = types.SimpleNamespace(tracker=pt, loop_closer=pc)
    assert entry.live_rows_ok(client)
