"""The port's `StereoTracker` (`frontend/tracking.py`, all kernels on their
plain versions on the CPU) against the JAX tracker, at the small size of
tests/test_pipeline.py (320x240, 512 features, 4 levels, capacities 64 / 8192
/ 512, windows 8 / 2048) on its PlanarWorld, with a keyframe forced on every
frame (max_frames_between_kf=1), so the fuse, cull, refresh, split local BA,
keyframe-cull and sweep stages all run. Both trackers get the same images
(rendered by the JAX world).

Tolerances and why: the state machine and the keyframe policy are host
decisions on counts, so per-frame states and the frames that became
keyframes are exact; n_local within 2 % and camera centres within 2e-3 m,
because the local BA's f32 LM sums in another order than XLA (see
tests/test_torch_local_mapping.py), and the map it leaves feeds the next
frames; both trajectories within tests/test_pipeline.py's ATE bound of 0.06.
The run is 10 frames: at frames 10-11 of this sequence the two packages'
centres drift 1-3 mm apart on rounding, and 1e-3 of image noise moves the
port's own by ~1 mm at frames 8-9 already (measured), so longer runs test
the sequence's sensitivity rather than the port.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu import config as jconfig
from corbslam_tpu.frontend.tracking import StereoTracker as JTracker
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.io import trajectory as jtrajectory
from corbslam_tpu_torch import config, entry
from corbslam_tpu_torch.frontend.tracking import StereoTracker, TrackState
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.io import trajectory
from corbslam_tpu_torch.mapstate import mapstate as ms

torch.set_num_threads(2)

KW = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5, width=320, height=240)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)
N_FRAMES = 10


def small_cfg(C, **tracking):
    kw = dict(th_depth=40.0, max_frames_between_kf=10)
    kw.update(tracking)
    return C.SlamConfig(
        orb=C.OrbConfig(n_features=512, n_levels=4, cell_size=12),
        tracking=C.TrackingConfig(**kw),
        mapping=C.MappingConfig(local_ba_window=8, local_ba_iters=6),
        capacity=C.CapacityConfig(max_keyframes=64, max_map_points=8192, max_features=512,
                                  local_window_kfs=8, local_window_mps=2048),
    )


FORCED = dict(min_frames_between_kf=0, max_frames_between_kf=1)


def gt_pose(i):
    tilt = jse3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    return jse3.compose(tilt, jse3.exp(jnp.asarray([-(i * 0.12), 0.0, -(i * 0.03), 0.0,
                                                    i * 0.004, 0.0], jnp.float32)))


@pytest.fixture(scope="module")
def images():
    world = jsynthetic.PlanarWorld(JCAM, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
    render = jax.jit(world.render_stereo)
    return [tuple(np.asarray(a) for a in render(gt_pose(i))) for i in range(N_FRAMES)]


def run_port(images, **tracking):
    tr = StereoTracker(CAM, small_cfg(config, **tracking), device="cpu")
    for i, (l, r) in enumerate(images):
        tr.process_stereo(l, r, i * 0.1)
    tr.flush()
    return tr


@pytest.fixture(scope="module")
def runs(images):
    jt = JTracker(JCAM, small_cfg(jconfig, **FORCED))
    for i, (l, r) in enumerate(images):
        jt.process_stereo(jnp.asarray(l), jnp.asarray(r), i * 0.1)
    jt.flush()
    return jt, run_port(images, **FORCED)


def ate(tr) -> float:
    est = np.asarray([np.linalg.inv(np.asarray(T, np.float64)) for _, T in tr.trajectory])
    gtw = np.asarray([np.linalg.inv(np.asarray(gt_pose(i), np.float64))
                      for i in range(len(est))])
    return trajectory.ate_rmse(est, gtw, align=True)


def centres(tr) -> np.ndarray:
    return np.asarray([-np.asarray(T)[:3, :3].T @ np.asarray(T)[:3, 3] for _, T in tr.trajectory])


def test_tracker_equals_the_reference(runs):
    jt, pt = runs
    assert [s.name for s in pt.frame_states] == [s.name for s in jt.frame_states]
    assert all(s == TrackState.OK for s in pt.frame_states)
    n_kf = int(jt.map.n_kf)
    assert int(pt.map.n_kf) == n_kf == pt.stats.n_keyframes == N_FRAMES
    np.testing.assert_array_equal(pt.map.kf.frame_id[:n_kf].numpy(),
                                  np.asarray(jt.map.kf.frame_id)[:n_kf])
    np.testing.assert_array_equal(pt.map.kf.valid.numpy(), np.asarray(jt.map.kf.valid))
    jl, pl = np.asarray(jt.stats.inliers_history), np.asarray(pt.stats.inliers_history)
    assert jl.shape == pl.shape and (np.abs(pl - jl) <= 0.02 * jl).all()
    assert np.linalg.norm(centres(pt) - centres(jt), axis=1).max() <= 2e-3
    assert ate(pt) < 0.06 and ate(jt) < 0.06, (ate(pt), ate(jt))
    # Every stage kind ran, the split local BA on each keyframe from the third.
    st = pt.stats.stages
    assert st["fuse"] == N_FRAMES - 1 and st["ba_build"] == st["ba_a"] == st["ba_b"] == N_FRAMES - 2
    assert st["cull_points"] and st["refresh"] and st["cull_keyframes"] and st["sweep"]
    assert bool(torch.isfinite(pt.map.kf.Tcw).all()) and bool(torch.isfinite(pt.map.mp.pos).all())


def test_trajectory_exports(runs, tmp_path):
    jt, pt = runs
    rows = pt.trajectory_kitti()
    assert rows.shape == (N_FRAMES, 3, 4)
    np.testing.assert_allclose(rows, jt.trajectory_kitti(), atol=3e-3)
    path = tmp_path / "traj.txt"
    trajectory.save_kitti(str(path), rows)
    assert np.loadtxt(path).shape == (N_FRAMES, 12)
    src = np.random.default_rng(0).normal(size=(20, 3))
    dst = src @ np.asarray(jse3.exp(jnp.asarray([0, 0, 0, .1, .2, .3])))[:3, :3].T + 1.0
    for a, b in zip(trajectory.umeyama_alignment(src, dst, True),
                    jtrajectory.umeyama_alignment(src, dst, True)):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_compaction_equals_the_reference(images):
    """A keyframe table of 8 rows: at 6 used rows the tracker flushes and
    repacks the map (`_compact_map`), remapping its row references and
    bumping map_epoch, exactly as the reference does: the same compactions,
    keyframe rows, flags, anchors, counters, local window and states.
    Centres agree within 2e-3 m up to frame 7; the last two frames are left
    out because there the map is so sensitive that 1e-3 of image noise moves
    them by 1 cm in the port alone (measured), and the two packages'
    rounding does the same (9 mm)."""
    caps = dict(max_keyframes=8)
    jt = JTracker(JCAM, small_cfg(jconfig, **FORCED).replace(
        capacity=dataclasses.replace(small_cfg(jconfig).capacity, **caps)))
    pt = StereoTracker(CAM, small_cfg(config, **FORCED).replace(
        capacity=dataclasses.replace(small_cfg(config).capacity, **caps)), device="cpu")
    for i, (l, r) in enumerate(images):
        jt.process_stereo(jnp.asarray(l), jnp.asarray(r), i * 0.1)
        pt.process_stereo(l, r, i * 0.1)
    jt.flush()
    pt.flush()
    assert pt.stats.n_compactions == jt.stats.n_compactions == 1
    assert pt.map_epoch == jt.map_epoch and pt._kf_cursor_est == jt._kf_cursor_est
    assert pt.ref_kf == jt.ref_kf and [s.name for s in pt.frame_states] == [
        s.name for s in jt.frame_states]
    for part, names in (("kf", ("valid", "frame_id")),
                        ("mp", ("valid", "ref_kf", "first_kf", "n_visible", "n_found"))):
        for name in names:
            np.testing.assert_array_equal(getattr(getattr(pt.map, part), name).numpy(),
                                          np.asarray(getattr(getattr(jt.map, part), name)),
                                          err_msg=f"{part}.{name}")
    assert (pt.map.kf.mp_idx.numpy() != np.asarray(jt.map.kf.mp_idx)).mean() < 1e-3
    np.testing.assert_array_equal(pt._local_rows.numpy(), np.asarray(jt._local_rows))
    assert np.linalg.norm(centres(pt) - centres(jt), axis=1)[:8].max() <= 2e-3


def _bare_tracker(pt):
    """A tracker holding an independent copy of `pt`'s map."""
    tr = StereoTracker(CAM, small_cfg(config, **FORCED), device="cpu")
    tr.map = ms.clone(pt.map)
    return tr


def test_local_ba_writeback_aborts_on_epoch_bump(runs):
    """A split local BA built before a map_epoch bump leaves the map's poses,
    points and observations as they were, by value."""
    _, pt = runs
    tr = _bare_tracker(pt)
    before = ms.clone(tr.map)
    st = {}
    tr._stage_local_ba_build(pt.ref_kf, st)
    tr.map_epoch += 1
    tr._stage_local_ba_a(st)
    assert st["res"] is None
    tr._stage_local_ba_b(st)
    for a, b in ((tr.map.kf.Tcw, before.kf.Tcw), (tr.map.mp.pos, before.mp.pos),
                 (tr.map.kf.mp_idx, before.kf.mp_idx)):
        assert torch.equal(a, b)


def test_local_ba_writeback_commits(runs):
    _, pt = runs
    tr = _bare_tracker(pt)
    before = ms.clone(tr.map)
    st = {}
    tr._stage_local_ba_build(pt.ref_kf, st)
    tr._stage_local_ba_a(st)
    assert st["res"] is not None
    tr._stage_local_ba_b(st)
    moved = (tr.map.mp.pos - before.mp.pos).abs().max(dim=1).values
    assert int((moved > 0).sum()) > 100 and float(moved.max()) < 0.5
    assert bool(torch.isfinite(tr.map.kf.Tcw).all())
    # The problem held copies: the build's poses are the map's before the run.
    assert torch.equal(st["prob"].Tcw, before.kf.Tcw[st["sel"].kf_rows.long()])


def test_early_hard_reset_on_blank_frames(images):
    """Lost while the map holds <= 5 keyframes: reset, then a fresh
    bootstrap from the next good frame (Tracking.cc:470-478)."""
    tr = StereoTracker(CAM, small_cfg(config), device="cpu")
    blank = np.zeros((240, 320), np.float32)
    seq = [images[i] for i in range(3)] + [(blank, blank)] * 3 + [images[i] for i in range(3, 8)]
    for i, (l, r) in enumerate(seq):
        tr.process_stereo(l, r, i * 0.1)
    tr.flush()
    assert tr.stats.n_resets >= 1
    assert tr.state == TrackState.OK and 1 <= tr.stats.n_keyframes <= 5
    states = [s.name for s in tr.frame_states]
    assert "LOST" in states or "NOT_INITIALIZED" in states
    # The reset drops the frames still in flight, as the reference's does.
    assert states[-1] == "OK" and len(tr.trajectory) < len(seq)
    assert bool(torch.isfinite(tr.map.kf.Tcw).all())


def test_two_frames_per_dispatch_with_an_odd_count(images):
    """frames_per_dispatch=2 over 7 frames: the odd last frame goes through
    the one-frame step at flush, every frame is tracked."""
    tr = run_port(images[:7], frames_per_dispatch=2)
    assert len(tr.trajectory) == 7 and tr.stats.n_frames == 7
    assert all(s == TrackState.OK for s in tr.frame_states)
    assert ate(tr) < 0.06


def test_bench_schedule_order():
    """run_bench_schedule replays bench.py's calls: 6 frames, 6 forced
    keyframes from the last frame, 12 frames, flush, then two windows of 30
    frames with a flush after each; measured frames and the windows' flushes
    go through `step`."""
    calls = []

    class Probe:
        last_frame = "last"

        def process_stereo(self, l, r, ts):
            calls.append(("frame", l, round(ts, 6)))

        def _create_keyframe(self, cur, ts, n):
            calls.append(("kf", cur, round(ts, 6), n))

        def flush(self):
            calls.append(("flush",))

    steps = []
    frames = [(i, -i) for i in range(entry.BENCH_FRAMES)]
    entry.run_bench_schedule(Probe(), frames, step=lambda i, fn: (steps.append(i), fn()))
    want = ([("frame", i, round(0.1 * i, 6)) for i in range(6)]
            + [("kf", "last", round(0.05 * k, 6), 120) for k in range(6)]
            + [("frame", i, round(0.1 * i, 6)) for i in range(6, 18)] + [("flush",)]
            + [("frame", i, round(0.1 * i, 6)) for i in range(18, 48)] + [("flush",)]
            + [("frame", i, round(0.1 * i, 6)) for i in range(48, 78)] + [("flush",)])
    assert calls == want and steps == list(range(18, 48)) + [None] + list(range(48, 78)) + [None]
    cfg = entry.bench_config()
    assert cfg.tracking.frames_per_dispatch == 2 and cfg.capacity.max_keyframes == 2048
    with pytest.raises(ValueError, match="frames"):
        entry.run_bench_schedule(Probe(), frames[:10])
    calls.clear()
    entry.run_bench_schedule(Probe(), frames[:8], stop=8)  # a prefix, then a flush
    assert calls == want[:14] + [("flush",)]
    calls.clear()
    entry.run_bench_schedule(Probe(), frames[:8], stop=8, start=1)  # frame 0 already fed
    assert calls == want[1:14] + [("flush",)]
    calls.clear()
    entry.run_bench_schedule(Probe(), frames, stop=20)
    assert calls == want[:25] + [("frame", 18, 1.8), ("frame", 19, 1.9), ("flush",)]


def test_tracker_defaults_to_cuda_and_keeps_its_slice():
    with pytest.raises(RuntimeError, match="cuda"):
        StereoTracker(CAM, small_cfg(config))
    with pytest.raises(RuntimeError, match="cuda"):
        entry.tracker_entry()
    with pytest.raises(ValueError, match="loop closer on"):
        StereoTracker(CAM, small_cfg(config), loop_closer=SimpleNamespace(
            device=torch.device("meta")), device="cpu")
    # Mono takes a loop closer (free-scale Sim3 and global BA): a featureless
    # frame leaves it waiting for initialization.
    lc_tr = StereoTracker(CAM, small_cfg(config), device="cpu",
                          loop_closer=SimpleNamespace(device=torch.device("cpu")))
    img = np.zeros((240, 320), np.float32)
    lc_tr.process_mono(img, 0.0)
    assert lc_tr.sensor == "mono" and lc_tr.frame_states == [TrackState.NOT_INITIALIZED]
    # Both other sensors run on the CPU port: a featureless frame leaves the
    # tracker waiting for initialization, as in the reference.
    for sensor in ("mono", "rgbd"):
        tr = StereoTracker(CAM, small_cfg(config), device="cpu")
        if sensor == "mono":
            tr.process_mono(img, 0.0)
        else:
            tr.process_rgbd(img, img, 0.0)
        assert tr.sensor == sensor and tr.frame_states == [TrackState.NOT_INITIALIZED]
    assert dataclasses.asdict(small_cfg(config)) == dataclasses.asdict(small_cfg(jconfig))
