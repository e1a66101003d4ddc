"""The port's `system.CorbslamClient` trajectory exports and map checkpoint,
and `apps/run_client.py`, against the JAX package on the CPU.

The exports are fed one trajectory and one map (the synthetic loop map of
test_torch_loop.py) on both sides and must write the reference's columns
and values (to 1e-6: the same f32 inverse and quaternion, printed with 7
decimals). The checkpoint is the reference's npz key for key, so each
package loads the other's file: tables exact, `voc_bits` in the reference's
bit order (the reference's own `word_bits` of the same vocabulary).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu import system as jsystem
from corbslam_tpu.place import database as jdb
from corbslam_tpu.place import vocab as JV
from corbslam_tpu_torch import interop, system
from corbslam_tpu_torch.frontend.tracking import TrackState
from corbslam_tpu_torch.geometry import se3
from corbslam_tpu_torch.place import vocab
from test_torch_loop import CAM, CAP, CFG, JCAM, JCFG, N_KF, jax_map, loop_map

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def state():
    d, _, _ = loop_map()
    d["kf"]["timestamp"] = (d["kf"]["frame_id"] * 0.1).astype(np.float32)
    rng = np.random.default_rng(5)
    xi = rng.normal(0.0, 0.3, (12, 6)).astype(np.float32)
    traj = [(0.1 * i, se3.exp(torch.from_numpy(x)).numpy()) for i, x in enumerate(xi)]
    return d, traj, JV.load_default(), vocab.load_default("cpu")


def port_client(d, pv, bow=None):
    """A port client on the CPU holding the map `d` (and, with `bow`, that
    keyframe database)."""
    pc = system.CorbslamClient(CAM, CFG, voc=pv, device="cpu")
    pc.tracker.map = interop.map_from_numpy(d)
    if bow is not None:
        pc.loop_closer.db = interop.db_from_numpy(dict(bow=bow, valid=d["kf"]["valid"].copy()))
    return pc


def clients(d, jv, pv, bow=None):
    """(JAX client, port client), each holding the map `d` (and, with
    `bow`, the same keyframe database)."""
    jc = jsystem.CorbslamClient(JCAM, JCFG, voc=jv)
    jc.tracker.map = jax_map(d)
    if bow is not None:
        jc.loop_closer.db = jdb.BowDatabase(jnp.asarray(bow), jnp.asarray(d["kf"]["valid"]))
    return jc, port_client(d, pv, bow)


def test_trajectory_exports_equal_the_references(state, tmp_path):
    d, traj, jv, pv = state
    jc, pc = clients(d, jv, pv)
    jc.tracker._traj = [(t, T.copy()) for t, T in traj]
    pc.tracker._traj = [(t, T.copy()) for t, T in traj]
    for name, cols, n in (("save_trajectory_kitti", 12, len(traj)),
                          ("save_trajectory_tum", 8, len(traj)),
                          ("save_keyframe_trajectory_tum", 8, N_KF)):
        getattr(jc, name)(str(tmp_path / f"j_{name}.txt"))
        getattr(pc, name)(str(tmp_path / f"p_{name}.txt"))
        a = np.loadtxt(tmp_path / f"p_{name}.txt")
        b = np.loadtxt(tmp_path / f"j_{name}.txt")
        assert a.shape == b.shape == (n, cols), name
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=name)


def same_tables(pm, m, db=None, jdb_=None):
    for part in ("kf", "mp"):
        for k, v in getattr(pm, part)._asdict().items():
            ref = np.asarray(getattr(getattr(m, part), k))
            assert v.numpy().dtype == ref.dtype and np.array_equal(v.numpy(), ref), f"{part}.{k}"
    assert int(pm.n_kf) == int(m.n_kf) and int(pm.n_mp) == int(m.n_mp)
    if db is not None:
        assert np.array_equal(db.bow.numpy(), np.asarray(jdb_.bow))
        assert np.array_equal(db.valid.numpy(), np.asarray(jdb_.valid))


def test_save_and_load_round_trip_on_the_cpu(state, tmp_path):
    d, _, _, pv = state
    bow = np.random.default_rng(1).random((CAP["max_keyframes"], pv.n_words), dtype=np.float32)
    pc = port_client(d, pv, bow)
    path = str(tmp_path / "map.npz")
    pc.save_map(path)
    fresh = system.CorbslamClient(CAM, CFG, voc=pv, device="cpu")
    fresh.load_map(path)
    tr = fresh.tracker
    same_tables(tr.map, pc.tracker.map, fresh.loop_closer.db, pc.loop_closer.db)
    assert tr.map.n_kf.dtype == torch.int32 and tr.map.n_kf.dim() == 0
    assert tr._state == TrackState.LOST and tr.ref_kf == N_KF - 1 and tr._kf_cursor_est == N_KF
    assert tr._ref_kf_dev.dtype == torch.int32 and int(tr._ref_kf_dev) == N_KF - 1


def test_maps_saved_by_either_package_load_in_the_other(state, tmp_path):
    d, _, jv, pv = state
    bow = np.random.default_rng(2).random((CAP["max_keyframes"], jv.n_words), dtype=np.float32)
    jc, pc = clients(d, jv, pv, bow)
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jc.save_map(jpath)
    pc.save_map(ppath)
    jz, pz = np.load(jpath), np.load(ppath)
    assert sorted(jz.files) == sorted(pz.files)
    for k in jz.files:
        assert pz[k].dtype == jz[k].dtype and pz[k].shape == jz[k].shape, k
    np.testing.assert_array_equal(pz["voc_bits"], np.asarray(jv.word_bits))  # its bit order
    np.testing.assert_array_equal(pz["voc_idf"], np.asarray(jv.idf))
    into_port = system.CorbslamClient(CAM, CFG, voc=pv, device="cpu")
    into_port.load_map(jpath)
    ref = interop.map_from_numpy(jc.tracker.map)
    same_tables(into_port.tracker.map, ref, into_port.loop_closer.db, jc.loop_closer.db)
    into_jax = jsystem.CorbslamClient(JCAM, JCFG, voc=jv)
    into_jax.load_map(ppath)
    same_tables(pc.tracker.map, into_jax.tracker.map, pc.loop_closer.db,
                into_jax.loop_closer.db)
    assert into_jax.tracker.ref_kf == into_port.tracker.ref_kf == N_KF - 1


def test_run_client_replays_the_synthetic_world_on_the_cpu(tmp_path):
    """tests/test_system.py's run_client case on the port (8 frames of the
    flagship's planar world, loop closing off), with its metrics lines."""
    from corbslam_tpu_torch.apps import run_client

    out, metrics = tmp_path / "traj.txt", tmp_path / "metrics.jsonl"
    client = run_client.main(["--dataset", "synthetic", "--n-frames", "8", "--no-loop-closing",
                              "--device", "cpu", "--out", str(out), "--metrics", str(metrics)])
    assert np.loadtxt(out).shape == (8, 12)
    lines = [json.loads(x) for x in open(metrics)]
    assert len(lines) == 8 and {"t", "state", "track_ms", "n_kf", "n_mp", "inliers"} <= set(lines[0])
    assert [s.name for s in client.tracker.frame_states] == ["OK"] * 8
    assert client.loop_closer is None and client.tracker.device.type == "cpu"
