"""The port's copies of the JAX package's transports (`collab/wire`,
`socket_transport`, `shm_ring`, `shm_transport`): the wire bytes equal the
JAX package's `pack_arrays` for the same dict (so a client of one package
can talk to a server of the other), the socket transport's round trip,
NACKs and concurrent clients over localhost, the shm ring and one call
across processes (spawned: the pytest process has initialized XLA, and
forked children destabilize it; a 60 s deadline), and the port's shm
library built under `build/` with `native/` left unchanged.
"""

import hashlib
import multiprocessing
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from corbslam_tpu.collab import wire as jwire
from corbslam_tpu_torch.collab import shm_ring, wire
from corbslam_tpu_torch.collab.socket_transport import SocketClientTransport, SocketServerTransport

ROOT = Path(__file__).resolve().parent.parent
NATIVE = ROOT / "native"
mp = multiprocessing.get_context("spawn")


def _messages():
    rng = np.random.default_rng(0)
    F = 16
    return {
        "arrays": {"a": rng.normal(size=(3, 4)).astype(np.float32),
                   "b": rng.integers(0, 255, (7,), dtype=np.uint8),
                   "scalar": np.asarray(5, np.int64), "empty": np.zeros((0, 3), np.float32),
                   "flag": np.asarray([True, False])},
        "kf": wire.kf_insert_msg(
            gid=np.arange(2) + 1_000_000, client=np.ones(2), Tcw=np.tile(np.eye(4), (2, 1, 1)),
            xy=rng.random((2, F, 2)), octave=np.zeros((2, F)), angle=rng.random((2, F)),
            desc=rng.integers(0, 256, (2, F, 32)), uright=rng.random((2, F)),
            depth=rng.random((2, F)), fvalid=rng.random((2, F)) < 0.5,
            mp_gid=rng.integers(-1, 50, (2, F)), frame_id=np.arange(2), timestamp=np.arange(2)),
        "mp": wire.mp_insert_msg(gid=np.arange(3), client=np.full(3, 2), pos=rng.random((3, 3)),
                                 normal=rng.random((3, 3)), desc=rng.integers(0, 256, (3, 32)),
                                 min_dist=rng.random(3), max_dist=rng.random(3) + 1,
                                 ref_kf_gid=np.asarray([-1, 0, 1])),
        "pose": wire.kf_pose_msg(np.arange(4), np.tile(np.eye(4), (4, 1, 1))),
        "transm": wire.transm_msg({2: (np.eye(3), np.ones(3), 1.5), 1: (np.eye(3), np.zeros(3), 1.0)}),
        "empty_transm": wire.transm_msg({}),
    }


@pytest.mark.parametrize("name", ["arrays", "kf", "mp", "pose", "transm", "empty_transm"])
def test_wire_bytes_equal_the_reference(name):
    msg = _messages()[name]
    data = wire.pack_arrays(msg)
    assert data == jwire.pack_arrays(msg)
    out = wire.unpack_arrays(data)
    ref = jwire.unpack_arrays(data)
    assert list(out) == list(msg) == list(ref)
    for k in msg:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
        np.testing.assert_array_equal(out[k], ref[k])
    if name == "transm":
        R, t, s = wire.transm_lookup(out, 2)
        assert s == 1.5 and np.array_equal(t, np.ones(3, np.float32))
        assert wire.transm_lookup(out, 3) is None


@pytest.fixture()
def server():
    t = SocketServerTransport()
    t.start()
    yield t
    t.close()


def _serve_background(server, stop):
    while not stop.is_set():
        if server.serve_calls() == 0:
            time.sleep(0.005)


def _serving(server):
    stop = threading.Event()
    th = threading.Thread(target=_serve_background, args=(server, stop), daemon=True)
    th.start()
    return stop, th


def test_socket_call_round_trip_and_nacks(server):
    got = {}
    server.register_handler("svc", lambda cid, p: got.update(cid=cid, x=p["x"]) or True)
    server.register_handler("no", lambda cid, p: False)
    stop, th = _serving(server)
    c = SocketClientTransport(7, port=server.port)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    try:
        assert c.call("svc", 7, {"x": x}) is True
        assert c.call("no", 7, {"a": np.zeros(3)}) is False       # the handler's NACK
        assert c.call("nope", 7, {"a": np.zeros(1)}) is False     # an unknown service
    finally:
        stop.set()
        th.join()
        c.close()
    assert got["cid"] == 7
    np.testing.assert_array_equal(got["x"], x)


def test_socket_concurrent_clients_get_their_own_acks_and_broadcasts(server):
    server.register_handler("par", lambda cid, p: cid % 2 == 0)
    stop, th = _serving(server)
    clients = [SocketClientTransport(i, port=server.port) for i in range(1, 5)]
    results = {}
    try:
        workers = [threading.Thread(target=lambda c=c: results.update(
            {c.cid: c.call("par", c.cid, {"z": np.zeros(2)})})) for c in clients]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        assert results == {1: False, 2: True, 3: False, 4: True}
        server.publish("topicA", {"v": np.asarray([1.5, 2.5], np.float32)})
        deadline = time.time() + 10
        got = {c.cid: [] for c in clients}
        while time.time() < deadline and not all(got.values()):
            for c in clients:
                got[c.cid] = got[c.cid] or c.poll("topicA", c.cid)
            time.sleep(0.01)
        assert all(len(m) == 1 and m[0]["v"].tolist() == [1.5, 2.5] for m in got.values())
    finally:
        stop.set()
        th.join()
        for c in clients:
            c.close()


def _tree_state(path: Path) -> dict:
    return {p.name: (p.stat().st_mtime_ns, hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted(path.iterdir())}


def test_shm_library_is_built_under_build_and_native_is_untouched():
    before = _tree_state(NATIVE)
    assert shm_ring.available()
    path = Path(shm_ring.lib_path())
    assert path.exists() and path.parent.parent == ROOT / "build"
    assert _tree_state(NATIVE) == before


def test_shm_ring_round_trip_and_full_ring():
    name = f"/csr_torch_rt_{os.getpid()}"
    r = shm_ring.Ring(name, 1 << 12, create=True)
    try:
        msgs = [os.urandom(n) for n in (1, 100, 0, 33)]
        for m in msgs:
            assert r.push(m)
        assert [r.pop() for _ in msgs] == msgs and r.pop() is None
        while r.push(b"x" * 1000):
            pass
        assert r.pop() == b"x" * 1000 and r.push(b"x" * 1000)
        with pytest.raises(ValueError):
            r.push(b"y" * (1 << 13))
    finally:
        r.close()


def _client_proc(session_dir, cid, out_q):
    from corbslam_tpu_torch.collab.shm_transport import ShmClientTransport

    t = ShmClientTransport(cid, session_dir, capacity=1 << 20)
    ok = t.call("echo", cid, {"x": np.arange(5, dtype=np.int32) * cid})
    msgs = []
    t0 = time.time()
    while not msgs and time.time() - t0 < 60:
        msgs = t.poll("topicA", cid)
        time.sleep(0.005)
    out_q.put((cid, ok, [np.asarray(m["y"]).tolist() for m in msgs]))
    t.close()


def test_shm_transport_call_and_broadcast_across_processes():
    from corbslam_tpu_torch.collab.shm_transport import ShmServerTransport

    srv = ShmServerTransport(tempfile.mkdtemp(prefix="csr_torch_"))
    seen = []
    srv.register_handler("echo", lambda cid, p: seen.append((cid, int(p["x"].sum()))) or True)
    q = mp.Queue()
    p = mp.Process(target=_client_proc, args=(srv.session_dir, 3, q))
    p.start()
    try:
        t0 = time.time()
        while not seen and time.time() - t0 < 60:
            srv.serve_calls()
            time.sleep(0.005)
        srv.publish("topicA", {"y": np.asarray([7, 8, 9], np.int32)})
        cid, ok, msgs = q.get(timeout=60)
    finally:
        p.join(timeout=60)
        srv.close()
        shutil.rmtree(srv.session_dir, ignore_errors=True)
    assert not p.is_alive()
    assert seen == [(3, 30)] and (cid, ok, msgs) == (3, True, [[7, 8, 9]])
