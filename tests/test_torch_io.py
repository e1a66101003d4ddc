"""The port's `geometry/rectify.py`, `io/stream.py`, `io/datasets.py` and
`place/database.count_mutual_matches` against the JAX package on the CPU.

rectify and datasets are copies of JAX-free modules (over the port's config
and camera): their results must equal the reference's exactly on the cases
of tests/test_rectify.py and tests/test_system.py's loaders. The stream
keeps the reference's wire format (its frames' bytes are compared) with a
deadline on every socket wait; loopback sockets get short deadlines here.
`count_mutual_matches` runs on K5's mutual best match and must count what
the reference counts (exact: integer distances).
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.geometry import rectify as jrectify
from corbslam_tpu.io import datasets as jdatasets
from corbslam_tpu.io import stream as jstream
from corbslam_tpu.place import database as jdatabase
from corbslam_tpu_torch.geometry import camera, rectify
from corbslam_tpu_torch.io import datasets, stream
from corbslam_tpu_torch.place import database

torch.set_num_threads(2)


def test_rectify_equals_the_reference():
    rng = np.random.default_rng(0)
    uv = rng.uniform([100, 100], [650, 380], size=(256, 2))
    args = (rectify.EUROC_LEFT_K, rectify.EUROC_LEFT_D, rectify.EUROC_LEFT_R, rectify.EUROC_P)
    np.testing.assert_array_equal(rectify.rectified_to_raw(*args, uv),
                                  jrectify.rectified_to_raw(*args, uv))
    for a, b in zip(rectify.euroc_rectify_maps(), jrectify.euroc_rectify_maps()):
        np.testing.assert_array_equal(a.map_x, b.map_x)
        np.testing.assert_array_equal(a.map_y, b.map_y)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    v, u = np.mgrid[0:48, 0:64].astype(np.float32)
    for du, dv, im in ((0.0, 0.0, img), (2.0, 3.0, img), (0.37, -1.6, img.astype(np.uint8))):
        out = rectify.RectifyMap(u + du, v + dv).remap(im)
        ref = jrectify.RectifyMap(u + du, v + dv).remap(im)
        assert out.dtype == ref.dtype and np.array_equal(out, ref)


@pytest.mark.parametrize("freiburg", [1, 2, 3])
def test_dataset_cameras_equal_the_references(freiburg):
    assert tuple(datasets.tum_camera(freiburg)) == tuple(jdatasets.tum_camera(freiburg))
    assert tuple(datasets.kitti_camera(freiburg + 1)) == tuple(jdatasets.kitti_camera(freiburg + 1))
    assert tuple(datasets.euroc_camera()) == tuple(jdatasets.euroc_camera())
    assert isinstance(datasets.tum_camera(freiburg), camera.Intrinsics)


def _write_pgm(path, arr):
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
        f.write(arr.astype(np.uint8).tobytes())


def _same_frames(a, b):
    assert len(a) == len(b) > 0
    for fa, fb in zip(a, b):
        assert fa.timestamp == fb.timestamp
        for x, y in zip(fa.load(), fb.load()):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_loaders_read_the_references_layouts(tmp_path):
    """tests/test_system.py's KITTI, TUM and EuRoC layouts, read by both."""
    rng = np.random.default_rng(0)
    sdir = tmp_path / "kitti" / "sequences" / "03"
    (sdir / "image_0").mkdir(parents=True)
    (sdir / "image_1").mkdir()
    for i in range(3):
        _write_pgm(sdir / "image_0" / f"{i:06d}.pgm", rng.integers(0, 255, (8, 12)))
        _write_pgm(sdir / "image_1" / f"{i:06d}.pgm", rng.integers(0, 255, (8, 12)))
    np.savetxt(sdir / "times.txt", np.arange(3) * 0.1)
    root = str(tmp_path / "kitti")
    _same_frames(datasets.load_kitti_stereo(root, 3), jdatasets.load_kitti_stereo(root, 3))
    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    rgb_lines, d_lines = ["# comment"], []
    for i in range(3):
        t = 100.0 + i * 0.05
        _write_pgm(tum / "rgb" / f"{t:.4f}.pgm", rng.integers(0, 255, (6, 6)))
        _write_pgm(tum / "depth" / f"{t + 0.008:.4f}.pgm", rng.integers(0, 255, (6, 6)))
        rgb_lines.append(f"{t:.4f} rgb/{t:.4f}.pgm")
        d_lines.append(f"{t + 0.008:.4f} depth/{t + 0.008:.4f}.pgm")
    (tum / "rgb.txt").write_text("\n".join(rgb_lines))
    (tum / "depth.txt").write_text("\n".join(d_lines))
    _same_frames(datasets.load_tum_rgbd(str(tum)), jdatasets.load_tum_rgbd(str(tum)))
    eu = tmp_path / "euroc"
    for c in ("cam0", "cam1"):
        (eu / "mav0" / c / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    for i in range(2):
        ns = 1403636579763555584 + i * 50_000_000
        for c in ("cam0", "cam1"):
            _write_pgm(eu / "mav0" / c / "data" / f"{ns}.pgm", rng.integers(0, 255, (6, 6)))
        rows.append(f"{ns},{ns}.pgm")
    (eu / "mav0" / "cam0" / "data.csv").write_text("\n".join(rows))
    _same_frames(datasets.load_euroc_stereo(str(eu)), jdatasets.load_euroc_stereo(str(eu)))
    assert datasets.config_for("tum") == datasets.TUM_RGBD


def _wait(cond, deadline=5.0):
    t0 = time.time()
    while not cond() and time.time() - t0 < deadline:
        time.sleep(0.01)
    return cond()


def test_stream_frames_round_trip_in_the_references_wire_format():
    img = np.random.default_rng(1).integers(0, 255, (24, 32), dtype=np.uint8)
    dep = np.linspace(0, 1, 24 * 32, dtype=np.float32).reshape(24, 32)
    for topic, ts, im in (("left", 1.0, img), ("depth", 2.5, dep)):
        assert stream._pack_frame(topic, ts, im) == jstream._pack_frame(topic, ts, im)
    srv = stream.ImageStreamServer()
    sub = stream.ImageStreamClient(port=srv.port, connect_timeout=5.0, idle_timeout=5.0)
    try:
        srv.wait_subscriber(timeout=5)
        for i in range(3):
            srv.publish("left", 1.0 + i, img + i)
        srv.publish("depth", 2.5, dep)
        for i in range(10):  # a bounded queue keeps the newest (queue_size 16)
            srv.publish("right", float(i), np.full((8, 8), i, np.uint8))
        srv.end()
        assert _wait(lambda: sub.ended)
        got = sub.pop_all("left")
        assert [ts for ts, _ in got] == [1.0, 2.0, 3.0]
        assert all(np.array_equal(im, img + i) for i, (_, im) in enumerate(got))
        (ts, d), = sub.pop_all("depth")
        assert ts == 2.5 and d.dtype == np.float32 and np.array_equal(d, dep)
        assert [ts for ts, _ in sub.pop_all("right")] == [float(i) for i in range(10)]
    finally:
        sub.close()
        srv.close()
    small = stream.ImageStreamServer()
    sub = stream.ImageStreamClient(port=small.port, queue_size=4, idle_timeout=5.0)
    try:
        small.wait_subscriber(timeout=5)
        for i in range(10):
            small.publish("left", float(i), np.full((8, 8), i, np.uint8))
        small.end()
        assert _wait(lambda: sub.ended)
        got = sub.pop_all("left")
        assert len(got) <= 4 and got[-1][0] == 9.0
    finally:
        sub.close()
        small.close()


def test_stream_waits_end_at_their_deadlines():
    srv = stream.ImageStreamServer()
    t0 = time.time()
    with pytest.raises(OSError):  # socket.timeout: no subscriber
        srv.wait_subscriber(timeout=0.2)
    assert time.time() - t0 < 2.0
    sub = stream.ImageStreamClient(port=srv.port, idle_timeout=0.3)
    srv.wait_subscriber(timeout=5)
    assert _wait(lambda: sub.ended, 3.0)  # the publisher went quiet
    sub.close()
    srv.close()
    srv = stream.ImageStreamServer()
    sub = stream.ImageStreamClient(port=srv.port, idle_timeout=60.0)
    srv.wait_subscriber(timeout=5)
    t0 = time.time()
    sub.close()  # ends the reader between polls
    assert not sub._thread.is_alive() and time.time() - t0 < 2.0
    srv.close()


@pytest.mark.parametrize("case", ["pairs", "drops_unmatched", "stale_after_emit"])
def test_approx_sync_equals_the_reference(case):
    pushes = dict(pairs=[("a", 1.00, "a0"), ("b", 1.01, "b0"), ("a", 1.10, "a1"),
                         ("b", 1.11, "b1")],
                  drops_unmatched=[("a", 1.00, "a0"), ("b", 1.50, "b0"), ("a", 1.505, "a1")],
                  stale_after_emit=[("a", 2.0, "a0"), ("b", 2.0, "b0"), ("pop",),
                                    ("a", 1.0, "old"), ("b", 1.0, "old")])[case]
    outs = []
    for mod in (stream, jstream):
        s, out = mod.ApproxSync(slop=0.02), []
        for p in pushes:
            if p[0] == "pop":
                out.append(s.pop_pairs())
            else:
                getattr(s, f"push_{p[0]}")(p[1], p[2])
        out.append(s.pop_pairs())
        outs.append(out)
    assert outs[0] == outs[1] and any(outs[0])


@pytest.mark.parametrize("mask", ["some", "query_masked", "candidates_masked", "near_copies"])
def test_count_mutual_matches_equals_the_references(mask):
    rng = np.random.default_rng(11)
    F = 160
    q = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    c = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    c[:80] = q[rng.permutation(F)[:80]]  # 80 exact copies, shuffled
    flip = rng.random((80, 32)) < (0.08 if mask == "near_copies" else 0.02)
    c[:80] ^= (flip * rng.integers(1, 256, (80, 32))).astype(np.uint8)
    c[80:90] = c[0]  # duplicate candidates: ties and failed ratio tests
    qv, cv = rng.random(F) < 0.9, rng.random(F) < 0.85
    if mask == "query_masked":
        qv[:] = False
    elif mask == "candidates_masked":
        cv[:] = False
    ref = int(jdatabase.count_mutual_matches(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(c),
                                             jnp.asarray(cv)))
    out = database.count_mutual_matches(torch.from_numpy(q), torch.from_numpy(qv),
                                        torch.from_numpy(c), torch.from_numpy(cv))
    assert out.dtype == torch.int32 and int(out) == ref
    assert (ref > 20) == (mask in ("some", "near_copies"))
