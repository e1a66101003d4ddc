"""The port's host apps on the CPU: `frame_drawer`, `render_map` and
`live_viewer` over the port's tensors (modelled on tests/test_viz.py, with a
stub tracker holding torch tensors), `train_vocab` on tiny synthetic worlds
(its artifact read back equal by the port's and the reference's `load`),
and `run_stream`'s publisher and node on loopback.
"""

import json
import threading
import time
import types
import urllib.request
import zlib

import numpy as np
import pytest
import torch

from corbslam_tpu.place import vocab as JV
from corbslam_tpu_torch.apps import frame_drawer, live_viewer, render_map, run_stream, train_vocab
from corbslam_tpu_torch.config import CapacityConfig
from corbslam_tpu_torch.frontend.tracking import TrackState
from corbslam_tpu_torch.mapstate import mapstate as ms
from corbslam_tpu_torch.place import vocab

torch.set_num_threads(2)


def stub_tracker(n=32, h=120, w=160, state=TrackState.OK):
    f = types.SimpleNamespace(
        xy=torch.stack([torch.linspace(5, w - 5, n), torch.linspace(5, h - 5, n)], 1),
        fvalid=torch.ones(n, dtype=torch.bool),
        mp_idx=torch.where(torch.arange(n) % 2 == 0, torch.arange(n), -1).to(torch.int32),
        octave=torch.zeros(n, dtype=torch.int32))
    return types.SimpleNamespace(
        last_frame=f, _state=state, stats=types.SimpleNamespace(n_keyframes=3),
        map=types.SimpleNamespace(mp=types.SimpleNamespace(valid=torch.ones(64, dtype=torch.bool))),
        flush=lambda: None)


def small_map():
    m = ms.empty(CapacityConfig(max_keyframes=8, max_map_points=64, max_features=8,
                                local_window_kfs=4, local_window_mps=16))
    m, _ = ms.insert_keyframe(m, torch.eye(4), torch.zeros(8, 2), torch.zeros(8, dtype=torch.int32),
                              torch.zeros(8), torch.zeros(8, 32, dtype=torch.uint8),
                              torch.full((8,), -1.0), torch.zeros(8),
                              torch.ones(8, dtype=torch.bool),
                              torch.full((8,), -1, dtype=torch.int32), frame_id=0, timestamp=0.0)
    m.mp.pos[:10] = torch.randn(10, 3, generator=torch.Generator().manual_seed(0))
    m.mp.valid[:10] = True
    return m


@pytest.mark.parametrize("state", ["OK", "LOST"])
def test_frame_drawer_annotates_the_ports_tensors(state, tmp_path):
    t = stub_tracker(state=TrackState[state])
    rgb = frame_drawer.FrameDrawer().draw(torch.full((120, 160), 128.0), t)
    assert rgb.shape == (120, 160, 3) and rgb.dtype == np.uint8
    green = (rgb[:, :, 1] > 200) & (rgb[:, :, 0] < 100)
    blue = (rgb[:, :, 2] > 200) & (rgb[:, :, 1] < 160)
    red = (rgb[:, :, 0] > 200) & (rgb[:, :, 1] < 100)
    assert green.sum() > 50 and blue.sum() > 20 and rgb[-1].mean() < 64
    assert (red.sum() > 10) == (state == "LOST")
    raw = open(frame_drawer.save_png(rgb, str(tmp_path / "f.png")), "rb").read()
    i = raw.index(b"IDAT")
    pix = zlib.decompress(raw[i + 4:i + 4 + int.from_bytes(raw[i - 4:i], "big")])
    dec = np.frombuffer(b"".join(pix[r * 481 + 1:(r + 1) * 481] for r in range(120)), np.uint8)
    assert np.array_equal(dec.reshape(120, 160, 3), rgb)


def test_render_map_and_live_viewer_serve_the_ports_map(tmp_path):
    out = render_map.render_mapstate(small_map(), str(tmp_path / "map.png"))
    assert open(out, "rb").read()[:8] == b"\x89PNG\r\n\x1a\n"
    viewer = live_viewer.LiveViewer(port=0, map_render_hz=100.0)
    try:
        viewer.publish_frame(torch.full((120, 160), 100.0), stub_tracker())
        viewer.publish_stats({"frame": 7, "state": "OK"})
        viewer.publish_map(small_map())

        def get(path):
            with urllib.request.urlopen(viewer.url + path, timeout=10) as r:
                return r.read()

        assert b"corbslam_tpu_torch live" in get("")
        assert get("frame.png")[:8] == b"\x89PNG\r\n\x1a\n"
        assert json.loads(get("stats.json"))["frame"] == 7
        for _ in range(100):
            mp = get("map.png")
            if len(mp) > 1000:
                break
            time.sleep(0.1)
        assert mp[:8] == b"\x89PNG\r\n\x1a\n" and len(mp) > 1000
    finally:
        viewer.close()


def test_train_vocab_saves_an_artifact_both_packages_read(tmp_path):
    """Three tiny worlds (planar, room, SceneWorld), one view each, 64 words
    as 2 groups x 32 through `train_hierarchical`."""
    path = str(tmp_path / "voc.npz")
    voc = train_vocab.main(["--out", path, "--n-words", "64", "--n-iters", "2", "--n-worlds", "3",
                            "--frames-per-world", "1", "--device", "cpu"])
    assert voc.n_words == 64 and voc.groups.shape[0] == 2
    back = vocab.load(path, "cpu")
    for f in ("words", "idf", "groups", "child_idx"):
        assert torch.equal(getattr(back, f), getattr(voc, f)), f
    ref = JV.load(path)
    from corbslam_tpu_torch.ops.descriptors import unpack_bits

    np.testing.assert_array_equal(np.asarray(ref.word_bits), unpack_bits(voc.words).numpy())
    np.testing.assert_array_equal(np.asarray(ref.idf), voc.idf.numpy())


def test_run_stream_node_tracks_what_the_publisher_streams(tmp_path):
    args = types.SimpleNamespace(portfile=str(tmp_path / "port"), fps=20.0, frames=4, out="",
                                 device="cpu", idle_timeout=10.0)
    pub = threading.Thread(target=run_stream.run_publisher, args=(args,), daemon=True)
    pub.start()
    out = run_stream.run_node(args)
    pub.join(30)
    assert not pub.is_alive()
    assert out["frames_streamed"] == 4 and out["frames_tracked"] >= 1
    assert out["states"] == {"OK": out["frames_tracked"]}
