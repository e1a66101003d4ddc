"""Scaffolding of the PyTorch port: import isolation, device policy, the
port's own copies of the reference's constants, and the C interface of the
CUDA kernels as the ctypes bindings declare it.

Everything compared here is exact, except `random_texture`: the port
upsamples each noise octave as two f32 matrix products where the reference
runs jax.image.resize, so values differ by float rounding; they are held
within 5e-3 on the 0..255 scale (2e-5 relative). `PlanarWorld.render`
samples that texture along rays computed in f32 in another summation order,
and is held to the same 5e-3.
"""

import dataclasses
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import corbslam_tpu.config as jconfig
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.ops import brief as jbrief
from corbslam_tpu.ops import fast as jfast
from corbslam_tpu.ops import pyramid as jpyramid
from corbslam_tpu_torch import config, entry, interop, kernels, system
from corbslam_tpu_torch.frontend import frame, track_ops, tracking
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.loop import loop_closing
from corbslam_tpu_torch.io import synthetic
from corbslam_tpu_torch.mapstate import covisibility as covis
from corbslam_tpu_torch.mapstate import mapstate as ms
from corbslam_tpu_torch.matching import matcher
from corbslam_tpu_torch.ops import brief, fast, orb, pyramid
from corbslam_tpu_torch.optim import ba_dense, pose_graph, pose_opt
from corbslam_tpu_torch.place import vocab
from corbslam_tpu_torch.mapping import triangulation
from corbslam_tpu_torch.solvers import initializer, pnp, sim3_solver

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "corbslam_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_out_jax_and_the_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'corbslam_tpu.'))"
        " or m == 'corbslam_tpu']\n"
        "assert not bad, bad\n"
        "print(len(" + repr(MODULES) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == len(MODULES) >= 30
    for sub in ("mapstate", "matching", "optim", "mapping", "frontend.tracking",
                "mapping.local_mapping", "optim.ba_dense", "optim.smallmat", "io.trajectory",
                "geometry.sim3", "place.vocab", "place.database", "solvers.sim3_solver",
                "solvers.pnp", "optim.pose_graph", "loop.loop_closing", "frontend.reloc",
                "geometry.linalg3", "solvers.initializer", "mapping.triangulation",
                "loop.gba", "system", "collab.server", "collab.client_cache",
                "collab.fusion_ops", "collab.wire", "collab.transport", "collab.socket_transport",
                "collab.shm_ring", "collab.shm_transport", "apps.run_collab",
                "geometry.rectify", "io.stream", "io.datasets", "io.synthetic",
                "apps.train_vocab", "apps.run_client", "apps.run_stream", "apps.frame_drawer",
                "apps.render_map", "apps.live_viewer"):
        assert f"corbslam_tpu_torch.{sub}" in MODULES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_neither_jax_nor_the_reference(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|corbslam_tpu)\b", text, re.M)
    assert "import jax" not in text and not re.search(r"corbslam_tpu\.", text)


def _tiny_inputs():
    img = np.zeros((64, 96), np.float32)
    return img, camera.Intrinsics.create(100, 100, 48, 32, bf=10.0, width=96, height=64)


@pytest.mark.parametrize("call", ["extract", "stereo", "mono", "rgbd", "entry", "track_entry",
                                  "tracker_entry", "loop_entry", "sensor_entry", "e2e_entry",
                                  "client", "vocab_load", "server", "run_collab",
                                  "endurance_entry", "run_client", "train_vocab", "run_stream"])
def test_entry_points_default_to_cuda_and_raise_without_it(call):
    assert not torch.cuda.is_available()
    img, cam = _tiny_inputs()
    cfg = config.OrbConfig(n_features=64, n_levels=2)
    with pytest.raises(RuntimeError, match="cuda"):
        if call == "extract":
            orb.extract(img, cfg)
        elif call == "stereo":
            frame.build_frame_stereo(img, img, cam, cfg)
        elif call == "mono":
            frame.build_frame_mono(img, cam, cfg)
        elif call == "rgbd":
            frame.build_frame_rgbd(img, img, cam, cfg)
        elif call == "track_entry":
            entry.track_entry()
        elif call == "tracker_entry":
            entry.tracker_entry()
        elif call == "loop_entry":
            entry.loop_entry()
        elif call == "sensor_entry":
            entry.sensor_entry()
        elif call == "e2e_entry":
            entry.e2e_entry()
        elif call == "client":
            system.CorbslamClient(cam, config.SlamConfig())
        elif call == "vocab_load":
            vocab.load_default()
        elif call == "server":
            from corbslam_tpu_torch.collab.server import MapFusionServer
            from corbslam_tpu_torch.collab.transport import InProcTransport

            MapFusionServer(cam, config.SlamConfig(), None, InProcTransport())
        elif call == "run_collab":
            from corbslam_tpu_torch.apps import run_collab

            run_collab.main(["--clients", "1", "--frames", "1"])
        elif call == "endurance_entry":
            entry.endurance_entry()
        elif call == "run_client":
            from corbslam_tpu_torch.apps import run_client

            run_client.main(["--n-frames", "1"])
        elif call == "train_vocab":
            from corbslam_tpu_torch.apps import train_vocab

            train_vocab.main(["--out", "unused.npz", "--n-worlds", "1"])
        elif call == "run_stream":
            from corbslam_tpu_torch.apps import run_stream

            run_stream.main(["--role", "node", "--portfile", "unused"])
        else:
            fwd, imgs = entry.entry()
            fwd(*imgs)


def test_kernel_operands_are_checked():
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.check(torch.zeros(3), "x", torch.float32)


def test_brief_pattern_and_tables_equal_the_reference():
    np.testing.assert_array_equal(brief.BRIEF_PATTERN, jbrief.BRIEF_PATTERN)
    np.testing.assert_array_equal(brief._brief_selection(40, 16), jbrief._brief_selection(40, 16))
    np.testing.assert_array_equal(brief._orientation_weights(32), jbrief._orientation_weights(32))
    np.testing.assert_array_equal(fast.FAST_OFFSETS, jfast.FAST_OFFSETS)
    np.testing.assert_array_equal(pyramid.gaussian_kernel_1d(), jpyramid.gaussian_kernel_1d())


@pytest.mark.parametrize("n_out,n_in", [(313, 376), (1034, 1241), (105, 126), (8, 3), (40, 17)])
def test_resize_matrix_equals_the_reference(n_out, n_in):
    np.testing.assert_array_equal(pyramid._resize_matrix(n_out, n_in),
                                  jpyramid._resize_matrix(n_out, n_in))


@pytest.mark.parametrize("nf,nl,sf", [(2048, 8, 1.2), (1000, 8, 1.2), (256, 3, 1.2), (512, 4, 1.5)])
def test_config_budgets_and_level_shapes_equal_the_reference(nf, nl, sf):
    ours = config.OrbConfig(n_features=nf, n_levels=nl, scale_factor=sf)
    ref = jconfig.OrbConfig(n_features=nf, n_levels=nl, scale_factor=sf)
    assert ours.features_per_level() == ref.features_per_level()
    assert ours.scales() == ref.scales()
    for h, w in [(376, 1241), (480, 640), (120, 200)]:
        assert pyramid.level_shapes(h, w, nl, sf) == jpyramid.level_shapes(h, w, nl, sf)


def test_config_tree_equals_the_reference():
    for name in ("KITTI_STEREO", "TUM_RGBD"):
        assert (dataclasses.asdict(getattr(config, name))
                == dataclasses.asdict(getattr(jconfig, name)))


@pytest.mark.parametrize("name", ["CapacityConfig", "MatcherConfig", "TrackingConfig"])
def test_tracking_configs_equal_the_reference(name):
    ours, ref = getattr(config, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]


def test_planar_world_render_within_5e3_of_the_reference():
    kw = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240)
    ref_w = jsynthetic.PlanarWorld(jcamera.Intrinsics.create(**kw), texture_size=512,
                                   plane_dist=10.0, texture_scale=40.0, seed=3)
    ours_w = synthetic.PlanarWorld(camera.Intrinsics.create(**kw), texture_size=512,
                                   plane_dist=10.0, texture_scale=40.0, seed=3)
    T = jse3.exp(np.asarray([-0.3, 0.1, -0.2, 0.35, 0.05, 0.01], np.float32))
    ref = [np.asarray(a) for a in ref_w.render_stereo(T)]
    ours = ours_w.render_stereo(torch.from_numpy(np.array(T)))
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == (240, 320)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=5e-3)


def test_multi_plane_room_render_within_5e3_of_the_reference():
    """The loop phase's world: MultiPlaneWorld.room rendered by both packages
    on the orbit (z-buffer over six textured planes), within the 5e-3 of the
    planar world above."""
    kw = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240)
    ref_w = jsynthetic.MultiPlaneWorld.room(jcamera.Intrinsics.create(**kw), half=14.0,
                                            height=3.0, seed=2)
    ours_w = synthetic.MultiPlaneWorld.room(camera.Intrinsics.create(**kw), half=14.0, height=3.0,
                                            seed=2)
    for i in (0, 17, 40):
        T = entry.orbit_pose(i)
        ref = [np.asarray(a) for a in ref_w.render_stereo(np.asarray(T.numpy()))]
        for a, b in zip(ours_w.render_stereo(T), ref):
            assert a.dtype == torch.float32 and tuple(a.shape) == (240, 320)
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=5e-3)
    assert ours_w.depth(entry.orbit_pose(3)).min() > 0


def test_room_noise_is_seeded_per_frame_and_off_at_zero():
    """The photometric noise of MultiPlaneWorld: the same (seed, frame) gives
    the same draw, left and right differ, its std is 3 where no pixel is
    clipped, and noise_std 0 renders the noise-free pixels (held against
    the reference above)."""
    kw = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240)
    cam = camera.Intrinsics.create(**kw)
    clean = synthetic.MultiPlaneWorld.room(cam, half=14.0, height=3.0, seed=2)
    noisy = synthetic.MultiPlaneWorld.room(cam, half=14.0, height=3.0, noise_std=3.0, seed=2)
    T = entry.orbit_pose(5, 0.05, 6.0)
    l0, r0 = clean.render_stereo(T)
    l1, r1 = noisy.render_stereo(T, frame=5)
    l2, r2 = noisy.render_stereo(T, frame=5)
    assert torch.equal(l1, l2) and torch.equal(r1, r2)
    assert not torch.equal(noisy.render_stereo(T, frame=6)[0], l1)
    dl, dr = l1 - l0, r1 - r0
    assert not torch.allclose(dl, dr)
    mid = (l0 > 20) & (l0 < 235) & (r0 > 20) & (r0 < 235)
    for d in (dl, dr):
        assert abs(float(d[mid].std()) - 3.0) < 0.1 and abs(float(d[mid].mean())) < 0.1
    assert float(l1.min()) >= 0.0 and float(l1.max()) <= 255.0
    assert torch.equal(noisy.render(T, frame=5), l1)
    assert torch.equal(clean.render_stereo(T, frame=9)[0], l0)
    assert torch.equal(clean.render(T, frame=9), l0)


def test_bench_trajectory_equals_the_reference():
    """entry.gt_pose is bench.py's gt_pose (tilt 0.35 rad, 0.3 m / frame),
    within 2e-5: at a 0.002 rad yaw step se3.exp's B = (1 - cos t) / t^2
    cancels in f32, so the two packages' cos roundings move t by ~1e-5 m."""
    tilt = jse3.exp(np.asarray([0, 0, 0, 0.35, 0, 0], np.float32))
    for i in (0, 1, 7, 20):
        xi = np.asarray([-(i * 0.3), 0.0, -(i * 0.05), 0.0, i * 0.002, 0.0], np.float32)
        ref = np.asarray(jse3.compose(tilt, jse3.exp(xi)))
        np.testing.assert_allclose(entry.gt_pose(i).numpy(), ref, rtol=0, atol=2e-5)
    assert entry.center_error(entry.gt_pose(3) @ torch.linalg.inv(entry.gt_pose(0)), 3) < 1e-5


@pytest.mark.parametrize("h,w,seed", [(376, 1241, 0), (97, 131, 5)])
def test_random_texture_within_5e3_of_the_reference(h, w, seed):
    ours, ref = synthetic.random_texture(h, w, seed), jsynthetic.random_texture(h, w, seed)
    assert ours.dtype == np.float32 and ours.shape == (h, w)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=5e-3)


def test_params_from_reference_constants_equal_the_ports():
    """The port's OrbParams ("weights") built from the JAX package's own
    constants equal those built from the port's copies."""
    cfg = config.OrbConfig(n_features=512, n_levels=4)
    h, w = 200, 360
    shapes = jpyramid.level_shapes(h, w, 4, 1.2)
    sel = jbrief._brief_selection(40, 16).reshape(1600, 16, 256, 2)
    lin = sel.argmax(axis=0)                                    # [16, 256, 2]
    offs = np.stack([lin // 40 - 20, lin % 40 - 20], axis=-1)  # (dy, dx)
    ref = interop.params_from_numpy(
        cfg, (h, w), shapes=shapes,
        resize_matrices=[(jpyramid._resize_matrix(shapes[l][0], shapes[l - 1][0]),
                          jpyramid._resize_matrix(shapes[l][1], shapes[l - 1][1]))
                         for l in range(1, 4)],
        blur_taps=jpyramid.gaussian_kernel_1d(),
        orient_weights=jbrief._orientation_weights(32), brief_offsets=offs, device="cpu")
    ours = orb.params(cfg, h, w, "cpu")
    for name, a in ref._asdict().items():
        b = getattr(ours, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


def test_taps_reproduce_the_resize_matrix():
    R = pyramid._resize_matrix(105, 126)
    idx, w = interop.taps_from_matrix(R)
    x = np.random.default_rng(0).uniform(0, 255, 126).astype(np.float32)
    np.testing.assert_allclose(w[:, 0] * x[idx[:, 0]] + w[:, 1] * x[idx[:, 1]], R @ x,
                               rtol=1e-6, atol=1e-4)


def _c_entries():
    """{name: [param type, ...]} of every C_ENTRY in csrc/*.cu."""
    out = {}
    for src in sorted((PORT / "csrc").glob("*.cu")):
        for name, params in re.findall(r"C_ENTRY int (\w+)\(([^)]*)\)", src.read_text()):
            out[name] = [" ".join(p.split()[:-1]) for p in params.split(",")]
    return out


def test_ctypes_signatures_match_the_cuda_entry_points():
    import ctypes

    entries = _c_entries()
    assert set(entries) == set(kernels._SIGNATURES)
    for name, argtypes in kernels._SIGNATURES.items():
        params = entries[name]
        assert len(params) == len(argtypes), name
        for p, a in zip(params, argtypes):
            if "*" in p or p == "cudaStream_t":
                assert a is ctypes.c_void_p, (name, p)
            elif p == "float":
                assert a is ctypes.c_float, (name, p)
            else:
                assert p == "int" and a is ctypes.c_int, (name, p)


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("wrapper", ["pyramid", "fast", "describe", "stereo", "match", "pose",
                                     "local_map", "point_major", "ba_optimize", "top_covisible",
                                     "window_mask", "compact", "vocab_assign", "l1_scores",
                                     "sim3_ransac", "sim3_refine", "sim3_attempt", "pnp_ransac",
                                     "pose_graph",
                                     "covis_matrix", "finish_keypoints", "two_view", "band_search",
                                     "triangulate", "kmajority", "km_idf", "assign_flat",
                                     "transform_batch", "horn"])
def test_wrappers_refuse_devices_other_than_cpu_and_cuda(wrapper):
    """A wrapper takes its plain version only for a CPU tensor; a tensor on
    another device is refused, never silently moved."""
    from corbslam_tpu_torch.ops import stereo

    cfg = config.OrbConfig(n_features=64, n_levels=2)
    prm = orb.params(cfg, 64, 96, "cpu")
    meta = torch.empty(1, prm.total, device="meta")
    pyr = pyramid.Pyramid(meta, meta, prm.shapes, prm.offsets)
    with pytest.raises(ValueError, match="unsupported device"):
        if wrapper == "pyramid":
            pyramid.build_pyramid(torch.empty(1, 64, 96, device="meta"), prm)
        elif wrapper == "fast":
            fast.detect_pyramid(pyr, prm)
        elif wrapper == "describe":
            brief.describe(pyr, None, prm)
        elif wrapper == "match":
            d = torch.empty(8, 32, dtype=torch.uint8, device="meta")
            matcher.match_select(d, d, meta, meta, 50)
        elif wrapper == "pose":
            pose_opt.optimize_pose(None, meta, torch.empty(8, 3, device="meta"), None, None, None,
                                   None)
        elif wrapper == "local_map":
            track_ops.local_map_window(None, None, torch.empty(8, dtype=torch.int32, device="meta"),
                                       None, None, None, meta, None)
        elif wrapper == "point_major":
            ba_dense.build_point_major(torch.empty(4, 8, dtype=torch.int32, device="meta"),
                                       torch.empty(4, 8, dtype=torch.bool, device="meta"), 16, 4)
        elif wrapper == "ba_optimize":
            ba_dense.optimize(None, ba_dense.BADense(*[meta] * 9), n_iters=1)
        elif wrapper in ("top_covisible", "window_mask"):
            m = ms.empty(config.CapacityConfig(max_keyframes=4, max_map_points=16, max_features=8,
                                               local_window_kfs=2, local_window_mps=4), "meta")
            if wrapper == "top_covisible":
                covis.top_covisible_of(m, 0, 2)
            else:
                rows = torch.empty(2, dtype=torch.int32, device="meta")
                covis.local_map_mask(m, rows, rows.bool())
        elif wrapper == "compact":
            covis.compact_indices(torch.empty(16, dtype=torch.bool, device="meta"), 4)
        elif wrapper == "vocab_assign":
            voc = vocab.Vocabulary(torch.empty(8, 32, dtype=torch.uint8, device="meta"), meta)
            vocab.assign(voc, torch.empty(4, 32, dtype=torch.uint8, device="meta"))
        elif wrapper == "transform_batch":
            voc = vocab.Vocabulary(torch.empty(8, 32, dtype=torch.uint8, device="meta"), meta)
            vocab.transform_batch(voc, torch.empty(2, 4, 32, dtype=torch.uint8, device="meta"),
                                  torch.empty(2, 4, dtype=torch.bool, device="meta"))
        elif wrapper == "horn":
            p3 = torch.empty(8, 3, device="meta")
            sim3_solver.horn_sim3(p3, p3, w=torch.empty(8, device="meta"))
        elif wrapper == "l1_scores":
            vocab.l1_scores(torch.empty(8, device="meta"), torch.empty(2, 8, device="meta"))
        elif wrapper in ("sim3_ransac", "sim3_refine", "sim3_attempt", "pnp_ransac"):
            p3, v = torch.empty(8, 3, device="meta"), torch.empty(8, device="meta")
            idx = torch.empty(4, 6, dtype=torch.int32, device="meta")
            if wrapper == "sim3_ransac":
                sim3_solver.solve_sim3_ransac(None, None, p3, p3, v, v, v, idx=idx)
            elif wrapper == "sim3_attempt":
                sim3_solver.solve_and_refine_sim3(None, None, p3, p3, v, v, v, idx=idx)
            elif wrapper == "sim3_refine":
                sim3_solver.refine_sim3_iterative(None, None, p3, p3, v, v, v, None, None, None)
            else:
                pnp.solve_pnp_ransac(None, p3, p3, v, v, idx=idx)
        elif wrapper == "pose_graph":
            pose_graph.optimize(pose_graph.PoseGraph(torch.empty(4, 3, 3, device="meta"),
                                                     *[meta] * 10))
        elif wrapper == "covis_matrix":
            m = ms.empty(config.CapacityConfig(max_keyframes=4, max_map_points=16, max_features=8,
                                               local_window_kfs=2, local_window_mps=4), "meta")
            covis.covis_matrix(m)
        elif wrapper == "finish_keypoints":
            stereo.finish_keypoints(camera.Intrinsics.create(100, 100, 48, 32, bf=10.0),
                                    torch.empty(8, 2, device="meta"),
                                    torch.empty(8, dtype=torch.bool, device="meta"),
                                    torch.empty(4, 4, device="meta"), mode="rgbd")
        elif wrapper == "two_view":
            xy = torch.empty(8, 2, device="meta")
            v = torch.empty(8, dtype=torch.bool, device="meta")
            initializer.initialize_two_view(
                None, xy, xy, v, sample=torch.empty(4, 8, dtype=torch.int32, device="meta"))
        elif wrapper == "band_search":
            d = torch.empty(8, 32, dtype=torch.uint8, device="meta")
            matcher.band_search(d, meta, meta, d[None], meta, meta, meta, meta, None, meta, 50)
        elif wrapper == "triangulate":
            triangulation.points(None, None, None, None,
                                 torch.empty(2, 8, dtype=torch.int32, device="meta"), None)
        elif wrapper in ("kmajority", "assign_flat"):
            d = torch.empty(8, 32, dtype=torch.uint8, device="meta")
            if wrapper == "kmajority":
                vocab.kmajority(d, d[:4], 1)
            else:
                vocab.assign_flat(d, d[:4])
        elif wrapper == "km_idf":
            vocab.idf_of(torch.empty(8, dtype=torch.int32, device="meta"))
        else:
            f = orb.Features(*(torch.empty(64, 2, device="meta") for _ in range(7)))
            stereo.stereo_match(f, f, prm.scales, 1.0)


@pytest.mark.parametrize("src", sorted((PORT / "csrc").glob("*.cu")), ids=lambda p: p.name)
def test_cuda_sources_carry_their_header_note(src):
    head = src.read_text().split("#include")[0]
    assert "Replaces corbslam_tpu/" in head
    assert "Bound on the H100" in head and "Design" in head


@pytest.mark.parametrize("wrapper", ["pose_graph", "match", "band_search"])
def test_k11_and_k5_make_one_launch_that_fits_their_c_entry(wrapper, monkeypatch):
    """K11's `optimize` and K5's `match_select` / `band_search` make one
    launch a call, whose argument list fits its C entry's ctypes signature
    (and K11's scratch is `scratch_floats`); run here on CPU tensors with
    the launch recorded instead of made."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda counter, fn, *a: calls.append((counter, fn, a)))
    monkeypatch.setattr(kernels, "ptr", lambda t: 0)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "check", lambda *a, **k: None)
    monkeypatch.setattr(matcher, "_K5_WORK", {})
    rng = np.random.default_rng(0)
    Nq, Nt = 9, 13
    d = torch.from_numpy(rng.integers(0, 256, (Nq, 32), dtype=np.uint8))
    dt = torch.from_numpy(rng.integers(0, 256, (Nt, 32), dtype=np.uint8))
    xy, uv = torch.rand(Nq, 2) * 50, torch.rand(Nt, 2) * 50
    oq, ot = torch.zeros(Nq, dtype=torch.int32), torch.zeros(Nt, dtype=torch.int32)
    if wrapper == "pose_graph":
        N, E = 6, 10
        g = pose_graph.PoseGraph(
            torch.eye(3).repeat(N, 1, 1), torch.zeros(N, 3), torch.ones(N),
            torch.arange(N) == 0, torch.arange(E, dtype=torch.int32) % N,
            (torch.arange(E, dtype=torch.int32) + 1) % N, torch.eye(3).repeat(E, 1, 1),
            torch.zeros(E, 3), torch.ones(E), torch.ones(E, dtype=torch.bool), torch.ones(E))
        pose_graph._optimize_cuda(g, 20, 40, 1e-6)
        assert calls[0][1] == "pg_optimize" and calls[0][2][-1] == pose_graph.scratch_floats(N, E)
    elif wrapper == "match":
        win = matcher.Window(uv, xy, oq, ot, torch.ones(8), 15.0, 1, 1)
        matcher._match_select_cuda(d, dt, torch.ones(Nq, dtype=torch.bool),
                                   torch.ones(Nt, dtype=torch.bool), 50, 0.9, True, win,
                                   torch.zeros(Nq), torch.zeros(Nt))
    else:
        B = 3
        matcher._band_search_cuda(d, torch.ones(B, Nq, dtype=torch.bool), xy, dt[None].repeat(
            B, 1, 1), torch.ones(B, Nt, dtype=torch.bool), uv[None].repeat(B, 1, 1),
            ot[None].repeat(B, 1), torch.eye(3).repeat(B, 1, 1), None, torch.ones(8), 50, 1.0,
            True)
    assert len(calls) == 1
    counter, fn, args = calls[0]
    assert counter in kernels.LAUNCHES
    assert len(args) + 1 == len(kernels._SIGNATURES[fn])  # + the stream


@pytest.mark.parametrize("wrapper", ["transform_batch", "horn"])
def test_k9_batch_and_weighted_horn_launches_fit_their_c_entries(wrapper, monkeypatch):
    """K9's `transform_batch` makes two launches, `vocab_assign` over the B x
    F descriptors and `vocab_hist` of B rows, both counted as
    "vocab_batch"; the weighted Horn one `horn_weighted` launch, counted as
    "horn". Each argument list fits its C entry's ctypes signature. Run here
    on CPU tensors with the launches recorded instead of made."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda counter, fn, *a: calls.append((counter, fn, a)))
    monkeypatch.setattr(kernels, "ptr", lambda t: 0)
    monkeypatch.setattr(kernels, "check", lambda *a, **k: None)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    if wrapper == "transform_batch":
        B, F, W = 3, 7, 16
        voc = vocab.Vocabulary(torch.zeros(W, 32, dtype=torch.uint8), torch.ones(W))
        out = vocab.transform_batch(voc, torch.zeros(B, F, 32, dtype=torch.uint8),
                                    torch.ones(B, F, dtype=torch.bool))
        assert [c[:2] for c in calls] == [("vocab_batch", "vocab_assign"),
                                          ("vocab_batch", "vocab_hist")]
        assert calls[0][2][1] == B * F and calls[1][2][2:4] == (B, F) and out.shape == (B, W)
    else:
        K = 9
        R, t, s = sim3_solver.horn_sim3(torch.zeros(K, 3), torch.zeros(K, 3), True,
                                        w=torch.ones(K))
        assert [c[:2] for c in calls] == [("horn", "horn_weighted")]
        assert calls[0][2][3:5] == (K, 1) and R.shape == (3, 3) and t.shape == (3,)
    for counter, fn, args in calls:
        assert counter in kernels.LAUNCHES
        assert len(args) + 1 == len(kernels._SIGNATURES[fn])  # + the stream


@pytest.mark.parametrize("wrapper", ["kmajority", "kmajority_level2", "assign_flat",
                                     "covis_matrix"])
def test_k14_and_b17_launches_fit_their_c_entries(wrapper, monkeypatch):
    """K14 makes one `km_train` launch a call, k-majority (flat or level 2)
    and the flat assignment alike, nothing of K9's, with the scratch that
    `km_scratch_ints` lays out; B17 makes two launches, `covis_push` then
    `covis_rows`, with the same arguments (state and W). Each
    argument list fits its C entry's ctypes signature. Run here on CPU
    tensors with the launches recorded instead of made."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda counter, fn, *a: calls.append((counter, fn, a)))
    monkeypatch.setattr(kernels, "ptr", lambda t: 0)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "_WORK", {})
    monkeypatch.setattr(covis, "_COVIS_WORK", {})
    d = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (50, 32), dtype=np.uint8))
    if wrapper == "kmajority":
        vocab._kmajority_cuda(d, d[:12].clone(), 5)
        want, shape = ["km_train"], (50, 12, 0, 5, vocab.km_scratch_ints(50, 12))
    elif wrapper == "kmajority_level2":
        vocab._kmajority_cuda(d, d[:12].clone(), 3, group=torch.zeros(50, dtype=torch.int32),
                              block=4)
        want, shape = ["km_train"], (50, 12, 4, 3, vocab.km_scratch_ints(50, 12, 3))
    elif wrapper == "assign_flat":
        vocab._assign_flat_cuda(d, d[:12].clone())
        want, shape = ["km_train"], (50, 12, 0, 0, vocab.km_scratch_ints(50, 12))
        assert calls[0][2][8] is None and calls[0][2][9] == 0  # no counts; the assignment
    else:
        m = ms.empty(config.CapacityConfig(max_keyframes=6, max_map_points=40, max_features=16,
                                           local_window_kfs=2, local_window_mps=8), "cpu")
        W = covis._covis_matrix_cuda(m)
        assert W.shape == (6, 6) and covis._COVIS_WORK[(torch.device("cpu"), 0)].numel() == 82
        want = ["covis_push", "covis_rows"]
        assert calls[1][2] == calls[0][2] and calls[0][2][3:6] == (6, 16, 40)
    assert [c[1] for c in calls] == want
    for counter, fn, args in calls:
        assert counter == ("covis_matrix" if fn.startswith("covis") else "kmajority")
        assert len(args) + 1 == len(kernels._SIGNATURES[fn])  # + the stream
    if wrapper != "covis_matrix":
        args = calls[0][2]
        assert (args[3], args[4], args[5], args[6], args[11]) == shape


def test_k5_workspace_is_kept_per_stream_and_grown_filled(monkeypatch):
    """K5's column keys and batch tickets: all COL_EMPTY and 0 when made,
    kept from call to call on one stream, grown (and filled) when a call
    needs more, separate for another stream."""
    monkeypatch.setattr(matcher, "_K5_WORK", {})
    assert matcher.COL_EMPTY == 512 << 32
    cols, tick = matcher.k5_workspace("cpu", 2, 5, stream=7)
    assert cols.numel() == 10 and cols.dtype == torch.int64 and tick.numel() == 2
    assert bool((cols == matcher.COL_EMPTY).all()) and not bool(tick.any())
    again, tick2 = matcher.k5_workspace("cpu", 1, 7, stream=7)
    assert again is cols and tick2 is tick
    grown, tick3 = matcher.k5_workspace("cpu", 3, 4, stream=7)
    assert grown.numel() == 12 and tick3.numel() == 3
    assert bool((grown == matcher.COL_EMPTY).all()) and not bool(tick3.any())
    other, _ = matcher.k5_workspace("cpu", 1, 2, stream=8)
    assert other is not grown and matcher.k5_workspace("cpu", 1, 2, stream=7)[0] is grown


@pytest.mark.parametrize("wrapper", ["pyramid", "stereo"])
def test_k1_and_k4_make_one_launch_that_fits_their_c_entry(wrapper, monkeypatch):
    """K1's `build_pyramid` and K4's `stereo_match` make one launch a call
    (no PyTorch copy beside K1's), whose argument list fits its C entry's
    ctypes signature; K1 passes its cone plan's grid and buffer sizes, and
    the plan's level table is the layout of `interop.params_from_numpy`.
    Run here on CPU tensors with the launch recorded instead of made."""
    from corbslam_tpu_torch.ops import stereo

    calls = []
    monkeypatch.setattr(kernels, "launch", lambda counter, fn, *a: calls.append((counter, fn, a)))
    monkeypatch.setattr(kernels, "ptr", lambda t: 0)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "check", lambda *a, **k: None)
    monkeypatch.setattr(pyramid, "_PLANS", {})
    monkeypatch.setattr(stereo, "_K4_WORK", {})
    prm = orb.params(config.OrbConfig(n_features=64, n_levels=3), 70, 100, "cpu")
    if wrapper == "pyramid":
        copies = []
        monkeypatch.setattr(torch.Tensor, "copy_", lambda self, *a, **k: copies.append(1))
        pyramid._build_pyramid_cuda(torch.zeros(2, 70, 100), prm)
        assert not copies
        plan, nty, ntx, cap_a, cap_b, cap_t, cap_taps = pyramid.cone_plan(prm.shapes)
        assert calls[0][2][7:] == (3, 2, prm.total, 7000, nty, ntx, cap_a, cap_b, cap_t, cap_taps)
        assert plan.shape == (nty + ntx + 1, 3, 8) and (nty, ntx) == (2, 1)
        table = plan[-1, :, :5]
        assert [tuple(t[:2]) for t in table] == list(prm.shapes)
        assert tuple(table[:, 2]) == prm.offsets
        assert [tuple(t[3:]) for t in table[1:]] == list(prm.tap_offsets[1:])
    else:
        rng = np.random.default_rng(0)
        N, M = 9, 13

        def feats(n):
            return orb.Features(torch.rand(n, 2) * 50, torch.zeros(n), torch.zeros(n),
                                torch.zeros(n, dtype=torch.int32),
                                torch.from_numpy(rng.integers(0, 256, (n, 32), dtype=np.uint8)),
                                torch.ones(n, dtype=torch.bool), torch.zeros(n, 32, 32))

        m = stereo._stereo_match_cuda(feats(N), feats(M), prm.scales, 100.0, 192, 80)
        assert m.idx.shape == (N,) and calls[0][2][11:14] == (N, M, 3)
    assert len(calls) == 1
    counter, fn, args = calls[0]
    assert counter in kernels.LAUNCHES
    assert len(args) + 1 == len(kernels._SIGNATURES[fn])  # + the stream


@pytest.mark.parametrize("wrapper", ["finish_stereo", "finish_mono", "finish_rgbd",
                                     "triangulate"])
def test_finish_keypoints_and_k13_make_one_launch_that_fits_their_c_entry(wrapper, monkeypatch):
    """K4's `finish_keypoints` makes one launch in each mode, with the
    camera's terms as the C entry takes them (2 p1 and 2 p2 formed before
    they are rounded to f32) and no depth operands outside RGB-D; K13 makes
    one launch that reads the keyframe's keypoints and every pose from the
    map's tables by row (no gathered copy of them), and its five outputs are
    views of one packed buffer.
    Each argument list fits its C entry's ctypes signature. Run here on CPU
    tensors with the launch recorded instead of made."""
    from corbslam_tpu_torch.ops import stereo

    calls = []
    monkeypatch.setattr(kernels, "launch", lambda counter, fn, *a: calls.append((counter, fn, a)))
    monkeypatch.setattr(kernels, "ptr", lambda t: t.data_ptr())
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    if wrapper == "triangulate":
        cap = config.CapacityConfig(max_keyframes=6, max_map_points=40, max_features=16,
                                    local_window_kfs=2, local_window_mps=8)
        cfg = config.SlamConfig(orb=config.OrbConfig(n_features=16, n_levels=2), capacity=cap)
        m = ms.empty(cap, "cpu")
        st = triangulation.setup(CAM_, m, 1, cfg)
        nbf = triangulation.neighbours(m, st)
        match = torch.full((8, 16), -1, dtype=torch.int32)
        c = triangulation._points_cuda(CAM_, m, st, nbf, match, cfg)
        counter, fn, args = calls[0]
        assert (fn, args[0], args[1], args[4:6], args[7], args[8], args[9]) == (
            "tri_points", m.kf.xy.data_ptr(), m.kf.octave.data_ptr(), (16, 8),
            m.kf.Tcw.data_ptr(), st.nb_rows.data_ptr(), 1)
        base = args[-1]
        assert [t.data_ptr() - base for t in (c.X, c.dist1, c.k, c.f2, c.create)] == [
            0, 12 * 16, 16 * 16, 20 * 16, 24 * 16]
        assert [(t.dtype, tuple(t.shape)) for t in c] == [
            (torch.bool, (16,)), (torch.int32, (16,)), (torch.int32, (16,)),
            (torch.float32, (16, 3)), (torch.float32, (16,))]
    else:
        mode = wrapper.removeprefix("finish_")
        cam = camera.Intrinsics.create(300.0, 310.0, 160.5, 120.25, bf=40.0,
                                       dist=(0.01, -0.002, 0.1 + 2e-9, -0.3 - 2e-9, 0.001))
        N = 9
        xy, valid, dmap = torch.rand(N, 2) * 100, torch.ones(N, dtype=torch.bool), torch.rand(4, 5)
        r = stereo._finish_cuda(cam, xy, valid, dmap, mode)
        counter, fn, args = calls[0]
        assert args[3:7] == ((4, 5) if mode == "rgbd" else (0, 0)) + (N, stereo.FINISH_MODES[mode])
        assert args[7:20] == (*cam[:4], *cam.dist, 2 * cam.dist[2], 2 * cam.dist[3], 40.0, 0.05)
        assert (args[1] is None) == (args[2] is None) == (mode != "rgbd")
        assert r.xy_und.shape == (N, 2)
        assert (r.u_right is None) == (r.depth is None) == (mode == "stereo")
        assert (r.ok is None) == (args[-1] is None) == (mode != "rgbd")
        assert (args[-3] is None) == (mode == "stereo")
    assert len(calls) == 1 and counter in kernels.LAUNCHES
    assert len(args) + 1 == len(kernels._SIGNATURES[fn])  # + the stream


def test_k4_workspace_is_kept_per_stream_and_zeroed():
    """K4's ticket word: 0 when made, kept from call to call on one stream,
    separate for another stream."""
    from corbslam_tpu_torch.ops import stereo

    saved = dict(stereo._K4_WORK)
    stereo._K4_WORK.clear()
    try:
        t = stereo.k4_workspace("cpu", stream=7)
        assert t.numel() == 1 and t.dtype == torch.int32 and not bool(t.any())
        assert stereo.k4_workspace("cpu", stream=7) is t
        assert stereo.k4_workspace("cpu", stream=8) is not t
    finally:
        stereo._K4_WORK.clear()
        stereo._K4_WORK.update(saved)


CAM_ = camera.Intrinsics.create(320.0, 320.0, 160.0, 120.0, bf=160.0, width=320, height=240)


def _sim3_operands(N=8, H=4):
    rng = np.random.default_rng(0)
    return dict(p1=torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)),
                p2=torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32)),
                valid=torch.ones(N, dtype=torch.bool), s2_1=torch.ones(N), s2_2=torch.ones(N),
                idx=torch.from_numpy(rng.integers(0, N, (H, 3)).astype(np.int32)))


@pytest.mark.parametrize("bad", ["p2:on_meta", "valid:on_meta", "idx:on_meta", "p1:f64",
                                 "valid:u8", "s2_1:f16", "s2_2:f64", "idx:i64", "idx:wide"])
def test_sim3_attempt_refuses_mixed_devices_and_wrong_dtypes(bad):
    """`solve_and_refine_sim3` checks every operand against p1's device and
    its own dtype and shape before it dispatches, on any device."""
    ops = _sim3_operands()
    name, fault = bad.split(":")
    t = ops[name]
    ops[name] = {"on_meta": lambda: t.to("meta"), "f64": lambda: t.double(),
                 "u8": lambda: t.to(torch.uint8), "f16": lambda: t.half(),
                 "i64": lambda: t.long(), "wide": lambda: t.repeat(1, 2)}[fault]()
    with pytest.raises(ValueError, match="expected"):
        sim3_solver.solve_and_refine_sim3(None, None, ops["p1"], ops["p2"], ops["valid"],
                                          ops["s2_1"], ops["s2_2"], idx=ops["idx"])


def test_sim3_kernel_capacity_is_checked_when_the_loop_closer_is_set_up():
    """K10's Sim3 kernel takes at most `SIM3_MAX_N` matches (the plain
    version any number): a CUDA loop closer whose keyframes hold more
    features is refused when it is built, before it touches the device."""
    n = sim3_solver.SIM3_MAX_N
    sim3_solver.check_capacity(n, "cuda")
    sim3_solver.check_capacity(n + 1, "cpu")
    with pytest.raises(ValueError, match="at most"):
        sim3_solver.check_capacity(n + 1, "cuda")
    cfg = config.SlamConfig(capacity=config.CapacityConfig(max_features=n + 1))
    voc = vocab.Vocabulary(types.SimpleNamespace(device=torch.device("cuda")), None)
    with pytest.raises(ValueError, match="at most"):
        loop_closing.LoopCloser(CAM_, cfg, voc)


@pytest.mark.parametrize("kernel", ["kmajority", "covis_matrix"])
def test_k14_and_b17_capacities_are_checked_at_set_up(kernel):
    """K14 takes at most `vocab.KM_MAX_WORDS` centres and the covisibility
    count a map of at most `COVIS_MAX_KEYFRAMES` x `COVIS_MAX_FEATURES`
    (the plain versions any): a CUDA trainer asked for more words, or a
    CUDA loop closer whose map holds more keyframes, is refused before it
    touches the device."""
    cuda = types.SimpleNamespace(device=torch.device("cuda"))
    if kernel == "kmajority":
        n = vocab.KM_MAX_WORDS
        vocab.check_capacity(n, "cuda")
        vocab.check_capacity(n + 1, "cpu")
        with pytest.raises(ValueError, match="K14 takes at most"):
            vocab.check_capacity(n + 1, "cuda")
        with pytest.raises(ValueError, match="K14 takes at most"):
            vocab.train(cuda, n_words=n + 1)
        with pytest.raises(ValueError, match="K14 takes at most"):
            vocab.train_hierarchical(cuda, n_groups=1024, words_per_group=n // 1024 + 1)
        return
    n, f = covis.COVIS_MAX_KEYFRAMES, covis.COVIS_MAX_FEATURES
    covis.check_capacity(n, f, "cuda")
    covis.check_capacity(n + 1, f + 1, "cpu")
    for bad in ((n + 1, f), (n, f + 1)):
        with pytest.raises(ValueError, match="covisibility count takes at most"):
            covis.check_capacity(*bad, "cuda")
    cfg = config.SlamConfig(capacity=config.CapacityConfig(max_keyframes=n + 1))
    with pytest.raises(ValueError, match="covisibility count takes at most"):
        loop_closing.LoopCloser(CAM_, cfg, vocab.Vocabulary(cuda, None))


def test_b17_workspace_is_dropped_when_a_launch_fails(monkeypatch):
    """`covis_rows` clears what `covis_push` wrote to the stream's state:
    when a launch raises, the state is dropped, so the next call starts
    from a zeroed one."""
    calls = []

    def launch(counter, fn, *a):
        calls.append(fn)
        if fn == "covis_rows" and len(calls) == 2:
            raise RuntimeError("covis_rows failed: cudaError 1")

    monkeypatch.setattr(kernels, "launch", launch)
    monkeypatch.setattr(kernels, "ptr", lambda t: 0)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(covis, "_COVIS_WORK", {})
    m = ms.empty(config.CapacityConfig(max_keyframes=6, max_map_points=40, max_features=16,
                                       local_window_kfs=2, local_window_mps=8), "cpu")
    key = (torch.device("cpu"), 0)
    with pytest.raises(RuntimeError, match="covis_rows failed"):
        covis._covis_matrix_cuda(m)
    assert key not in covis._COVIS_WORK
    covis._covis_matrix_cuda(m)
    assert calls == ["covis_push", "covis_rows"] * 2
    kept = covis._COVIS_WORK[key]
    assert kept.numel() == 82 and not bool(kept.any())
    covis._covis_matrix_cuda(m)
    assert covis._COVIS_WORK[key] is kept


@pytest.mark.parametrize("mode", ["ransac", "refine", "attempt", "describe", "pnp", "two_view"])
def test_k10_sim3_and_k3_make_one_launch_that_fits_their_c_entry(mode, monkeypatch):
    """K10's Sim3 RANSAC, refinement and whole attempt are one launch of
    `sim3_attempt` in modes 1, 2 and 3 (the attempt's grid covers ceil(H / 2)
    hypotheses, its outputs are views of one model buffer), K3's
    `describe` one launch of `orb_describe`, K10's PnP RANSAC one launch of
    `pnp_ransac` and K12's two-view attempt one launch of `two_view` (each
    with its kernel's `kernels.STAMPED_WORDS` workspace words), each argument list fitting its
    C entry's ctypes signature; run here on CPU tensors with the launch
    recorded instead of made."""
    calls = []
    monkeypatch.setattr(kernels, "launch", lambda counter, fn, *a: calls.append((counter, fn, a)))
    monkeypatch.setattr(kernels, "ptr", lambda t: 0)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    monkeypatch.setattr(kernels, "check", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_WORK", {})
    ops = _sim3_operands(N=8, H=5)
    m = (ops["p1"], ops["p2"], ops["valid"], ops["s2_1"], ops["s2_2"])
    if mode in ("pnp", "two_view"):
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        k = 6 if mode == "pnp" else 8
        idx = torch.from_numpy(np.random.default_rng(1).integers(0, 8, (5, k)).astype(np.int32))
        if mode == "pnp":
            r = pnp.solve_pnp_ransac(CAM_, ops["p1"], ops["p1"][:, :2].contiguous(), ops["valid"],
                                     ops["s2_1"], idx=idx)
            assert calls[0][1] == "pnp_ransac" and calls[0][2][4:7] == (8, 0, 5)
            assert r.Tcw.shape == (4, 4) and r.inliers.shape == (8,) and r.n_inliers.dim() == 0
        else:
            r = initializer.initialize_two_view(CAM_, ops["p1"][:, :2].contiguous(),
                                                ops["p2"][:, :2].contiguous(), ops["valid"],
                                                sample=idx)
            assert calls[0][1] == "two_view" and calls[0][2][3:6] == (8, 0, 5)
            assert r.X.shape == (8, 3) and r.good.shape == (8,) and r.R.shape == (3, 3)
        work = kernels._WORK[(mode, torch.device("cpu"), 0)]
        assert work.numel() == kernels.STAMPED_WORDS and not bool(work.any())
    elif mode == "describe":
        prm = orb.params(config.OrbConfig(n_features=64, n_levels=2), 64, 96, "cpu")
        meta = torch.zeros(2, prm.total)
        i32 = [torch.zeros(2, 64, dtype=torch.int32) for _ in range(4)]
        kp = fast.Keypoints(torch.zeros(2, 64, 2), torch.zeros(2, 64),
                            torch.zeros(2, 64, dtype=torch.bool), *i32)
        brief._describe_cuda(pyramid.Pyramid(meta, meta, prm.shapes, prm.offsets), kp, prm)
        assert calls[0][1] == "orb_describe"
    elif mode == "ransac":
        r = sim3_solver._sim3_cuda(sim3_solver.SIM3_RANSAC, CAM_, CAM_, *m, idx=ops["idx"])[0]
        assert calls[0][2][6:8] == (0, 5) and calls[0][2][11] == 1
        assert r.R.shape == (3, 3) and r.inliers.shape == (8,) and r.n_inliers.dim() == 0
    elif mode == "refine":
        R0, t0, s0 = torch.eye(3), torch.zeros(3), torch.ones(())
        f = sim3_solver._sim3_cuda(sim3_solver.SIM3_REFINE, CAM_, CAM_, *m, R0=R0, t0=t0,
                                   s0=s0)[1]
        assert calls[0][2][7] == 0 and calls[0][2][11] == 2 and f[0].shape == (3, 3)
    else:
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
        a = sim3_solver.solve_and_refine_sim3(CAM_, CAM_, *m, idx=ops["idx"])
        assert calls[0][2][11] == 3 and a.R.shape == (3, 3) and a.refined[3].shape == (8,)
        assert a.R.data_ptr() == a.ransac.R.data_ptr() + 26 * 4
    assert len(calls) == 1
    counter, fn, args = calls[0]
    assert counter in kernels.LAUNCHES
    assert len(args) + 1 == len(kernels._SIGNATURES[fn])  # + the stream


def test_k10_sim3_workspace_is_kept_per_stream_and_zeroed():
    """K10's Sim3 words (best key, ticket; `kernels.workspace`): 0 when
    made, kept from call to call on one stream, separate for another
    stream."""
    saved = dict(kernels._WORK)
    kernels._WORK.clear()
    try:
        w = kernels.workspace("sim3", "cpu", stream=7)
        assert w.numel() == 2 and w.dtype == torch.int64 and not bool(w.any())
        assert kernels.workspace("sim3", "cpu", stream=7) is w
        assert kernels.workspace("sim3", "cpu", stream=8) is not w
    finally:
        kernels._WORK.clear()
        kernels._WORK.update(saved)


@pytest.mark.parametrize("name", ["pnp", "two_view"])
def test_k10_pnp_and_k12_workspaces_are_their_own_per_stream_and_zeroed(name):
    """K10's PnP words and K12's (best keys, ticket, and the stamp words of
    a build with -DKERNEL_STAMPS): zeros when made, kept from call to call
    on one stream, apart from another stream's and from the other kernels'."""
    saved = dict(kernels._WORK)
    kernels._WORK.clear()
    try:
        n = kernels.STAMPED_WORDS
        w = kernels.workspace(name, "cpu", stream=7, words=n)
        assert w.numel() == n and w.dtype == torch.int64 and not bool(w.any())
        assert kernels.workspace(name, "cpu", stream=7, words=n) is w
        assert kernels.workspace(name, "cpu", stream=8, words=n) is not w
        assert kernels.workspace("sim3", "cpu", stream=7) is not w
    finally:
        kernels._WORK.clear()
        kernels._WORK.update(saved)


@pytest.mark.parametrize("kernel", ["pnp", "two_view"])
def test_pnp_and_two_view_kernel_capacity_is_checked_when_the_tracker_is_set_up(kernel,
                                                                                monkeypatch):
    """K10's PnP kernel takes at most `pnp.PNP_MAX_N` matches and K12 at most
    `initializer.TV_MAX_N` (the plain versions any number): a CUDA tracker
    whose frames hold more features is refused when it is built, before it
    touches the device."""
    mod, n, msg = ((pnp, pnp.PNP_MAX_N, "PnP kernel takes at most") if kernel == "pnp" else
                   (initializer, initializer.TV_MAX_N, "K12 takes at most"))
    mod.check_capacity(n, "cuda")
    mod.check_capacity(n + 1, "cpu")
    with pytest.raises(ValueError, match=msg):
        mod.check_capacity(n + 1, "cuda")
    monkeypatch.setattr(kernels, "resolve_device", lambda d: torch.device(d))
    cfg = config.SlamConfig(orb=config.OrbConfig(n_features=n + 1))
    with pytest.raises(ValueError, match=msg):
        tracking.StereoTracker(CAM_, cfg, device="cuda")
    tracking.StereoTracker(CAM_, config.SlamConfig(orb=config.OrbConfig(n_features=n + 1)),
                           device="cpu")
