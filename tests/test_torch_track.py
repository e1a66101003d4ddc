"""Parity of the port's stereo tracking step (`frontend/track_ops.py`, all
kernels on their plain versions) with the JAX reference at the small size
of tests/test_pipeline.py (320x240, 512 features, 4 levels, capacities
64 / 8192 / 512, windows 8 / 2048) on its PlanarWorld.

Both packages start from the same JAX-built keyframe and map, carried across
by `interop`, and each frame's features come from the JAX front end, so the
comparison isolates `_track_core`. The port chains its own state (map,
last frame, velocity, local window, reference keyframe) across 3 frames.

Tolerances and why: the pose LM is not bit-exact (see
tests/test_torch_pose_opt.py), so poses agree within 1e-4 m and 1e-5 rad
per frame, summary counts within 1 %, the features' map-point matches on
>= 99 % of features and the visible / found counters on >= 99.9 % of rows;
the local window (rows and flags), integer selections made before any pose
differs, is exact. Keyframe insertion copies and backprojects: exact, with
positions, normals and distances within 1e-5 (relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu import config as jconfig
from corbslam_tpu.frontend import frame as jframe
from corbslam_tpu.frontend import track_ops as jtrack
from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu_torch import config, interop
from corbslam_tpu_torch.frontend import track_ops
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.mapstate import mapstate as ms

torch.set_num_threads(2)

KW = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5, width=320, height=240)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)


def _cfg(C):
    return C.SlamConfig(
        orb=C.OrbConfig(n_features=512, n_levels=4, cell_size=12),
        tracking=C.TrackingConfig(th_depth=40.0, max_frames_between_kf=10),
        mapping=C.MappingConfig(local_ba_window=8, local_ba_iters=6),
        capacity=C.CapacityConfig(max_keyframes=64, max_map_points=8192, max_features=512,
                                  local_window_kfs=8, local_window_mps=2048),
    )


JCFG, CFG = _cfg(jconfig), _cfg(config)
K1 = CFG.capacity.local_window_kfs


def _gt(i):
    tilt = jse3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    return jse3.compose(tilt, jse3.exp(jnp.asarray([-(i * 0.12), 0.0, -(i * 0.03), 0.0,
                                                    i * 0.004, 0.0], jnp.float32)))


@pytest.fixture(scope="module")
def frames():
    """Stereo pairs 0..3 and their JAX-built frames."""
    world = jsynthetic.PlanarWorld(JCAM, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
    render = jax.jit(world.render_stereo)
    build = jax.jit(jframe.build_frame_stereo, static_argnames=("cam", "cfg"))
    imgs = [tuple(np.asarray(a) for a in render(_gt(i))) for i in range(4)]
    return imgs, [build(*im, JCAM, JCFG.orb) for im in imgs]


@pytest.fixture(scope="module")
def seeded(frames):
    """Frame 0 as the first keyframe at Tcw = I, in both packages."""
    f0 = frames[1][0]._replace(Tcw=jnp.eye(4))
    jm, jrow, jidx = jtrack.insert_keyframe_with_points(JCAM, jms.empty(JCFG.capacity), f0, 0, 0.0,
                                                        JCFG)
    pm, prow, pidx = track_ops.insert_keyframe_with_points(
        CAM, ms.empty(CFG.capacity), interop.frame_from_numpy(f0), 0, 0.0, CFG)
    return (jm, f0._replace(mp_idx=jidx), int(jrow)), (pm, prow, pidx)


def test_insert_keyframe_with_points_equals_the_reference(seeded):
    (jm, jprev, jrow), (pm, prow, pidx) = seeded
    assert int(prow) == jrow == 0
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(jprev.mp_idx))
    got = interop.map_to_numpy(pm)
    assert got["n_mp"] == int(jm.n_mp) > 200 and got["n_kf"] == 1
    for part in ("kf", "mp"):
        for name, a in got[part].items():
            ref = np.asarray(getattr(getattr(jm, part), name))
            if a.dtype == np.float32 and part == "mp":
                np.testing.assert_allclose(a, ref, rtol=1e-5, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(a, ref, err_msg=f"{part}.{name}")


def _j_state(jm, prev, ref_kf):
    return dict(m=jm, prev=prev, velocity=jnp.eye(4), ref_kf=jnp.int32(ref_kf),
                local_rows=jnp.zeros(K1, jnp.int32), local_ok=jnp.zeros(K1, bool))


def _p_state(jm, prev, ref_kf):
    return dict(m=interop.map_from_numpy(jm), prev=interop.frame_from_numpy(prev),
                velocity=torch.eye(4), ref_kf=torch.tensor(ref_kf, dtype=torch.int32),
                local_rows=torch.zeros(K1, dtype=torch.int32),
                local_ok=torch.zeros(K1, dtype=torch.bool))


_core = jax.jit(jtrack._track_core, static_argnames=("cam", "cfg"))


def _step(state, cur_j, which):
    if which == "jax":
        o = _core(JCAM, state["m"], cur_j, state["prev"], state["velocity"], state["ref_kf"],
                  state["local_rows"], state["local_ok"], JCFG)
    else:
        o = track_ops._track_core(CAM, state["m"], interop.frame_from_numpy(cur_j), state["prev"],
                                  state["velocity"], state["ref_kf"], state["local_rows"],
                                  state["local_ok"], CFG)
    return o, dict(m=o.map, prev=o.cur, velocity=o.velocity, ref_kf=o.ref_kf,
                   local_rows=o.local_rows, local_ok=o.local_ok)


def _compare(o_j, o_p):
    s_j, s_p = np.asarray(o_j.summary), o_p.summary.numpy()
    for k, name in enumerate(("n_track", "used_ref", "n_local", "ref_kf", "n_close_tracked",
                              "n_close_spawn", "ok")):
        assert abs(s_p[k] - s_j[k]) <= 0.01 * abs(s_j[k]), (name, s_p[k], s_j[k])
    Tj, Tp = s_j[8:].reshape(4, 4), s_p[8:].reshape(4, 4)
    assert np.abs(Tp[:3, 3] - Tj[:3, 3]).max() <= 1e-4
    assert np.abs(Tp[:3, :3] @ Tj[:3, :3].T - np.eye(3)).max() <= 1e-5
    np.testing.assert_array_equal(o_p.local_rows.numpy(), np.asarray(o_j.local_rows))
    np.testing.assert_array_equal(o_p.local_ok.numpy(), np.asarray(o_j.local_ok))
    assert int(o_p.ref_kf) == int(o_j.ref_kf)
    assert (o_p.cur.mp_idx.numpy() == np.asarray(o_j.cur.mp_idx)).mean() >= 0.99
    for f in ("n_visible", "n_found"):
        assert (getattr(o_p.map.mp, f).numpy() == np.asarray(getattr(o_j.map.mp, f))).mean() \
            >= 0.999, f
    return s_j


def test_track_core_three_chained_frames(frames, seeded):
    (jm, jprev, jrow), _ = seeded
    sj, sp = _j_state(jm, jprev, jrow), _p_state(jm, jprev, jrow)
    for i in (1, 2, 3):
        o_j, sj = _step(sj, frames[1][i], "jax")
        o_p, sp = _step(sp, frames[1][i], "port")
        s = _compare(o_j, o_p)
        assert s[6] == 1 and s[1] == 0 and s[2] > 250, s[:8]


def test_forced_reference_keyframe_fallback(frames, seeded):
    """A bogus velocity sends the motion-model match off the frame, so both
    packages fall back to the descriptor match against the reference
    keyframe (used_ref = 1) and still track."""
    (jm, jprev, jrow), _ = seeded
    bogus = np.asarray(jse3.exp(jnp.asarray([3.0, -2.0, 1.0, 0.4, -0.3, 0.2], jnp.float32)))
    sj, sp = _j_state(jm, jprev, jrow), _p_state(jm, jprev, jrow)
    sj["velocity"], sp["velocity"] = jnp.asarray(bogus), torch.from_numpy(bogus.copy())
    o_j, _ = _step(sj, frames[1][1], "jax")
    o_p, _ = _step(sp, frames[1][1], "port")
    s = _compare(o_j, o_p)
    assert s[1] == 1 and s[6] == 1, s[:8]


def test_track_frame_stereo2_equals_two_single_steps(frames, seeded):
    """The chained two-frame step is two single steps: same summaries, map
    and state (the port's own front end on the CPU)."""
    (jm, jprev, jrow), _ = seeded
    imgs = frames[0]
    a, b = _p_state(jm, jprev, jrow), _p_state(jm, jprev, jrow)
    o0, o1 = track_ops.track_frame_stereo2(
        a["m"], a["prev"], a["velocity"], *imgs[1], *imgs[2], a["ref_kf"], a["local_rows"],
        a["local_ok"], CAM, CFG, device="cpu")
    s = b
    outs = []
    for i in (1, 2):
        o = track_ops.track_frame_stereo(s["m"], s["prev"], s["velocity"], *imgs[i], s["ref_kf"],
                                         s["local_rows"], s["local_ok"], CAM, CFG, device="cpu")
        s = dict(m=o.map, prev=o.cur, velocity=o.velocity, ref_kf=o.ref_kf,
                 local_rows=o.local_rows, local_ok=o.local_ok)
        outs.append(o)
    for x, y in zip((o0, o1), outs):
        assert torch.equal(x.summary, y.summary)
        assert torch.equal(x.local_rows, y.local_rows) and torch.equal(x.velocity, y.velocity)
        assert torch.equal(x.cur.mp_idx, y.cur.mp_idx)
    assert torch.equal(o1.map.mp.n_visible, outs[1].map.mp.n_visible)
    assert o1.summary[6] == 1 and o1.summary[2] > 250


def test_track_frame_stereo_defaults_to_cuda_and_raises_without_it(frames, seeded):
    _, (pm, prow, pidx) = seeded
    prev = interop.frame_from_numpy(frames[1][0])
    with pytest.raises(RuntimeError, match="cuda"):
        track_ops.track_frame_stereo(pm, prev, torch.eye(4), *frames[0][1], prow,
                                     torch.zeros(K1, dtype=torch.int32),
                                     torch.zeros(K1, dtype=torch.bool), CAM, CFG)
