"""Parity of the port's matching policies (`matching/matcher.py`, the plain
versions of kernel K5) with the JAX reference: the masked matcher with
forced ties and fully masked rows and columns, the rotation histogram, the
projection window, and the three searches of the tracking step on frames
and a map built by the JAX package at the small size of
tests/test_pipeline.py.

Everything here is compared exactly: distances are integers, ties go to the
lower index in both packages, and the window and rotation tests use the
same f32 operations in the same order.
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
from corbslam_tpu.matching import matcher as jmatcher
from corbslam_tpu_torch import interop
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.matching import matcher

torch.set_num_threads(2)

T = torch.from_numpy


def _descs(rng, nq, nt):
    """Targets with duplicated rows, queries near some targets (a few bits
    flipped) and duplicated query rows, so that distances tie."""
    dt = rng.integers(0, 256, size=(nt, 32), dtype=np.uint8)
    dt[17] = dt[5]
    dt[30] = dt[5]
    dq = rng.integers(0, 256, size=(nq, 32), dtype=np.uint8)
    src = rng.integers(0, nt, nq // 2)
    near = dt[src].copy()
    flip = rng.integers(0, 32, size=(nq // 2, 3))
    for r in range(nq // 2):
        near[r, flip[r]] ^= np.uint8(1 << int(rng.integers(0, 8)))
    dq[: nq // 2] = near
    dq[40] = dq[2]
    dq[41] = dt[5]
    return dq, dt


@pytest.mark.parametrize("mutual", [True, False])
@pytest.mark.parametrize("ratio", [1.0, 0.9, 0.7])
def test_match_masked_exact_with_ties_and_masked_rows(mutual, ratio):
    rng = np.random.default_rng(7)
    nq, nt = 64, 48
    dq, dt = _descs(rng, nq, nt)
    mask = rng.random((nq, nt)) < 0.7
    mask[3] = False          # fully masked row
    mask[:, 7] = False       # fully masked column
    mask[:, 0] = False       # ... including column 0, the default of masked rows
    ref = jax.jit(jmatcher.match_masked, static_argnames=("max_dist", "ratio", "mutual"))(
        jnp.asarray(dq), jnp.asarray(dt), jnp.asarray(mask), max_dist=100, ratio=ratio,
        mutual=mutual)
    got = matcher.match_masked(T(dq), T(dt), T(mask), 100, ratio, mutual)
    for f in ("idx", "dist", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert int(got.ok.sum()) > 5
    assert int(got.dist[3]) == 512 and int(got.idx[3]) == -1


def _rot_case(rng, counts, n_noise=0):
    """Angle pairs whose differences land in the given bins (bin: count),
    plus `n_noise` random pairs; half of everything else not ok."""
    two_pi = 2 * np.pi
    bins = np.concatenate([np.full(c, b) for b, c in counts.items()] + [np.zeros(0)])
    diff = (bins + rng.uniform(0.2, 0.8, bins.size)) / 30 * two_pi
    diff = np.concatenate([diff, rng.uniform(0, two_pi, n_noise)])
    b = rng.uniform(-np.pi, np.pi, diff.size)
    a = b + diff - two_pi * rng.integers(-1, 2, diff.size)  # wrap to exercise floor-mod
    ok = np.ones(diff.size, bool)
    ok[rng.random(diff.size) < 0.1] = False
    return a.astype(np.float32), b.astype(np.float32), ok


ROT_CASES = ["tied_bins", "top_below_10", "small_bins_dropped", "random"]


@pytest.mark.parametrize("case", ROT_CASES)
def test_rotation_consistency_exact(case):
    rng = np.random.default_rng(ROT_CASES.index(case))
    counts = dict(tied_bins={3: 12, 7: 12, 12: 12, 20: 12, 25: 2},
                  top_below_10={4: 4, 9: 2, 15: 1, 28: 1},
                  small_bins_dropped={1: 40, 2: 3, 29: 2, 10: 1},
                  random={})[case]
    a, b, ok = _rot_case(rng, counts, n_noise=200 if case == "random" else 0)
    ref = jax.jit(jmatcher.rotation_consistency)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(ok))
    got = matcher.rotation_consistency(T(a), T(b), T(ok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int(ok.sum()) or case == "top_below_10"


@pytest.mark.parametrize("slack", [(1, 1), (1, 2), (16, 16)])
def test_projection_window_mask_exact(slack):
    rng = np.random.default_rng(slack[1])
    m, n = 300, 400
    uv = rng.uniform(0, 320, (m, 2)).astype(np.float32)
    xy = rng.uniform(0, 320, (n, 2)).astype(np.float32)
    vis, fv = rng.random(m) < 0.8, rng.random(n) < 0.9
    foct = rng.integers(0, 4, n).astype(np.int32)
    poct = rng.integers(0, 4, m).astype(np.int32)
    sf = np.asarray([1.2 ** i for i in range(4)], np.float32)
    ref = jax.jit(jmatcher.projection_window_mask,
                  static_argnames=("radius", "octave_slack", "octave_slack_up"))(
        jnp.asarray(uv), jnp.asarray(vis), jnp.asarray(xy), jnp.asarray(foct), jnp.asarray(fv),
        radius=40.0, scale_factors=jnp.asarray(sf), pred_octave=jnp.asarray(poct),
        octave_slack=slack[0], octave_slack_up=slack[1])
    got = matcher.projection_window_mask(T(uv), T(vis), T(xy), T(foct), T(fv), 40.0, T(sf),
                                         T(poct), slack[0], slack[1])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 100 < int(got.sum()) < m * n // 2


# ---------------------------------------------------------------------------
# The three searches of the tracking step on JAX-built frames and map
# ---------------------------------------------------------------------------

KW = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=320.0 * 0.5, width=320, height=240)
JCAM, CAM = jcamera.Intrinsics.create(**KW), camera.Intrinsics.create(**KW)
JCFG = jconfig.SlamConfig(
    orb=jconfig.OrbConfig(n_features=512, n_levels=4, cell_size=12),
    tracking=jconfig.TrackingConfig(th_depth=40.0, max_frames_between_kf=10),
    capacity=jconfig.CapacityConfig(max_keyframes=64, max_map_points=8192, max_features=512,
                                    local_window_kfs=8, local_window_mps=2048),
)


def _gt(i):
    tilt = jse3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    return jse3.compose(tilt, jse3.exp(jnp.asarray([-(i * 0.12), 0.0, -(i * 0.03), 0.0,
                                                    i * 0.004, 0.0], jnp.float32)))


@pytest.fixture(scope="module")
def scene():
    """Frame 0 as a keyframe with its spawned points, frame 1 built, both by
    the JAX package."""
    world = jsynthetic.PlanarWorld(JCAM, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
    render = jax.jit(world.render_stereo)
    build = jax.jit(jframe.build_frame_stereo, static_argnames=("cam", "cfg"))
    f0 = build(*render(_gt(0)), JCAM, JCFG.orb)._replace(Tcw=jnp.eye(4))
    m, _, mp_idx = jtrack.insert_keyframe_with_points(JCAM, jms.empty(JCFG.capacity), f0, 0, 0.0,
                                                      JCFG)
    f1 = build(*render(_gt(1)), JCAM, JCFG.orb)
    return m, f0._replace(mp_idx=mp_idx), f1


def _same(got, ref):
    for f in ("idx", "dist", "ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_search_frame_frame_exact(scene):
    m, prev, cur = scene
    scales = jnp.asarray(JCFG.orb.scales(), jnp.float32)
    T_pred = np.asarray(_gt(1) @ jse3.inverse(_gt(0)))  # the true motion as the prediction
    prev_pos = m.mp.pos[jnp.clip(prev.mp_idx, 0)]
    ok = (prev.mp_idx >= 0) & prev.fvalid
    args = (prev_pos, ok, prev.xy, prev.octave, prev.desc, prev.angle, cur.xy, cur.octave,
            cur.desc, cur.angle, cur.fvalid, scales)
    ref = jax.jit(jmatcher.search_frame_frame, static_argnames=("cam", "radius", "max_dist"))(
        JCAM, jnp.asarray(T_pred), *args, radius=15.0, max_dist=100)
    got = matcher.search_frame_frame(CAM, T(T_pred), *(T(np.asarray(a)) for a in args),
                                     radius=15.0, max_dist=100)
    _same(got, ref)
    assert int(got.ok.sum()) > 150


def test_search_by_projection_points_exact(scene):
    m, _, cur = scene
    scales = jnp.asarray(JCFG.orb.scales(), jnp.float32)
    T1 = np.asarray(_gt(1) @ jse3.inverse(_gt(0)))
    n = int(m.n_mp)
    mp = [m.mp.pos[:n], m.mp.desc[:n], m.mp.valid[:n], m.mp.min_dist[:n], m.mp.max_dist[:n],
          m.mp.normal[:n]]
    feat = [cur.xy, cur.octave, cur.desc, cur.fvalid & (jnp.arange(512) % 3 > 0)]
    kw = dict(scale_factor=1.2, radius=3.75, max_dist=100, ratio=0.8, octave_slack=16,
              octave_slack_up=16)
    ref_res, ref_vis = jax.jit(
        jmatcher.search_by_projection_points,
        static_argnames=("cam", "scale_factor", "radius", "max_dist", "ratio", "octave_slack",
                         "octave_slack_up"))(JCAM, jnp.asarray(T1), *mp, *feat, scales, **kw)
    got_res, got_vis = matcher.search_by_projection_points(
        CAM, T(T1), *(T(np.asarray(a)) for a in mp + feat), T(np.asarray(scales)), **kw)
    np.testing.assert_array_equal(got_vis.numpy(), np.asarray(ref_vis))
    _same(got_res, ref_res)
    assert int(got_res.ok.sum()) > 100


def test_search_by_descriptor_exact(scene):
    m, prev, cur = scene
    args = [cur.desc, cur.fvalid, m.kf.desc[0], m.kf.fvalid[0] & (m.kf.mp_idx[0] >= 0)]
    ref = jax.jit(jmatcher.search_by_descriptor, static_argnames=("max_dist", "ratio"))(
        *args, max_dist=50, ratio=0.7)
    got = matcher.search_by_descriptor(*(T(np.asarray(a)) for a in args), max_dist=50, ratio=0.7)
    _same(got, ref)
    assert int(got.ok.sum()) > 50
    assert interop.features_to_numpy(got)["idx"].dtype == np.int32
