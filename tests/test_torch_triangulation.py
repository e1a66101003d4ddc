"""The port's inter-keyframe triangulation (`mapping/triangulation.py`, the
plain version of kernel K13) and its search (`matcher.epipolar_band_mask`,
`search_for_triangulation`, K5's band modes, plain, one neighbour and the
batch of a keyframe's neighbours; `fundamental_from_poses`)
against corbslam_tpu on the CPU, on tests/test_init_reloc.py's
`map_with_unbound_pair` (two keyframes sharing 40 bound points and 80
unbound features of fresh landmarks, 0.6 m apart at 7-12 m); also with a
third keyframe that copies keyframe 0 (two neighbour slots with the same
pose and features, so that the first must win every feature), and with 1
and 11 neighbour slots.

Tolerances and why: the searches are integer work on the same band test:
exact. F12 within 1e-6 relative (3x3 products in another order). The
created rows, both keyframes' bindings, the point flags, descriptors and
anchors are exact. Positions within 2e-3 m, median 2e-4 m: the midpoint
of rays 3 degrees apart divides by a c - b^2, which cancels to ~4e-3 of
a c, so one rounding of XLA's fused multiply-adds moves a point by up to
~1e-3 m at 10 m (measured: max 1.1e-3, median 9.5e-5 m; the scale band
and normals follow the positions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.mapping import triangulation as jtri
from corbslam_tpu.mapstate import mapstate as jms
from corbslam_tpu.matching import matcher as jmatcher
from corbslam_tpu_torch import config, interop
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.mapping import triangulation
from corbslam_tpu_torch.matching import matcher
from test_init_reloc import CAM as JCAM
from test_init_reloc import CFG as JCFG
from test_init_reloc import map_with_unbound_pair

torch.set_num_threads(2)

CAM = camera.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320,
                               height=240)
CFG = config.SlamConfig(
    orb=config.OrbConfig(n_features=128, n_levels=4),
    capacity=config.CapacityConfig(max_keyframes=32, max_map_points=2048, max_features=128,
                                   local_window_kfs=8, local_window_mps=512),
)


@pytest.fixture
def pair(rng):
    return map_with_unbound_pair(rng)


def test_fundamental_from_poses_and_the_band_equal_the_reference(pair):
    m, kf_new, _ = pair
    T1, T2 = np.asarray(m.kf.Tcw[kf_new]), np.asarray(m.kf.Tcw[0])
    F_ref = np.asarray(jmatcher.fundamental_from_poses(JCAM, jnp.asarray(T1), JCAM,
                                                       jnp.asarray(T2)))
    F = matcher.fundamental_from_poses(CAM, torch.from_numpy(T1), CAM, torch.from_numpy(T2))
    np.testing.assert_allclose(F.numpy(), F_ref, rtol=1e-6, atol=1e-6 * np.abs(F_ref).max())
    xy1, xy2 = np.asarray(m.kf.xy[kf_new]), np.asarray(m.kf.xy[0])
    oct2 = np.arange(xy2.shape[0], dtype=np.int32) % 4
    s = np.asarray(JCFG.orb.scales(), np.float32)
    ref = np.asarray(jmatcher.epipolar_band_mask(jnp.asarray(F_ref), jnp.asarray(xy1),
                                                 jnp.asarray(xy2), jnp.asarray(oct2),
                                                 jnp.asarray(s * s)))
    ours = matcher.epipolar_band_mask(torch.from_numpy(F_ref), torch.from_numpy(xy1),
                                      torch.from_numpy(xy2), torch.from_numpy(oct2),
                                      torch.from_numpy(s * s))
    assert ref.sum() > 80 and np.array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("epipole", [False, True])
def test_search_for_triangulation_equals_the_reference(pair, epipole):
    m, kf_new, _ = pair
    q, n = kf_new, 0
    T1, T2 = m.kf.Tcw[q], m.kf.Tcw[n]
    F12 = jmatcher.fundamental_from_poses(JCAM, T1, JCAM, T2)
    s = jnp.asarray(JCFG.orb.scales(), jnp.float32)
    e2 = jnp.asarray([300.0, 100.0]) if epipole else None
    unb = [m.kf.fvalid[r] & (m.kf.mp_idx[r] < 0) for r in (q, n)]
    oct2 = m.kf.octave[n]
    ref = jmatcher.search_for_triangulation(
        m.kf.desc[q], m.kf.xy[q], unb[0], ~unb[0] & m.kf.fvalid[q], m.kf.desc[n], m.kf.xy[n],
        oct2, unb[1], ~unb[1] & m.kf.fvalid[n], F12, s * s, epi_center2=e2,
        min_epi_dist=jnp.sqrt(100.0 * s[oct2]) if epipole else None, max_dist=50)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    res = matcher.search_for_triangulation(
        t(m.kf.desc[q]), t(m.kf.xy[q]), t(unb[0]), t(~unb[0] & m.kf.fvalid[q]), t(m.kf.desc[n]),
        t(m.kf.xy[n]), t(oct2), t(unb[1]), t(~unb[1] & m.kf.fvalid[n]), t(F12), t(s),
        epi_center2=t(e2) if epipole else None, max_dist=50)
    assert int(jnp.sum(ref.ok)) > 40
    assert np.array_equal(res.idx.numpy(), np.asarray(ref.idx))
    assert np.array_equal(res.dist.numpy(), np.asarray(ref.dist))


def test_the_neighbour_search_is_the_references_search_per_neighbour(pair):
    """`triangulation.search` (K5's batched band mode, plain here) over the
    keyframe's 8 neighbour slots: the used slot equals the reference's
    search_for_triangulation with the epipole guard on the same F12 and
    epipole; a padded slot searches nothing."""
    m, kf_new, _ = pair
    tm = interop.map_from_numpy(m)
    st = triangulation.setup(CAM, tm, kf_new, CFG)
    res = triangulation.search(tm, st, triangulation.neighbours(tm, st), CFG)
    assert res.idx.shape == (triangulation.N_NEIGHBORS, CFG.orb.n_features)
    s = jnp.asarray(JCFG.orb.scales(), jnp.float32)
    used = st.nb_use.numpy()
    assert used.sum() == 1
    for k in range(used.shape[0]):
        if not used[k]:
            assert (res.idx[k] == -1).all() and not res.ok[k].any()
            continue
        q, n = kf_new, int(st.nb_rows[k])
        unb = [m.kf.fvalid[r] & (m.kf.mp_idx[r] < 0) for r in (q, n)]
        oct2 = m.kf.octave[n]
        ref = jmatcher.search_for_triangulation(
            m.kf.desc[q], m.kf.xy[q], unb[0], ~unb[0] & m.kf.fvalid[q], m.kf.desc[n],
            m.kf.xy[n], oct2, unb[1], ~unb[1] & m.kf.fvalid[n], jnp.asarray(st.F12[k].numpy()),
            s * s, epi_center2=jnp.asarray(st.epipole[k].numpy()),
            min_epi_dist=jnp.sqrt(100.0 * s[oct2]), max_dist=CFG.matcher.th_low)
        assert int(jnp.sum(ref.ok)) > 40
        assert np.array_equal(res.idx[k].numpy(), np.asarray(ref.idx))
        assert np.array_equal(res.dist[k].numpy(), np.asarray(ref.dist))


def _with_twin_of_kf0(m):
    """The map with a third keyframe that copies keyframe 0: the same pose,
    features and bound points, so the new keyframe's first two neighbour
    slots (rows 0 and 2, tied on weight, the lower row first) are identical."""
    kf = m.kf
    m2, row = jms.insert_keyframe(m, kf.Tcw[0], kf.xy[0], kf.octave[0], kf.angle[0], kf.desc[0],
                                  kf.uright[0], kf.depth[0], kf.fvalid[0], kf.mp_idx[0],
                                  frame_id=2, timestamp=2.0)
    assert int(row) == 2
    return m2


def _create_new_points_equal(m, kf_new, X_new, nn=8, tied=False):
    n0 = int(m.n_mp)
    ref = jtri.create_new_points(JCAM, m, kf_new, JCFG, n_neighbors=nn)
    tm = interop.map_from_numpy(m)
    st = triangulation.setup(CAM, tm, kf_new, CFG, nn)
    assert st.nb_rows.shape == (nn,)
    ours = interop.map_to_numpy(triangulation.create_new_points(CAM, tm, kf_new, CFG, nn))
    n1 = int(ref.n_mp)
    if tied:
        assert st.nb_rows[:2].tolist() == [0, 2] and st.nb_use[:2].all()
        assert (ours["kf"]["mp_idx"][0][40:120] >= n0).sum() > 40
        assert (ours["kf"]["mp_idx"][2][40:120] == -1).all()
    assert ours["n_mp"] == n1 and n1 - n0 > 40
    assert np.array_equal(ours["kf"]["mp_idx"], np.asarray(ref.kf.mp_idx))
    for f in ("valid", "desc", "ref_kf", "first_kf", "client", "n_visible", "n_found"):
        assert np.array_equal(ours["mp"][f], np.asarray(getattr(ref.mp, f))), f
    d = np.linalg.norm(ours["mp"]["pos"][n0:n1] - np.asarray(ref.mp.pos)[n0:n1], axis=1)
    assert d.max() < 2e-3 and np.median(d) < 2e-4, (d.max(), np.median(d))
    np.testing.assert_allclose(ours["mp"]["normal"][n0:n1], np.asarray(ref.mp.normal)[n0:n1],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours["mp"]["max_dist"][n0:n1], np.asarray(ref.mp.max_dist)[n0:n1],
                               rtol=2e-4, atol=0)
    # The new points are the scene's fresh landmarks (the reference's own bound).
    pos = ours["mp"]["pos"][n0:n1]
    assert np.median(np.linalg.norm(pos[:, None] - X_new[None], axis=-1).min(axis=1)) < 0.05


def test_create_new_points_equals_the_reference(pair):
    _create_new_points_equal(*pair)


@pytest.mark.parametrize("case", ["tied_slots", "neighbours1", "neighbours11"])
def test_create_new_points_neighbour_slots_equal_the_reference(pair, case):
    """As above with two identical neighbour slots (the first must win: every
    new point is bound on row 0, none on its twin), and with 1 and 11 slots
    (`n_neighbors`)."""
    m, kf_new, X_new = pair
    if case == "tied_slots":
        m = _with_twin_of_kf0(m)
    _create_new_points_equal(m, kf_new, X_new, {"neighbours1": 1, "neighbours11": 11}.get(case, 8),
                             tied=case == "tied_slots")


def test_no_points_without_baseline(pair):
    m, kf_new, _ = pair
    m = m._replace(kf=m.kf._replace(Tcw=m.kf.Tcw.at[1].set(jnp.eye(4))))
    ours = triangulation.create_new_points(CAM, interop.map_from_numpy(m), kf_new, CFG)
    assert int(ours.n_mp) == int(jtri.create_new_points(JCAM, m, kf_new, JCFG).n_mp) == int(m.n_mp)


def test_triangulate_midpoint_and_nanmedian(rng):
    o1, d1, o2, d2 = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(4))
    ref = [np.asarray(a) for a in jtri.triangulate_midpoint(*map(jnp.asarray, (o1, d1, o2, d2)))]
    ours = [a.numpy() for a in triangulation.triangulate_midpoint(
        *map(torch.from_numpy, (o1, d1, o2, d2)))]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
    x = np.array([3.0, np.nan, 1.0, 2.0, 10.0, np.nan], np.float32)
    for v in (x, x[:5], np.full(3, np.nan, np.float32)):
        got = float(triangulation.nanmedian(torch.from_numpy(v)))
        want = float(jnp.nanmedian(jnp.asarray(v)))
        assert (np.isnan(got) and np.isnan(want)) or got == want
