"""Parity of the port's ORB front end (plain PyTorch versions, CPU) with the
JAX reference, stage by stage on identical inputs: JAX's own pyramid levels
feed the port's FAST, JAX's patches feed the port's orientation and BRIEF.

Tolerances and why:
  * FAST score + NMS, cell winners, top-k, patches: exact — f32
    subtraction, min/max and copies on the same inputs.
  * pyramid levels: <= 1e-3 on the 0..255 scale — the two sum the resize
    and blur taps in different orders.
  * orientation: 1e-5 rad, widened to the f32 rounding bound of the moment
    sums for keypoints with a short moment vector — the sums differ in order.
  * descriptors: exact for the same angle; with each side's own angle,
    exact wherever the angle bins agree, and at most 0.5 % bin flips.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.config import OrbConfig as JOrbConfig
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.ops import brief as jbrief
from corbslam_tpu.ops import fast as jfast
from corbslam_tpu.ops import orb as jorb
from corbslam_tpu.ops import patches as jpatches
from corbslam_tpu.ops import pyramid as jpyramid
from corbslam_tpu_torch import interop
from corbslam_tpu_torch.config import OrbConfig
from corbslam_tpu_torch.ops import brief, fast, orb, patches, pyramid

torch.set_num_threads(2)

# (h, w, n_features, n_levels): the first pads its level-0 top-k (112 slots
# for 104 cells), the second does not.
CONFIGS = [(120, 200, 256, 3), (200, 360, 512, 4)]


@partial(jax.jit, static_argnames=("cfg",))
def _jax_stages(img, cfg):
    levels, blurred = jpyramid.build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    budgets = cfg.features_per_level()
    nms, dets, raw, blur = [], [], [], []
    for lvl in range(cfg.n_levels):
        score = jfast.nms3x3(jfast.fast_score_map(levels[lvl], cfg.min_th_fast))
        det = jfast.select_keypoints_cells(score, cfg.cell_size, budgets[lvl])
        det.pop("grid_hw")
        nms.append(score)
        dets.append(det)
        for src, out, size in ((levels, raw, orb.RAW_PATCH), (blurred, blur, orb.BRIEF_PATCH)):
            win = jpatches.winner_patches(jpatches.cell_windows(src[lvl], cfg.cell_size),
                                          det["cell_id"])
            out.append(jpatches.recenter(win, det["iy"], det["ix"], size))
    raw, blur = jnp.concatenate(raw), jnp.concatenate(blur)
    angle = jbrief.orientation_from_patches(raw)
    return dict(levels=levels, blurred=blurred, nms=nms, dets=dets, raw=raw, blur=blur,
                angle=angle, desc=jbrief.brief_from_patches(blur, angle))


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: "x".join(map(str, c)))
def case(request):
    h, w, nf, nl = request.param
    img = jsynthetic.random_texture(h, w, seed=3)
    jcfg = JOrbConfig(n_features=nf, n_levels=nl)
    ref = jax.tree.map(np.asarray, _jax_stages(jnp.asarray(img), jcfg))
    return dict(img=img, cfg=OrbConfig(n_features=nf, n_levels=nl), jcfg=jcfg, ref=ref)


def T(a):
    return torch.from_numpy(np.array(a))


def test_fast_score_nms_bit_exact(case):
    for lvl, level in enumerate(case["ref"]["levels"]):
        got = fast.nms3x3(fast.fast_score_map(T(level), case["cfg"].min_th_fast))
        np.testing.assert_array_equal(got.numpy(), case["ref"]["nms"][lvl], err_msg=f"level {lvl}")


def test_cell_winners_and_topk_exact(case):
    cfg = case["cfg"]
    for lvl, score in enumerate(case["ref"]["nms"]):
        got = fast.select_keypoints_cells(T(score), cfg.cell_size, cfg.features_per_level()[lvl])
        for k in ("xy", "resp", "valid", "cell_id", "iy", "ix"):
            np.testing.assert_array_equal(got[k].numpy(), case["ref"]["dets"][lvl][k],
                                          err_msg=f"level {lvl} field {k}")


def test_topk_ties_keep_lower_cell_first():
    # Integer scores tie everywhere; the reference orders ties by cell index.
    rng = np.random.default_rng(5)
    score = rng.integers(0, 4, size=(64, 96)).astype(np.float32)
    ref = jax.jit(lambda s: {k: v for k, v in jfast.select_keypoints_cells(s, 16, 20).items()
                             if k != "grid_hw"})(jnp.asarray(score))
    got = fast.select_keypoints_cells(T(score), 16, 20)
    for k in ("resp", "cell_id", "iy", "ix"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_keypoint_patches_exact_zero_outside(case):
    cfg, ref = case["cfg"], case["ref"]
    raw = []
    for lvl, det in enumerate(ref["dets"]):
        gx = -(-ref["levels"][lvl].shape[1] // cfg.cell_size)
        cid = det["cell_id"].astype(np.int64)
        x = T((cid % gx) * cfg.cell_size + det["ix"])
        y = T((cid // gx) * cfg.cell_size + det["iy"])
        raw.append(patches.keypoint_patches(T(ref["levels"][lvl]), x, y, orb.RAW_PATCH))
    np.testing.assert_array_equal(torch.cat(raw).numpy(), ref["raw"])


def test_orientation_atol_1e5(case):
    """1e-5 rad, widened for a keypoint whose moment vector is short: the two
    f32 sums of ~709 products differ in order, so an angle can move by up to
    sqrt(n) * eps * sum|p * w| / |m| (the rounding bound of the sums)."""
    ref = case["ref"]
    got = brief.orientation_from_patches(T(ref["raw"])).numpy().astype(np.float64)
    d = np.abs(np.angle(np.exp(1j * (got - ref["angle"]))))
    raw = ref["raw"].reshape(len(got), -1).astype(np.float64)
    w = brief._orientation_weights(orb.RAW_PATCH).astype(np.float64)
    m = raw @ w
    n_disc = int((w[:, 0] != 0).sum() + 1)
    rounding = np.sqrt(n_disc) * np.finfo(np.float32).eps * (np.abs(raw) @ np.abs(w)).max(1)
    bound = np.maximum(1e-5, rounding / np.hypot(m[:, 0], m[:, 1]))
    assert (d <= bound).all(), f"max excess {(d - bound).max()}"
    assert (d <= 1e-5).mean() >= 0.99


def test_descriptors_exact_same_angle(case):
    got = brief.brief_from_patches(T(case["ref"]["blur"]), T(case["ref"]["angle"]))
    np.testing.assert_array_equal(got.numpy(), case["ref"]["desc"])


def test_descriptors_own_angle_exact_where_bins_agree(case):
    ref = case["ref"]
    angle = brief.orientation_from_patches(T(ref["raw"]))
    got = brief.brief_from_patches(T(ref["blur"]), angle).numpy()
    same = (brief.angle_bin(angle) == brief.angle_bin(T(ref["angle"]))).numpy()
    assert 1.0 - same.mean() <= 0.005, f"{(~same).sum()} angle-bin flips"
    np.testing.assert_array_equal(got[same], ref["desc"][same])


def test_pyramid_levels_within_1e3(case):
    cfg, ref = case["cfg"], case["ref"]
    h, w = case["img"].shape
    prm = orb.params(cfg, h, w, "cpu")
    pyr = pyramid.build_pyramid(T(case["img"])[None], prm)
    for lvl in range(cfg.n_levels):
        np.testing.assert_allclose(pyr.level(lvl).numpy(), ref["levels"][lvl], rtol=0, atol=1e-3)
        np.testing.assert_allclose(pyr.blurred_level(lvl).numpy(), ref["blurred"][lvl],
                                   rtol=0, atol=1e-3)


def test_resize_and_blur_single_level(case):
    img = case["img"]
    hw = pyramid.level_shapes(*img.shape, 2, 1.2)[1]
    np.testing.assert_allclose(
        pyramid.resize_bilinear(T(img), hw).numpy(),
        np.asarray(jax.jit(jpyramid.resize_bilinear, static_argnums=1)(jnp.asarray(img), hw)),
        rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        pyramid.gaussian_blur(T(img)).numpy(),
        np.asarray(jax.jit(jpyramid.gaussian_blur)(jnp.asarray(img))), rtol=0, atol=1e-3)


def test_extract_end_to_end_120x200():
    img = jsynthetic.random_texture(120, 200, seed=11)
    ref = jorb.extract_jit(jnp.asarray(img), JOrbConfig(n_features=256, n_levels=3))
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = orb.extract(img, OrbConfig(n_features=256, n_levels=3), device="cpu")
    got = {k: v.numpy() for k, v in got._asdict().items()}
    n_shared = n_desc_equal = 0
    for lvl in range(3):
        def keyed(d):
            sel = (d["octave"] == lvl) & d["valid"]
            return {tuple(xy): i for xy, i in zip(d["xy"][sel].tolist(), np.flatnonzero(sel))}
        kr, kg = keyed(ref), keyed(got)
        shared = kr.keys() & kg.keys()
        assert len(shared) >= 0.99 * max(len(kr), len(kg)), f"level {lvl}"
        n_shared += len(shared)
        n_desc_equal += sum(np.array_equal(ref["desc"][kr[k]], got["desc"][kg[k]]) for k in shared)
    assert n_shared > 0 and n_desc_equal >= 0.99 * n_shared


# K2's edges: a flat image (no corner, every cell tied at 0), level widths
# that are no multiple of a multi-cell tile (97 x 131 with 12-px cells), and
# levels with more cells than their budget beside levels with fewer (cells
# 99, 70, 48, 35 against budgets 88, 64, 56, 48).
EDGES = {
    "flat": (120, 200, 16, 256, 3),
    "97x131_cell12": (97, 131, 12, 200, 3),
    "over_and_under_budget": (97, 131, 12, 256, 4),
}


@pytest.mark.parametrize("edge", list(EDGES))
def test_detect_pyramid_plain_edges_exact(edge):
    """`detect_pyramid_plain` on JAX's own levels against JAX's detect_cells
    level by level: every Keypoints field exact."""
    h, w, cell, nf, nl = EDGES[edge]
    if edge == "flat":
        img = np.full((h, w), 128.0, np.float32)
    else:
        img = jsynthetic.random_texture(h, w, seed=13)
    cfg = OrbConfig(n_features=nf, n_levels=nl, cell_size=cell)
    jlevels, _ = jax.jit(jpyramid.build_pyramid, static_argnums=(1, 2))(
        jnp.asarray(img), nl, cfg.scale_factor)
    prm = orb.params(cfg, h, w, "cpu")
    flat = np.concatenate([np.asarray(lv).reshape(-1) for lv in jlevels])[None]
    pyr = pyramid.Pyramid(T(flat), T(flat), prm.shapes, prm.offsets)
    got = fast.detect_pyramid_plain(pyr, prm)
    budgets = cfg.features_per_level()
    grids = [(-(-lh // cell)) * (-(-lw // cell)) for lh, lw in prm.shapes]
    if edge == "over_and_under_budget":
        assert any(g > k for g, k in zip(grids, budgets))
        assert any(g < k for g, k in zip(grids, budgets))
    k0 = 0
    for lvl, level in enumerate(jlevels):
        ref = jfast.detect_cells(level, cfg.ini_th_fast, cell, budgets[lvl], cfg.min_th_fast)
        sl = slice(k0, k0 + budgets[lvl])
        np.testing.assert_array_equal(got.xy[0, sl].numpy(),
                                      np.asarray(ref["xy"]) * prm.scales[lvl].numpy())
        for f in ("resp", "valid", "cell_id", "iy", "ix"):
            np.testing.assert_array_equal(getattr(got, f)[0, sl].numpy(), np.asarray(ref[f]),
                                          err_msg=f"level {lvl} field {f}")
        np.testing.assert_array_equal(got.octave[0, sl].numpy(), lvl)
        k0 += budgets[lvl]
    if edge == "flat":
        assert not got.valid.any() and (got.resp == 0).all()


def _reflect(i, n):
    i = np.abs(i)
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


def _cone_emulation(img: np.ndarray, shapes) -> tuple:
    """K1's algorithm in numpy, CTA by CTA (`pyramid.cone_plan`): each
    rectangle resized from the CTA's rectangle of the level before, its
    owned pixels copied out and blurred from it. Asserts every tap and blur
    tap lies inside the CTA's rectangle, every pixel is owned once and the
    CTA's taps fit its shared tap table without overlap."""
    plan, nty, ntx, cap_a, cap_b, cap_t, cap_taps = pyramid.cone_plan(shapes)
    rows, cols = plan[:nty], plan[nty:nty + ntx]
    L = len(shapes)
    k = pyramid.gaussian_kernel_1d()
    taps = [None] + [tuple(interop.taps_from_matrix(pyramid._resize_matrix(shapes[l][a],
                                                                           shapes[l - 1][a]))
                           for a in (0, 1)) for l in range(1, L)]
    levels = [np.full(hw, np.nan, np.float32) for hw in shapes]
    blurred = [np.full(hw, np.nan, np.float32) for hw in shapes]
    for ty in range(nty):
        for tx in range(ntx):
            used = np.zeros(cap_taps, int)
            for l in range(1, L):
                for (lo, hi, *_, base) in (rows[ty, l, :5], cols[tx, l, :5]):
                    used[base:base + hi - lo + 1] += 1
            assert used.max() <= 1 and used.sum() == sum(
                rows[ty, l, 1] - rows[ty, l, 0] + cols[tx, l, 1] - cols[tx, l, 0] + 2
                for l in range(1, L))
            prev = None
            for l in range(L):
                (r0, r1, o0, o1), (c0, c1, p0, p1) = rows[ty, l, :4], cols[tx, l, :4]
                assert (r1 - r0 + 1) * ((c1 - c0 + 1) | 1) <= (cap_b if l % 2 else cap_a)
                if l == 0:
                    reg = img[r0:r1 + 1, c0:c1 + 1]
                else:
                    (ri, rw), (ci, cw) = taps[l]
                    (pr0, pc0), preg = prev
                    yi, xi = ri[r0:r1 + 1] - pr0, ci[c0:c1 + 1] - pc0
                    assert yi.min() >= 0 and yi.max() < preg.shape[0]
                    assert xi.min() >= 0 and xi.max() < preg.shape[1]
                    wy, wx = rw[r0:r1 + 1], cw[c0:c1 + 1]
                    t0 = wy[:, :1] * preg[yi[:, 0]][:, xi[:, 0]] + wy[:, 1:] * preg[yi[:, 1]][:, xi[:, 0]]
                    t1 = wy[:, :1] * preg[yi[:, 0]][:, xi[:, 1]] + wy[:, 1:] * preg[yi[:, 1]][:, xi[:, 1]]
                    reg = wx[None, :, 0] * t0 + wx[None, :, 1] * t1
                assert np.isnan(levels[l][o0:o1, p0:p1]).all()
                levels[l][o0:o1, p0:p1] = reg[o0 - r0:o1 - r0, p0 - c0:p1 - c0]
                h, w = shapes[l]
                ry, cx = _reflect(np.arange(o0 - 3, o1 + 3), h) - r0, _reflect(np.arange(p0 - 3, p1 + 3), w) - c0
                assert ry.min() >= 0 and ry.max() < reg.shape[0]
                assert (o1 - o0 + 6) * (p1 - p0) <= cap_t
                assert cx.min() >= 0 and cx.max() < reg.shape[1]
                sub = reg[ry][:, cx]
                mid = sum(k[q] * sub[:, q:q + p1 - p0] for q in range(7))
                blurred[l][o0:o1, p0:p1] = sum(k[q] * mid[q:q + o1 - o0] for q in range(7))
                prev = ((r0, c0), reg)
    return levels, blurred


@pytest.mark.parametrize("h,w,n_levels", [(376, 1241, 8), (240, 320, 4), (120, 200, 3),
                                          (70, 100, 3)])
def test_k1_cone_plan_rebuilds_the_pyramid(h, w, n_levels):
    """K1's tiling: every CTA's rectangles hold the taps and blur halo of
    what it owns, the owned pixels partition every level, and the pyramid
    built cone by cone is the plain version's within 1e-3 (numpy sums
    without fused multiply-adds)."""
    img = jsynthetic.random_texture(h, w, seed=5).astype(np.float32)
    cfg = OrbConfig(n_features=256, n_levels=n_levels)
    prm = orb.params(cfg, h, w, "cpu")
    levels, blurred = _cone_emulation(img, prm.shapes)
    ref = pyramid.build_pyramid_plain(T(img)[None], prm)
    for lvl in range(n_levels):
        assert not np.isnan(levels[lvl]).any() and not np.isnan(blurred[lvl]).any()
        np.testing.assert_allclose(levels[lvl], ref.level(lvl).numpy(), rtol=0, atol=1e-3)
        np.testing.assert_allclose(blurred[lvl], ref.blurred_level(lvl).numpy(), rtol=0, atol=1e-3)
