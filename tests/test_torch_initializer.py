"""The port's two-view bootstrap (`solvers/initializer.py`, the plain version
of kernel K12) and `matcher.search_for_initialization` (K5's area-window
mode, plain) against corbslam_tpu on the CPU.

Inputs: the three scenes of tests/test_init_reloc.py (a general 3-D scene
that selects F, a plane that selects H, a 0.5 mm baseline that must be
refused), each with JAX's own [256, 8] sample (`jax.random.choice` with the
reference's key and probabilities) passed as `sample=`; and two monocular
frames of tests/test_pipeline.py's planar world at 320x240.

Tolerances and why: ok and the chosen model are exact. The F / H refit is
the null vector of a 9x9 normal matrix in f32, summed in another order than
XLA's, so R agrees within 1e-4, the unit translation within 1e-3 (the F
refit's null vector moves it most: 4e-4 measured) and the triangulated
points within 1e-2 relative (the midpoint of rays 2-4 degrees apart
amplifies that); the good count and mask within one point per hundred
(only points within rounding of a gate flip). The refused scene's points
are triangulated along a 0.5 mm baseline, so there only ok and the model
are held. The area-window search is integer work on the same features:
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.frontend import frame as jframe
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu.matching import matcher as jmatcher
from corbslam_tpu.solvers import initializer as jinit
from corbslam_tpu_torch.geometry import camera
from corbslam_tpu_torch.matching import matcher
from corbslam_tpu_torch.solvers import initializer
from test_init_reloc import CAM as JCAM
from test_init_reloc import two_view_scene

torch.set_num_threads(2)

CAM = camera.Intrinsics.create(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320,
                               height=240)
SCENES = {"general_F": dict(planar=False), "planar_H": dict(planar=True),
          "no_parallax": dict(tx=0.0005, yaw=0.0)}


def jax_sample(key, valid, n_hyp=256):
    """The index array initialize_two_view draws (same key, same probabilities)."""
    probs = jnp.asarray(valid, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return np.asarray(jax.random.choice(key, valid.shape[0], shape=(n_hyp, 8), p=probs),
                      np.int32)


@pytest.mark.parametrize("scene", list(SCENES))
def test_initialize_two_view_equals_the_reference(scene):
    rng = np.random.default_rng(0)
    xy1, xy2, ok, T21, _ = two_view_scene(rng, **SCENES[scene])
    key = jax.random.PRNGKey(0)
    ref = jinit.initialize_two_view(JCAM, jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(ok),
                                    key)
    res = initializer.initialize_two_view(CAM, torch.from_numpy(xy1), torch.from_numpy(xy2),
                                          torch.from_numpy(ok),
                                          sample=torch.from_numpy(jax_sample(key, ok)))
    assert bool(res.ok) == bool(ref.ok) == (scene != "no_parallax")
    assert bool(res.used_H) == bool(ref.used_H)
    if scene == "no_parallax":
        return
    assert bool(res.used_H) == (scene == "planar_H")
    good, good_ref = res.good.numpy(), np.asarray(ref.good)
    n = int(ref.n_good)
    assert abs(int(res.n_good) - n) <= n // 100 and (good != good_ref).sum() <= n // 100
    np.testing.assert_allclose(res.R.numpy(), np.asarray(ref.R), rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(ref.t), rtol=0, atol=1e-3)
    both = good & good_ref
    X, Xr = res.X.numpy()[both], np.asarray(ref.X)[both]
    assert (np.linalg.norm(X - Xr, axis=1) <= 1e-2 * np.linalg.norm(Xr, axis=1)).all()
    # The pose is the scene's (the reference's own test bounds).
    assert np.abs(res.R.numpy() - T21[:3, :3]).max() < 0.02
    t_gt = T21[:3, 3] / np.linalg.norm(T21[:3, 3])
    assert abs(abs(float(res.t.numpy() @ t_gt)) - 1.0) < 0.01


def test_initialize_two_view_draws_from_the_generator():
    rng = np.random.default_rng(0)
    xy1, xy2, ok, _, _ = two_view_scene(rng, planar=True)
    args = (CAM, torch.from_numpy(xy1), torch.from_numpy(xy2), torch.from_numpy(ok))
    a = initializer.initialize_two_view(*args, generator=torch.Generator().manual_seed(5))
    b = initializer.initialize_two_view(*args, generator=torch.Generator().manual_seed(5))
    assert bool(a.ok) and bool(a.used_H) and torch.equal(a.good, b.good)


def test_search_for_initialization_equals_the_reference():
    cam_kw = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240)
    jcam = type(JCAM).create(**cam_kw)
    from corbslam_tpu.config import OrbConfig as JOrb

    jorb = JOrb(n_features=512, n_levels=4, cell_size=12)
    world = jsynthetic.PlanarWorld(jcam, texture_size=2048, plane_dist=10.0, texture_scale=40.0)
    tilt = jse3.exp(jnp.asarray([0, 0, 0, 0.35, 0, 0], jnp.float32))
    frames = []
    for i in (0, 3):
        T = jse3.compose(tilt, jse3.exp(jnp.asarray([-(i * 0.15), 0.0, -(i * 0.03), 0.0,
                                                     i * 0.004, 0.0], jnp.float32)))
        frames.append(jframe.build_frame_mono(world.render_stereo(T)[0], jcam, jorb))
    f1, f2 = frames
    ref = jmatcher.search_for_initialization(f1.xy, f1.desc, f1.angle, f1.fvalid, f2.xy, f2.desc,
                                             f2.angle, f2.fvalid, window=100.0, max_dist=50,
                                             ratio=0.9)
    t = [{k: torch.from_numpy(np.asarray(getattr(f, k)))
          for k in ("xy", "desc", "angle", "fvalid")} for f in frames]
    res = matcher.search_for_initialization(
        t[0]["xy"], t[0]["desc"], t[0]["angle"], t[0]["fvalid"], t[1]["xy"], t[1]["desc"],
        t[1]["angle"], t[1]["fvalid"], window=100.0, max_dist=50, ratio=0.9)
    assert int(np.sum(np.asarray(ref.ok))) > 100
    assert np.array_equal(res.idx.numpy(), np.asarray(ref.idx))
    assert np.array_equal(res.ok.numpy(), np.asarray(ref.ok))
