"""The port's `io/synthetic.SceneWorld` against the JAX package's on the CPU:
the endurance run's room with boxes (`room_with_boxes(half 14, height 3,
5 boxes, ring 8, seed 3)`).

Tolerances and why: the rectangle tables and textures exact (the same numpy
construction); the noise-free render at three poses (the endurance start,
the reference's occlusion pose of tests/test_structured_world.py and two
thirds of a lap) within 1e-3 in the image and 1e-5 relative in depth, outside
at most 0.1 % of the pixels (a silhouette pixel whose two nearest
rectangles' ray parameters differ by one rounding may pick the other one);
the photometric pass without noise within 1e-3 (the same f32 expressions).
The noise cannot be the reference's draw (jax.random against a
torch.Generator), so it is held in distribution: mean 0 and std within 5 %
of 2.0, left and right and frames distinct, the same seed the same draw.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from corbslam_tpu.geometry import camera as jcamera
from corbslam_tpu.geometry import se3 as jse3
from corbslam_tpu.io import synthetic as jsynthetic
from corbslam_tpu_torch.geometry import camera, se3
from corbslam_tpu_torch.io import synthetic

torch.set_num_threads(2)

KW = dict(fx=320.0, fy=320.0, cx=160.0, cy=120.0, bf=160.0, width=320, height=240)
ROOM = dict(half=14.0, height=3.0, n_boxes=5, box_ring=8.0, seed=3)


@pytest.fixture(scope="module")
def worlds():
    jw = jsynthetic.SceneWorld.room_with_boxes(jcamera.Intrinsics.create(**KW), **ROOM)
    pw = synthetic.SceneWorld.room_with_boxes(camera.Intrinsics.create(**KW), **ROOM)
    return jw, pw, jax.jit(jw._render_depth)


def orbit(th):
    return np.asarray(jse3.inverse(jse3.compose(
        jse3.exp(jnp.asarray([0, 0, 0, 0.0, th, 0.0], jnp.float32)),
        jse3.from_Rt(jnp.eye(3), jnp.asarray([0.0, 0.0, -6.0])))))


POSES = {
    "endurance_start": lambda: orbit(0.0),
    "occlusion": lambda: np.asarray(jse3.inverse(jse3.from_Rt(jnp.eye(3),
                                                              jnp.asarray([0.0, 0.0, -3.0])))),
    "two_thirds_lap": lambda: orbit(2 * np.pi * 2 / 3),
}


def test_tables_and_textures_equal_the_references(worlds):
    jw, pw, _ = worlds
    for name in ("o", "u", "v", "n", "e", "tex", "light"):
        np.testing.assert_array_equal(getattr(pw, name).numpy(), np.asarray(getattr(jw, name)),
                                      err_msg=name)
    assert pw.tex.shape == (36, 512, 512)


@pytest.mark.parametrize("pose", list(POSES))
def test_noise_free_render_and_depth_equal_the_references(worlds, pose):
    _, pw, jrender = worlds
    T = POSES[pose]()
    ji, jd = (np.asarray(a) for a in jrender(jnp.asarray(T)))
    pi, pd = (a.numpy() for a in pw._render_depth(torch.tensor(T)))
    img_bad = np.abs(pi - ji) > 1e-3
    depth_bad = np.abs(pd - jd) > 1e-5 * np.abs(jd)
    assert (img_bad | depth_bad).mean() <= 1e-3, (img_bad.mean(), depth_bad.mean())
    assert (jd > 0).mean() > 0.95 and np.isfinite(pi).all()


@pytest.mark.parametrize("frame", [0, 40, 1049])
def test_photometric_pass_without_noise_equals_the_references(worlds, frame):
    jw, pw, jrender = worlds
    T = POSES["endurance_start"]()
    img = np.asarray(jrender(jnp.asarray(T))[0])
    ref = np.asarray(jw._photometric(jnp.asarray(img), frame, None))
    out = pw._photometric(torch.from_numpy(img.copy()), frame).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_noise_is_seeded_per_frame_and_matches_in_distribution(worlds):
    _, pw, _ = worlds
    T = torch.tensor(POSES["endurance_start"]())
    clean = pw._photometric(pw._render_depth(T)[0], 7).numpy()
    Tr = se3.compose(se3.from_Rt(torch.eye(3), torch.tensor([-pw.cam.baseline, 0.0, 0.0])), T)
    clean_r = pw._photometric(pw._render_depth(Tr)[0], 7).numpy()
    left, right = (a.numpy() for a in pw.render_stereo(T, frame=7))
    again = pw.render_stereo(T, frame=7)[0].numpy()
    other = pw.render_stereo(T, frame=8)[0].numpy()
    inside = (clean > 20) & (clean < 235) & (clean_r > 20) & (clean_r < 235)
    for noisy, base in ((left, clean), (right, clean_r)):
        n = (noisy - base)[inside]
        assert abs(n.mean()) < 0.05 * 2.0 and abs(n.std() - 2.0) < 0.05 * 2.0
    assert np.array_equal(left, again)
    assert not np.array_equal((left - clean)[inside], (right - clean_r)[inside])
    assert not np.array_equal(left, other)
    assert np.array_equal(pw.render(T, frame=7).numpy(), left)  # render draws as the left


def test_occlusion_and_exposure_outcomes_hold_on_the_ports_renders(worlds):
    """tests/test_structured_world.py's TestSceneWorld outcomes."""
    _, pw, _ = worlds
    d = pw.depth(torch.tensor(POSES["occlusion"]())).numpy()
    valid = d > 0
    assert valid.mean() > 0.95
    assert (d[valid] < 12.0).mean() > 0.05 and (d[valid] > 13.0).mean() > 0.2
    assert np.abs(np.diff(d, axis=1)).max() > 3.0
    a = pw.render(torch.eye(4), frame=0).numpy()
    b = pw.render(torch.eye(4), frame=40).numpy()
    assert abs(a.mean() - b.mean()) > 2.0
    an, bn = (a - a.mean()) / a.std(), (b - b.mean()) / b.std()
    assert (an * bn).mean() > 0.9

