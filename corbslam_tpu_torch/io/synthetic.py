"""Synthetic imagery (port of `corbslam_tpu/io/synthetic.py`: `random_texture`,
`bilinear_sample`, `PlanarWorld` with its depth map, `MultiPlaneWorld` with
`room` and its photometric noise, `SceneWorld` with `room_with_boxes`, its
occlusion, shading, exposure drift, vignetting and noise).

These are the test worlds, not kernels: on the card they render with plain
tensor operations on the world's `device`.

`jax.image.resize(..., "bilinear")` upsampling of each noise octave is a
half-pixel triangle filter whose edge taps are renormalized, which for
upsampling equals the clamped bilinear matrix of `ops.pyramid._resize_matrix`;
the port applies it as `Ry @ layer @ Rx^T` in f32 numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3
from ..ops.pyramid import _resize_matrix


def random_texture(h: int, w: int, seed: int = 0, octaves: int = 4) -> np.ndarray:
    """Multi-octave smoothed noise in [0, 255], strong local contrast."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    for o in range(octaves):
        sh, sw = max(2, h >> (octaves - o)), max(2, w >> (octaves - o))
        layer = rng.normal(size=(sh, sw)).astype(np.float32)
        layer = _resize_matrix(h, sh) @ layer @ _resize_matrix(w, sw).T
        img += layer * np.float32(2.0 ** -o)
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return (img * 255.0).astype(np.float32)


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    plane: torch.Tensor | None = None) -> torch.Tensor:
    """Bilinear interpolation with clamping. img [H, W]; ys/xs any shape. With
    `plane` (an integer tensor of ys' shape), img is a stack [P, H, W] and
    each sample reads its own plane of it."""
    h, w = img.shape[-2:]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    dx = xs - x0
    dy = ys - y0
    x0 = x0.to(torch.int64).clamp(0, w - 1)
    y0 = y0.to(torch.int64).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    flat = img.reshape(-1)
    if plane is not None:
        base = plane.to(torch.int64) * (h * w)
        y0, y1 = y0 * w + base, y1 * w + base
    else:
        y0, y1 = y0 * w, y1 * w
    return (flat[y0 + x0] * (1 - dy) * (1 - dx) + flat[y0 + x1] * (1 - dy) * dx
            + flat[y1 + x0] * dy * (1 - dx) + flat[y1 + x1] * dy * dx)


class PlanarWorld:
    """A textured plane z = plane_dist (world frame) rendered from any pose:
    each pixel's ray is intersected with the plane and the texture is read
    bilinearly at (x, y) * texture_scale + size / 2. Stereo pairs and
    sequences are exactly consistent, with known poses. Renders on `device`
    in f32; the texture is `random_texture(texture_size, texture_size, seed)`.
    """

    def __init__(self, cam, texture_size: int = 4096, plane_dist: float = 12.0,
                 texture_scale: float = 50.0, seed: int = 0, device="cpu"):
        self.cam = cam
        self.plane_dist = float(plane_dist)
        self.texture_scale = float(texture_scale)
        self.tex_size = texture_size
        self.device = torch.device(device)
        self.tex = torch.from_numpy(random_texture(texture_size, texture_size, seed)).to(self.device)
        self.Kinv = torch.linalg.inv(cam.K).to(self.device)

    def _intersect(self, Tcw: torch.Tensor):
        """(camera centre t, camera-frame rays, world-frame directions, ray
        parameter lam of the plane hit) of every pixel of the view Tcw."""
        cam = self.cam
        Twc = se3.inverse(Tcw.to(self.device, torch.float32))
        R, t = se3.rotation(Twc), se3.translation(Twc)
        h, w = cam.height, cam.width
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=self.device),
                                torch.arange(w, dtype=torch.float32, device=self.device),
                                indexing="ij")
        pix = torch.stack([xx, yy, torch.ones_like(xx)])
        rays = torch.einsum("ij,jhw->ihw", self.Kinv, pix)
        dirs = torch.einsum("ij,jhw->ihw", R, rays)
        denom = dirs[2]
        lam = (self.plane_dist - t[2]) / torch.where(denom.abs() < 1e-6,
                                                     torch.full_like(denom, 1e-6), denom)
        return t, rays, dirs, lam

    def render(self, Tcw: torch.Tensor) -> torch.Tensor:
        """The view from pose Tcw (world -> camera): [H, W] f32; rays that miss
        the plane render as 128."""
        t, _, dirs, lam = self._intersect(Tcw)
        c = self.tex_size / 2.0
        tx = (t[0] + lam * dirs[0]) * self.texture_scale + c
        ty = (t[1] + lam * dirs[1]) * self.texture_scale + c
        img = bilinear_sample(self.tex, ty, tx)
        return torch.where(lam > 0, img, torch.full_like(img, 128.0))

    def render_stereo(self, Tcw: torch.Tensor):
        """(left, right); the right camera sits `baseline` along +x."""
        T_rl = se3.from_Rt(torch.eye(3), torch.tensor([-self.cam.baseline, 0.0, 0.0]))
        Tcw = Tcw.to(torch.float32).cpu()
        return self.render(Tcw), self.render(se3.compose(T_rl, Tcw))

    def depth(self, Tcw: torch.Tensor) -> torch.Tensor:
        """The view's ground-truth depth map [H, W] f32 (camera z of the plane
        hit, 0 where the ray misses), the RGB-D sensor's second image."""
        _, rays, _, lam = self._intersect(Tcw)
        return torch.where(lam > 0, lam * rays[2], torch.zeros_like(lam))


class MultiPlaneWorld:
    """Textured planes composited by z-buffer (a room of 4 walls, floor and
    ceiling for the loop orbit), rendered in f32 on `device`. Plane i is
    n_i . p = d_i with an in-plane chart (u_i, v_i) from its origin o_i onto
    its own `random_texture(texture_size, texture_size, seed * 131 + i)`.

    With `noise_std` > 0 each rendered frame gets Gaussian photometric noise
    of that std, clipped to [0, 255], drawn from a `torch.Generator` on
    `device` seeded with seed * 977 + frame * 2 (the left image of a stereo
    pair first, then the right: two distinct draws). The reference draws from
    `jax.random` under the same seed, which cannot be repeated here, so the
    noise matches in distribution only; with `noise_std` 0 nothing is drawn
    and every pixel is the noise-free render."""

    def __init__(self, cam, planes, texture_size: int = 2048, texture_scale: float = 50.0,
                 noise_std: float = 0.0, seed: int = 0, device="cpu"):
        self.cam = cam
        self.texture_scale = float(texture_scale)
        self.noise_std = float(noise_std)
        self._noise_seed = seed
        self.tex_size = texture_size
        self.device = torch.device(device)
        n_l, d_l, o_l, u_l, v_l, tex = [], [], [], [], [], []
        for i, (n, d, o) in enumerate(planes):
            n = np.asarray(n, np.float32)
            n = n / np.linalg.norm(n)
            a = np.array([0.0, 1.0, 0.0] if abs(n[0]) > 0.9 else [1.0, 0.0, 0.0], np.float32)
            u = np.cross(n, a)
            u /= np.linalg.norm(u)
            n_l.append(n)
            d_l.append(float(d))
            o_l.append(np.asarray(o, np.float32))
            u_l.append(u)
            v_l.append(np.cross(n, u))
            tex.append(random_texture(texture_size, texture_size, seed * 131 + i))
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)  # noqa: E731
        self.n, self.d, self.o = t(np.stack(n_l)), t(np.asarray(d_l)), t(np.stack(o_l))
        self.u, self.v, self.tex = t(np.stack(u_l)), t(np.stack(v_l)), t(np.stack(tex))
        self.Kinv = torch.linalg.inv(cam.K).to(self.device)

    @staticmethod
    def room(cam, half: float = 14.0, height: float = 3.0, noise_std: float = 0.0,
             seed: int = 0, texture_scale: float = 60.0, device="cpu") -> "MultiPlaneWorld":
        """A closed box room: orbits inside it re-observe the start view."""
        h = half
        planes = [
            ([0.0, 0.0, -1.0], -h, [0.0, 0.0, h]),
            ([0.0, 0.0, 1.0], -h, [0.0, 0.0, -h]),
            ([1.0, 0.0, 0.0], -h, [-h, 0.0, 0.0]),
            ([-1.0, 0.0, 0.0], -h, [h, 0.0, 0.0]),
            ([0.0, -1.0, 0.0], -height, [0.0, height, 0.0]),
            ([0.0, 1.0, 0.0], -height, [0.0, -height, 0.0]),
        ]
        return MultiPlaneWorld(cam, planes, noise_std=noise_std, seed=seed,
                               texture_scale=texture_scale, device=device)

    def _render_depth(self, Tcw: torch.Tensor):
        cam = self.cam
        Twc = se3.inverse(Tcw.to(self.device, torch.float32))
        R, t = se3.rotation(Twc), se3.translation(Twc)
        h, w = cam.height, cam.width
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=self.device),
                                torch.arange(w, dtype=torch.float32, device=self.device),
                                indexing="ij")
        rays = torch.einsum("ij,jhw->ihw", self.Kinv, torch.stack([xx, yy, torch.ones_like(xx)]))
        dirs = torch.einsum("ij,jhw->ihw", R, rays)
        ndotdir = torch.einsum("pi,ihw->phw", self.n, dirs)
        lam = (self.d - self.n @ t)[:, None, None] / torch.where(
            ndotdir.abs() < 1e-6, torch.full_like(ndotdir, 1e-6), ndotdir)
        lam = torch.where(lam > 0.05, lam, torch.full_like(lam, float("inf")))
        lam_b, best = lam.min(dim=0)
        hit = torch.isfinite(lam_b)
        lam_b = torch.where(hit, lam_b, torch.zeros_like(lam_b))
        p = t[:, None, None] + lam_b[None] * dirs
        c = self.tex_size / 2.0
        rel = p[None] - self.o[:, :, None, None]
        tx = torch.einsum("pi,pihw->phw", self.u, rel) * self.texture_scale + c
        ty = torch.einsum("pi,pihw->phw", self.v, rel) * self.texture_scale + c
        samp = torch.stack([bilinear_sample(self.tex[i], ty[i], tx[i])
                            for i in range(self.tex.shape[0])])
        img = torch.gather(samp, 0, best[None])[0]
        img = torch.where(hit, img, torch.full_like(img, 128.0))
        return img, torch.where(hit, lam_b * rays[2], torch.zeros_like(lam_b))

    def _noisy(self, imgs, frame: int):
        """The images with frame `frame`'s noise, one draw each in order."""
        if self.noise_std <= 0.0:
            return imgs
        gen = torch.Generator(device=self.device).manual_seed(self._noise_seed * 977 + frame * 2)
        return [(img + torch.randn(img.shape, generator=gen, device=self.device)
                 * self.noise_std).clamp(0.0, 255.0) for img in imgs]

    def render(self, Tcw: torch.Tensor, frame: int = 0) -> torch.Tensor:
        return self._noisy([self._render_depth(Tcw)[0]], frame)[0]

    def render_stereo(self, Tcw: torch.Tensor, frame: int = 0):
        """(left, right); the right camera sits `baseline` along +x."""
        T_rl = se3.from_Rt(torch.eye(3), torch.tensor([-self.cam.baseline, 0.0, 0.0]))
        Tcw = Tcw.to(torch.float32).cpu()
        left, right = (self._render_depth(T)[0] for T in (Tcw, se3.compose(T_rl, Tcw)))
        return tuple(self._noisy([left, right], frame))

    def depth(self, Tcw: torch.Tensor) -> torch.Tensor:
        return self._render_depth(Tcw)[1]


class SceneWorld:
    """Finite textured rectangles with z-buffer occlusion, two-sided Lambertian
    shading from a directional light, per-frame exposure drift, a radial
    vignette and sensor noise, rendered in f32 on `device`.

    Rectangle i has centre o_i, unit in-plane axes u_i, v_i, half extents
    e_i = (eu, ev) and normal n_i = u_i x v_i, and its own texture
    `random_texture(texture_size, texture_size, seed * 977 + 31 i)`; a box
    is 6 rectangles, an infinite plane has half extents 1e6. Every
    rectangle is intersected at every pixel; the hit is the first nearest
    (ties to the lower rectangle), a ray that hits nothing renders as 96.

    Noise, when `noise_std` > 0: Gaussian of that std drawn from a
    `torch.Generator` on `device` seeded with seed * 977 + frame * 2, the
    left image of a stereo pair first, then the right (`MultiPlaneWorld`'s
    rule). The reference draws from `jax.random` under the same seed, which
    cannot be repeated here, so the noise matches in distribution only.
    """

    def __init__(self, cam, rects, texture_size: int = 512, texture_scale: float = 60.0,
                 noise_std: float = 2.0, light_dir=(0.4, -0.8, 0.45), ambient: float = 0.45,
                 diffuse: float = 0.55, exposure_amp: float = 0.12, vignette: float = 0.22,
                 seed: int = 0, device="cpu"):
        """rects: list of (o [3], u [3], v [3], eu, ev)."""
        self.cam = cam
        self.texture_scale = float(texture_scale)
        self.tex_size = texture_size
        self.noise_std = float(noise_std)
        self.ambient = float(ambient)
        self.diffuse = float(diffuse)
        self.exposure_amp = float(exposure_amp)
        self.vignette = float(vignette)
        self._noise_seed = seed
        self.device = torch.device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)  # noqa: E731
        light = np.asarray(light_dir, np.float32)
        self.light = t(light / np.linalg.norm(light))
        o_l, u_l, v_l, n_l, e_l, tex = [], [], [], [], [], []
        for i, (o, u, v, eu, ev) in enumerate(rects):
            u = np.asarray(u, np.float32)
            u = u / np.linalg.norm(u)
            v = np.asarray(v, np.float32)
            v = v / np.linalg.norm(v)
            o_l.append(np.asarray(o, np.float32))
            u_l.append(u)
            v_l.append(v)
            n_l.append(np.cross(u, v).astype(np.float32))
            e_l.append(np.asarray([eu, ev], np.float32))
            tex.append(random_texture(texture_size, texture_size, seed * 977 + 31 * i))
        self.o, self.u, self.v = t(np.stack(o_l)), t(np.stack(u_l)), t(np.stack(v_l))
        self.n, self.e = t(np.stack(n_l)), t(np.stack(e_l))  # [P, 3], [P, 2] half extents
        self.tex = t(np.stack(tex))                          # [P, S, S]
        self.Kinv = torch.linalg.inv(cam.K).to(self.device)

    @staticmethod
    def room_with_boxes(cam, half: float = 14.0, height: float = 3.0, n_boxes: int = 5,
                        box_ring: float = 8.0, seed: int = 0, **kw) -> "SceneWorld":
        """A closed room (4 walls, floor, ceiling) with `n_boxes` textured
        boxes on the floor on a ring of radius ~`box_ring`, placed by
        `np.random.default_rng(seed + 7)`."""
        h, ht = half, height
        inf = 1e6
        rects = [
            ([0.0, 0.0, h], [1, 0, 0], [0, 1, 0], inf, inf),     # front z=+h
            ([0.0, 0.0, -h], [-1, 0, 0], [0, 1, 0], inf, inf),   # back
            ([-h, 0.0, 0.0], [0, 0, 1], [0, 1, 0], inf, inf),    # left
            ([h, 0.0, 0.0], [0, 0, -1], [0, 1, 0], inf, inf),    # right
            ([0.0, ht, 0.0], [1, 0, 0], [0, 0, 1], inf, inf),    # floor
            ([0.0, -ht, 0.0], [1, 0, 0], [0, 0, -1], inf, inf),  # ceiling
        ]
        rng = np.random.default_rng(seed + 7)
        for b in range(n_boxes):
            th = 2 * np.pi * b / n_boxes + rng.uniform(-0.2, 0.2)
            r = box_ring + rng.uniform(-1.0, 1.5)
            cx, cz = r * np.sin(th), r * np.cos(th)
            sx, sy, sz = rng.uniform(0.8, 1.8, 3)
            cy = ht - sy  # resting on the floor (y points down to +ht)
            c, s = np.cos(th), np.sin(th)
            ax = np.array([c, 0, -s], np.float32)
            az = np.array([s, 0, c], np.float32)
            ay = np.array([0.0, 1.0, 0.0], np.float32)
            ctr = np.array([cx, cy, cz], np.float32)
            rects += [
                (ctr + az * sz, ax, ay, sx, sy), (ctr - az * sz, -ax, ay, sx, sy),
                (ctr + ax * sx, -az, ay, sz, sy), (ctr - ax * sx, az, ay, sz, sy),
                (ctr - ay * sy, ax, az, sx, sz), (ctr + ay * sy, ax, -az, sx, sz),
            ]
        return SceneWorld(cam, rects, seed=seed, **kw)

    def _render_depth(self, Tcw: torch.Tensor):
        """(noise-free shaded image [H, W], depth [H, W]) of the view Tcw."""
        Twc = se3.inverse(Tcw.to(self.device, torch.float32))
        R, t = se3.rotation(Twc), se3.translation(Twc)
        h, w = self.cam.height, self.cam.width
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=self.device),
                                torch.arange(w, dtype=torch.float32, device=self.device),
                                indexing="ij")
        rays = torch.einsum("ij,jhw->ihw", self.Kinv, torch.stack([xx, yy, torch.ones_like(xx)]))
        dirs = torch.einsum("ij,jhw->ihw", R, rays)                       # [3, H, W]
        ndotdir = torch.einsum("pi,ihw->phw", self.n, dirs)
        ndoto = (self.n * self.o).sum(dim=1)
        lam = (ndoto - self.n @ t)[:, None, None] / torch.where(
            ndotdir.abs() < 1e-6, torch.full_like(ndotdir, 1e-6), ndotdir)  # [P, H, W]
        rel = t[None, :, None, None] + lam[:, None] * dirs[None] - self.o[:, :, None, None]
        cu = torch.einsum("pi,pihw->phw", self.u, rel)
        cv = torch.einsum("pi,pihw->phw", self.v, rel)
        in_rect = (cu.abs() <= self.e[:, 0, None, None]) & (cv.abs() <= self.e[:, 1, None, None])
        lam = torch.where((lam > 0.05) & in_rect, lam, torch.full_like(lam, float("inf")))
        lam_b, best = lam.min(dim=0)  # the first minimum, as jnp.argmin
        hit = torch.isfinite(lam_b)
        lam_b = torch.where(hit, lam_b, torch.zeros_like(lam_b))
        s, c = self.texture_scale, self.tex_size / 2.0
        b = best[None]
        cu_b, cv_b = torch.gather(cu, 0, b)[0], torch.gather(cv, 0, b)[0]
        # The texture coordinate is cv * s + c rounded once, as the reference's
        # compiled program contracts it (an FMA): off the texture the sample
        # is clamped to its edge texels and jumps at whole coordinates, so
        # a product rounded first would pick the neighbouring edge texel.
        fma = lambda a: (a.to(torch.float64) * s + c).to(torch.float32)  # noqa: E731
        samp = bilinear_sample(self.tex, fma(cv_b), fma(cu_b), plane=best)
        shade = self.ambient + self.diffuse * (self.n @ self.light).abs()  # two-sided
        img = torch.where(hit, samp * shade[best], torch.full_like(samp, 96.0))
        return img, torch.where(hit, lam_b * rays[2], torch.zeros_like(lam_b))

    def _photometric(self, img: torch.Tensor, frame: int, generator=None) -> torch.Tensor:
        """Exposure drift (gain and bias, slow sinusoids of the frame), the
        radial vignette, then one noise draw from `generator` (none when it is
        None or `noise_std` is 0), clipped to [0, 255]."""
        h, w = img.shape
        f = torch.tensor(float(frame), dtype=torch.float32, device=img.device)
        gain = 1.0 + self.exposure_amp * torch.sin(0.07 * f + 0.9)
        bias = 6.0 * torch.sin(0.045 * f)
        yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] / h - 0.5
        xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] / w - 0.5
        vig = 1.0 - self.vignette * 2.0 * (xx * xx + yy * yy)
        img = img * gain * vig + bias
        if self.noise_std > 0 and generator is not None:
            img = img + torch.randn(img.shape, generator=generator, device=img.device) \
                * self.noise_std
        return img.clamp(0.0, 255.0)

    def _generator(self, frame: int):
        return torch.Generator(device=self.device).manual_seed(self._noise_seed * 977 + frame * 2)

    def render(self, Tcw: torch.Tensor, frame: int = 0) -> torch.Tensor:
        return self._photometric(self._render_depth(Tcw)[0], frame, self._generator(frame))

    def render_stereo(self, Tcw: torch.Tensor, frame: int = 0):
        """(left, right); the right camera sits `baseline` along +x."""
        T_rl = se3.from_Rt(torch.eye(3), torch.tensor([-self.cam.baseline, 0.0, 0.0]))
        Tcw = Tcw.to(torch.float32).cpu()
        left, right = (self._render_depth(T)[0] for T in (Tcw, se3.compose(T_rl, Tcw)))
        gen = self._generator(frame)
        return self._photometric(left, frame, gen), self._photometric(right, frame, gen)

    def depth(self, Tcw: torch.Tensor) -> torch.Tensor:
        return self._render_depth(Tcw)[1]
