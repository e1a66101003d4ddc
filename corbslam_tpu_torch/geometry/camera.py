"""Pinhole camera model (port of `corbslam_tpu/geometry/camera.py`: projection,
undistortion and the frustum test; triangulation comes with local mapping).

`u` runs along columns (x), `v` along rows (y), origin at the top-left
pixel centre. Operations keep the reference's order: `(u - cx) / fx * fx + cx`
is not exact in f32, so a reordered form would move every keypoint.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3


class Intrinsics(NamedTuple):
    """Pinhole + radial-tangential distortion + stereo baseline.

    `bf` is baseline * fx in pixels (0 for mono); `dist` is (k1, k2, p1, p2,
    k3), zeros for rectified input. Plain Python floats."""

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    dist: tuple  # (k1, k2, p1, p2, k3)
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, bf=0.0, dist=None, width=1241, height=376):
        return Intrinsics(
            float(fx), float(fy), float(cx), float(cy), float(bf),
            (0.0,) * 5 if dist is None else tuple(float(d) for d in dist),
            int(width), int(height),
        )

    @property
    def baseline(self):
        return self.bf / self.fx

    @property
    def K(self):
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )


def project(cam: Intrinsics, p_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (no distortion)."""
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * p_cam[..., 0] * inv_z + cam.cx
    v = cam.fy * p_cam[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: Intrinsics, p_cam: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3] = (u, v, u_right) with u_right = u - bf/z."""
    uv = project(cam, p_cam)
    z = p_cam[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    ur = uv[..., 0] - cam.bf * inv_z
    return torch.cat([uv, ur[..., None]], dim=-1)


def backproject(cam: Intrinsics, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] + depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def _distort_xy(cam: Intrinsics, x: torch.Tensor, y: torch.Tensor):
    k1, k2, p1, p2, k3 = cam.dist
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def distort(cam: Intrinsics, uv_norm: torch.Tensor) -> torch.Tensor:
    """Apply radial-tangential distortion to normalized coords [..., 2]."""
    return torch.stack(_distort_xy(cam, uv_norm[..., 0], uv_norm[..., 1]), dim=-1)


def undistort_points(cam: Intrinsics, uv: torch.Tensor, iters: int = 5) -> torch.Tensor:
    """Undistort pixel coords by fixed-point iteration (batched), in the
    reference's order of operations."""
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy
    x, y = x0, y0
    for _ in range(iters):
        xd, yd = _distort_xy(cam, x, y)
        x, y = x0 - (xd - x), y0 - (yd - y)
    u = x * cam.fx + cam.cx
    v = y * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def in_image(cam: Intrinsics, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    return (
        (uv[..., 0] >= margin)
        & (uv[..., 0] < cam.width - margin)
        & (uv[..., 1] >= margin)
        & (uv[..., 1] < cam.height - margin)
    )


def world_to_cam(Tcw: torch.Tensor, p_world: torch.Tensor) -> torch.Tensor:
    return se3.transform(Tcw, p_world)


def cam_to_world(Tcw: torch.Tensor, p_cam: torch.Tensor) -> torch.Tensor:
    return se3.transform(se3.inverse(Tcw), p_cam)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length of [..., 3] as sqrt((x*x + y*y) + z*z)."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def in_frustum(cam: Intrinsics, Tcw: torch.Tensor, p_world: torch.Tensor,
               min_dist: torch.Tensor, max_dist: torch.Tensor, normal: torch.Tensor,
               view_cos_limit: float = 0.5):
    """Batched `Frame::isInFrustum`: positive depth, inside the image, inside
    the scale-distance band, viewing angle within the limit of the point's
    mean normal. Returns (visible [...], uv [..., 2], inv_z [...],
    view_cos [...], dist [...]). The local-map kernel (`csrc/local_map.cu`)
    evaluates the same operations in the same order."""
    p_cam = world_to_cam(Tcw, p_world)
    z = p_cam[..., 2]
    uv = project(cam, p_cam)
    po = p_world - se3.translation(se3.inverse(Tcw))
    dist = norm3(po)
    view_cos = (po[..., 0] * normal[..., 0] + po[..., 1] * normal[..., 1]
                + po[..., 2] * normal[..., 2]) / dist.clamp_min(1e-9)
    ok = ((z > 0.0) & in_image(cam, uv) & (dist >= min_dist) & (dist <= max_dist)
          & (view_cos > view_cos_limit))
    inv_z = 1.0 / z.clamp_min(1e-9)
    return ok, uv, inv_z, view_cos, dist


def solve3x3(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cramer's-rule solve of batched 3x3 systems G x = b (the reference's
    elementwise form; PnP's polar step inverts with it)."""
    g = [[G[..., i, j] for j in range(3)] for i in range(3)]
    c00 = g[1][1] * g[2][2] - g[1][2] * g[2][1]
    c01 = g[1][2] * g[2][0] - g[1][0] * g[2][2]
    c02 = g[1][0] * g[2][1] - g[1][1] * g[2][0]
    det = g[0][0] * c00 + g[0][1] * c01 + g[0][2] * c02
    inv_det = 1.0 / torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    c10 = g[0][2] * g[2][1] - g[0][1] * g[2][2]
    c11 = g[0][0] * g[2][2] - g[0][2] * g[2][0]
    c12 = g[0][1] * g[2][0] - g[0][0] * g[2][1]
    c20 = g[0][1] * g[1][2] - g[0][2] * g[1][1]
    c21 = g[0][2] * g[1][0] - g[0][0] * g[1][2]
    c22 = g[0][0] * g[1][1] - g[0][1] * g[1][0]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(c00 * b0 + c10 * b1 + c20 * b2) * inv_det,
                        (c01 * b0 + c11 * b1 + c21 * b2) * inv_det,
                        (c02 * b0 + c12 * b1 + c22 * b2) * inv_det], dim=-1)
