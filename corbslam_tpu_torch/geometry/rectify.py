"""Stereo undistort-rectify maps (EuRoC-style raw fisheye-ish input); a copy
of the JAX-free `corbslam_tpu/geometry/rectify.py`.

Equivalent of the reference's cv::initUndistortRectifyMap + cv::remap use in
`corbslam_client/Examples/Stereo/stereo_euroc.cc` (LEFT/RIGHT K, D, R, P
blocks of `Examples/Stereo/EuRoC.yaml`): raw distorted camera images are
warped once per frame onto the ideal rectified pinhole camera described by
``P`` so that stereo matching can scan horizontal epipolar lines.

Host-side numpy: map construction happens once per sequence, the per-frame
remap is a cheap vectorized bilinear gather on the loader thread (image IO
already lives there), keeping the device program shapes static.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _distort_radtan(D, x, y):
    """Apply (k1, k2, p1, p2[, k3]) radial-tangential distortion to
    normalized coords (same model as geometry.camera.distort)."""
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def rectified_to_raw(K, D, R, P, uv_rect):
    """Map rectified-image pixels [..., 2] to raw-image pixels [..., 2].

    The core of cv::initUndistortRectifyMap: back-project through the
    rectified pinhole ``P``, rotate by R^-1 into the raw camera, distort,
    project by ``K``.
    """
    K = np.asarray(K, np.float64)
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    u, v = uv_rect[..., 0], uv_rect[..., 1]
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    ray = np.stack([x, y, np.ones_like(x)], axis=-1) @ R  # R^T applied rowwise
    xn = ray[..., 0] / ray[..., 2]
    yn = ray[..., 1] / ray[..., 2]
    xd, yd = _distort_radtan(np.asarray(D, np.float64), xn, yn)
    return np.stack(
        [K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], axis=-1
    )


@dataclass
class RectifyMap:
    """Precomputed per-pixel source coordinates for one camera."""

    map_x: np.ndarray  # [H, W] raw-image x for each rectified pixel
    map_y: np.ndarray  # [H, W]

    @staticmethod
    def build(K, D, R, P, width: int, height: int) -> "RectifyMap":
        v, u = np.mgrid[0:height, 0:width].astype(np.float64)
        raw = rectified_to_raw(K, D, R, P, np.stack([u, v], axis=-1))
        return RectifyMap(
            raw[..., 0].astype(np.float32), raw[..., 1].astype(np.float32)
        )

    def remap(self, img: np.ndarray) -> np.ndarray:
        """Bilinear remap (cv::remap INTER_LINEAR, BORDER_CONSTANT(0) as the
        reference's default): out-of-FOV rectified pixels are zero so edge
        texture is not smeared into them (which would spawn spurious stable
        ORB features near borders). Output dtype matches the input."""
        h, w = img.shape[:2]
        inside = (
            (self.map_x >= 0.0) & (self.map_x <= w - 1.0)
            & (self.map_y >= 0.0) & (self.map_y <= h - 1.0)
        )
        x = np.clip(self.map_x, 0.0, w - 1.0)
        y = np.clip(self.map_y, 0.0, h - 1.0)
        x0 = np.floor(x).astype(np.int32)
        y0 = np.floor(y).astype(np.int32)
        x1 = np.minimum(x0 + 1, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        fx = (x - x0).astype(np.float32)
        fy = (y - y0).astype(fx.dtype)
        im = img.astype(fx.dtype, copy=False)
        top = im[y0, x0] * (1 - fx) + im[y0, x1] * fx
        bot = im[y1, x0] * (1 - fx) + im[y1, x1] * fx
        out = np.where(inside, top * (1 - fy) + bot * fy, 0.0)
        if img.dtype.kind in "ui":
            out = np.round(out)
        return out.astype(img.dtype, copy=False)


# ---------------------------------------------------------------------------
# EuRoC MAV calibration (Examples/Stereo/EuRoC.yaml LEFT.*/RIGHT.* blocks —
# camera calibration data, applied here exactly as stereo_euroc.cc does via
# initUndistortRectifyMap).
# ---------------------------------------------------------------------------

EUROC_LEFT_K = np.array(
    [[458.654, 0.0, 367.215], [0.0, 457.296, 248.375], [0.0, 0.0, 1.0]]
)
EUROC_LEFT_D = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
EUROC_LEFT_R = np.array([
    [0.999966347530033, -0.001422739138722922, 0.008079580483432283],
    [0.001365741834644127, 0.9999741760894847, 0.007055629199258132],
    [-0.008089410156878961, -0.007044357138835809, 0.9999424675829176],
])
EUROC_RIGHT_K = np.array(
    [[457.587, 0.0, 379.999], [0.0, 456.134, 255.238], [0.0, 0.0, 1.0]]
)
EUROC_RIGHT_D = np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05])
EUROC_RIGHT_R = np.array([
    [0.9999633526194376, -0.003625811871560086, 0.007755443660172947],
    [0.003680398547259526, 0.9999684752771629, -0.007035845251224894],
    [-0.007729688520722713, 0.007064130529506649, 0.999945173484644],
])
EUROC_P = np.array([
    [435.2046959714599, 0.0, 367.4517211914062],
    [0.0, 435.2046959714599, 252.2008514404297],
    [0.0, 0.0, 1.0],
])
EUROC_WIDTH, EUROC_HEIGHT = 752, 480


def euroc_rectify_maps():
    """(left RectifyMap, right RectifyMap) for the EuRoC stereo rig."""
    left = RectifyMap.build(
        EUROC_LEFT_K, EUROC_LEFT_D, EUROC_LEFT_R, EUROC_P,
        EUROC_WIDTH, EUROC_HEIGHT,
    )
    right = RectifyMap.build(
        EUROC_RIGHT_K, EUROC_RIGHT_D, EUROC_RIGHT_R, EUROC_P,
        EUROC_WIDTH, EUROC_HEIGHT,
    )
    return left, right
