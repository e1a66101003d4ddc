"""Dataset drivers: KITTI odometry (stereo/mono), TUM RGB-D, EuRoC MAV (a copy
of `corbslam_tpu/io/datasets.py` over the port's `config`, `camera` and
`rectify`).

Replaces the reference's per-dataset example loaders (ref:
corbslam_client/Examples/Stereo/stereo_kitti.cc:130-176 LoadImages,
stereo_euroc.cc, RGB-D/rgbd_tum.cc association loader, Monocular/
mono_tum.cc / mono_kitti.cc / mono_euroc.cc) plus the per-dataset camera
YAMLs (Examples/Stereo/KITTI00-02.yaml etc., parsed at Tracking.cc:52-146)
— the intrinsics presets below carry the same values.

Loaders read only what is already on disk and yield numpy grayscale
float32 [H, W] images (the client moves them to its device); decoding uses
PIL when available and a built-in PGM/PPM reader otherwise (KITTI ships
pgm/png; environments without PIL can still run the synthetic replays).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config import KITTI_STEREO, TUM_RGBD, SlamConfig
from ..geometry import camera as cam_mod


def _imread_gray(path: str) -> np.ndarray:
    try:
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"), np.float32)
        return img
    except ImportError:
        pass
    if path.endswith((".pgm", ".ppm")):
        return _read_pnm_gray(path)
    raise RuntimeError(f"no decoder available for {path} (PIL missing)")


def _read_pnm_gray(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    parts = data.split(maxsplit=4)
    magic, w, h, maxv = parts[0], int(parts[1]), int(parts[2]), int(parts[3])
    raw = parts[4]
    if magic == b"P5":
        img = np.frombuffer(raw[: w * h], np.uint8).reshape(h, w)
        return img.astype(np.float32)
    if magic == b"P6":
        img = np.frombuffer(raw[: w * h * 3], np.uint8).reshape(h, w, 3)
        return img.astype(np.float32).mean(-1)
    raise RuntimeError(f"unsupported PNM magic {magic!r}")


# ---------------------------------------------------------------------------
# Camera presets (the reference's YAML values)
# ---------------------------------------------------------------------------

def kitti_camera(seq: int = 0) -> cam_mod.Intrinsics:
    """KITTI00-02.yaml (seq 0-2), KITTI03.yaml (3), KITTI04-12.yaml (4+)."""
    if seq <= 2:
        fx, fy, cx, cy, bf = 718.856, 718.856, 607.1928, 185.2157, 386.1448
        w, h = 1241, 376
    elif seq == 3:
        fx, fy, cx, cy, bf = 721.5377, 721.5377, 609.5593, 172.854, 387.5744
        w, h = 1242, 375
    else:
        fx, fy, cx, cy, bf = 707.0912, 707.0912, 601.8873, 183.1104, 379.8145
        w, h = 1226, 370
    return cam_mod.Intrinsics.create(
        fx=fx, fy=fy, cx=cx, cy=cy, bf=bf, width=w, height=h
    )


def tum_camera(freiburg: int = 1) -> cam_mod.Intrinsics:
    """TUM1/2/3.yaml values (intrinsics + radtan distortion, applied by
    the keypoint-undistortion path in frontend/frame.py just as the
    reference does via Frame::UndistortKeyPoints, Frame.cc:408); depth
    factor is 1/5000 on disk."""
    vals = {
        1: (517.306408, 516.469215, 318.643040, 255.313989,
            (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)),
        2: (520.908620, 521.007327, 325.141442, 249.701764,
            (0.231222, -0.784899, -0.003257, -0.000105, 0.917205)),
        3: (535.4, 539.2, 320.1, 247.6, (0.0, 0.0, 0.0, 0.0, 0.0)),
    }[freiburg]
    fx, fy, cx, cy, dist = vals
    return cam_mod.Intrinsics.create(
        fx=fx, fy=fy, cx=cx, cy=cy, bf=fx * 0.08, dist=dist,
        width=640, height=480,
    )


def euroc_camera() -> cam_mod.Intrinsics:
    """EuRoC.yaml rectified pinhole (valid for images remapped through
    geometry.rectify.euroc_rectify_maps — load_euroc_stereo does this)."""
    return cam_mod.Intrinsics.create(
        fx=435.2046959714599, fy=435.2046959714599,
        cx=367.4517211914062, cy=252.2008514404297,
        bf=435.2046959714599 * 0.110074, width=752, height=480,
    )


# ---------------------------------------------------------------------------
# Sequence loaders
# ---------------------------------------------------------------------------

@dataclass
class StereoFrame:
    timestamp: float
    left_path: str
    right_path: str
    rectify: Optional[tuple] = None  # (left RectifyMap, right RectifyMap)

    def load(self):
        l, r = _imread_gray(self.left_path), _imread_gray(self.right_path)
        if self.rectify is not None and l.shape == self.rectify[0].map_x.shape:
            # Rectify only when the image matches the calibration geometry
            # (raw EuRoC frames are 480x752, same as the rectified rig);
            # other sizes pass through untouched.
            l = self.rectify[0].remap(l)
            r = self.rectify[1].remap(r)
        return l, r


@dataclass
class RgbdFrame:
    timestamp: float
    rgb_path: str
    depth_path: str
    depth_factor: float = 5000.0

    def load(self):
        rgb = _imread_gray(self.rgb_path)
        try:
            from PIL import Image

            d = np.asarray(Image.open(self.depth_path), np.float32)
        except ImportError:
            d = _read_pnm_gray(self.depth_path)
        return rgb, d / self.depth_factor


def load_kitti_stereo(root: str, seq: int) -> List[StereoFrame]:
    """sequences/NN/{image_0,image_1,times.txt} (stereo_kitti.cc:130)."""
    sdir = os.path.join(root, "sequences", f"{seq:02d}")
    times = np.loadtxt(os.path.join(sdir, "times.txt"))
    left = sorted(os.listdir(os.path.join(sdir, "image_0")))
    out = []
    for i, name in enumerate(left):
        out.append(StereoFrame(
            float(times[i]),
            os.path.join(sdir, "image_0", name),
            os.path.join(sdir, "image_1", name),
        ))
    return out


def load_tum_rgbd(root: str, max_dt: float = 0.02) -> List[RgbdFrame]:
    """rgb.txt/depth.txt timestamp association (rgbd_tum.cc LoadImages +
    associate.py convention)."""

    def read_list(name):
        entries = []
        with open(os.path.join(root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, path = line.split()[:2]
                entries.append((float(t), os.path.join(root, path)))
        return entries

    rgb = read_list("rgb.txt")
    depth = read_list("depth.txt")
    dt = np.asarray([t for t, _ in depth])
    out = []
    for t, rp in rgb:
        j = int(np.argmin(np.abs(dt - t)))
        if abs(dt[j] - t) <= max_dt:
            out.append(RgbdFrame(t, rp, depth[j][1]))
    return out


def load_euroc_stereo(root: str, rectify: bool = True) -> List[StereoFrame]:
    """mav0/cam{0,1}/data + data.csv (stereo_euroc.cc LoadImages).

    EuRoC ships RAW distorted, unrectified images; by default every frame
    is remapped onto the rectified pinhole rig of `euroc_camera()` at load
    time — the reference's initUndistortRectifyMap + remap per frame
    (stereo_euroc.cc)."""
    from ..geometry import rectify as rect_mod

    maps = rect_mod.euroc_rectify_maps() if rectify else None
    cam0 = os.path.join(root, "mav0", "cam0")
    cam1 = os.path.join(root, "mav0", "cam1")
    out = []
    with open(os.path.join(cam0, "data.csv")) as f:
        for row in csv.reader(f):
            if row[0].startswith("#"):
                continue
            ts_ns, name = row[0], row[1].strip()
            lp = os.path.join(cam0, "data", name)
            rp = os.path.join(cam1, "data", name)
            if os.path.exists(lp) and os.path.exists(rp):
                out.append(
                    StereoFrame(float(ts_ns) * 1e-9, lp, rp, rectify=maps)
                )
    return out


def config_for(dataset: str) -> SlamConfig:
    return {"kitti": KITTI_STEREO, "tum": TUM_RGBD, "euroc": KITTI_STEREO}[dataset]
