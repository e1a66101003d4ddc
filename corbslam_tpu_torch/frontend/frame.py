"""Per-frame construction: ORB extraction + stereo / RGB-D depth assignment
(port of `corbslam_tpu/frontend/frame.py`).

`build_frame_stereo` runs both images through the ORB kernels as one batch
of two, matches them with the stereo kernel and undistorts the left
keypoints; `build_frame_rgbd` reads a registered depth map at the raw
keypoints (K4's `rgbd_stereo` entry); `build_frame_mono` leaves u_right -1
and depth 0. Inputs are numpy arrays or tensors; `device` defaults to "cuda".
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..config import OrbConfig
from ..geometry import camera as cam_mod
from ..ops import orb, stereo


class FrameData(NamedTuple):
    """Device-resident frame: features + stereo depth + matches + pose."""

    xy: torch.Tensor       # [F, 2] undistorted level-0 coords
    octave: torch.Tensor   # [F]
    angle: torch.Tensor    # [F]
    desc: torch.Tensor     # [F, 32]
    fvalid: torch.Tensor   # [F]
    uright: torch.Tensor   # [F] (-1 mono)
    depth: torch.Tensor    # [F] (0 unknown)
    Tcw: torch.Tensor      # [4, 4] estimated pose
    mp_idx: torch.Tensor   # [F] matched map-point rows (NO_MP = -1)


def scale_tables(cfg: OrbConfig, device="cpu"):
    s = torch.tensor(cfg.scales(), dtype=torch.float32, device=device)
    return s, s * s


def _frame(f: orb.Features, xy_und, uright, depth) -> FrameData:
    F = f.xy.shape[0]
    dev = f.xy.device
    return FrameData(
        xy=xy_und, octave=f.octave, angle=f.angle, desc=f.desc, fvalid=f.valid,
        uright=uright, depth=depth,
        Tcw=torch.eye(4, dtype=torch.float32, device=dev),
        mp_idx=torch.full((F,), -1, dtype=torch.int32, device=dev),
    )


def build_frame_stereo(img_l, img_r, cam: cam_mod.Intrinsics, cfg: OrbConfig,
                       device="cuda") -> FrameData:
    dev = kernels.resolve_device(device)
    imgs = orb.as_images([img_l, img_r], dev)
    _, h, w = imgs.shape
    prm = orb.params(cfg, h, w, str(dev))
    f = orb.extract_batch(imgs, prm)
    fl, fr = f.select(0), f.select(1)
    m = stereo.stereo_match(fl, fr, prm.scales, float(cam.bf))
    return _frame(fl, cam_mod.undistort_points(cam, fl.xy), m.u_right, m.depth)


def build_frame_rgbd(img, depth_map, cam: cam_mod.Intrinsics, cfg: OrbConfig,
                     device="cuda") -> FrameData:
    f = orb.extract(img, cfg, device)
    dmap = orb.as_images([depth_map], f.xy.device)[0]
    xy_und = cam_mod.undistort_points(cam, f.xy)
    r = stereo.compute_stereo_from_rgbd(dmap, f.xy, f.valid, float(cam.bf), xy_und=xy_und)
    return _frame(f, xy_und, r.u_right, r.depth)


def build_frame_mono(img, cam: cam_mod.Intrinsics, cfg: OrbConfig, device="cuda") -> FrameData:
    f = orb.extract(img, cfg, device)
    F = f.xy.shape[0]
    return _frame(
        f, cam_mod.undistort_points(cam, f.xy),
        torch.full((F,), -1.0, dtype=torch.float32, device=f.xy.device),
        torch.zeros(F, dtype=torch.float32, device=f.xy.device),
    )
