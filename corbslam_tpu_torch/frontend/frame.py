"""Per-frame construction: ORB extraction + stereo / RGB-D depth assignment
(port of `corbslam_tpu/frontend/frame.py`).

`build_frame_stereo` runs both images through the ORB kernels as one batch
of two and matches them with the stereo kernel; `build_frame_rgbd` reads a
registered depth map at the raw keypoints; `build_frame_mono` leaves
u_right -1 and depth 0. Each finishes its keypoints with one call of
`stereo.finish_keypoints` (undistortion, and the RGB-D depth read or the
mono fill): one launch of K4's `finish_keypoints` entry on the card. Inputs
are numpy arrays or tensors; `device` defaults to "cuda".
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
    return _frame(fl, stereo.finish_keypoints(cam, fl.xy).xy_und, m.u_right, m.depth)


def build_frame_rgbd(img, depth_map, cam: cam_mod.Intrinsics, cfg: OrbConfig,
                     device="cuda") -> FrameData:
    f = orb.extract(img, cfg, device)
    dmap = orb.as_images([depth_map], f.xy.device)[0]
    r = stereo.finish_keypoints(cam, f.xy, f.valid, dmap, mode="rgbd")
    return _frame(f, r.xy_und, r.u_right, r.depth)


def build_frame_mono(img, cam: cam_mod.Intrinsics, cfg: OrbConfig, device="cuda") -> FrameData:
    f = orb.extract(img, cfg, device)
    r = stereo.finish_keypoints(cam, f.xy, mode="mono")
    return _frame(f, r.xy_und, r.u_right, r.depth)
