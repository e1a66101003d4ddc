"""Top-level client facade (port of `corbslam_tpu/system.py`: the
`CorbslamClient` constructor, `track_stereo`, `track_rgbd`,
`track_monocular`, the per-frame metrics lines, `shutdown` and `state`).

One object wiring the tracker (`frontend/tracking.StereoTracker`) and the
loop closer (`loop/loop_closing.LoopCloser`, with global BA when `run_gba`)
on `device` ("cuda" unless the caller asks for "cpu"). A mono client's loop
closer estimates the Sim3's scale (`fix_scale=False`). The collaboration
layer (`transport=`) and the trajectory and map files are not ported yet.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np

from . import kernels
from .config import SlamConfig
from .frontend.tracking import StereoTracker, TrackState
from .geometry import camera as cam_mod
from .loop.loop_closing import LoopCloser
from .place import vocab as vocab_mod


class CorbslamClient:
    """One SLAM client: tracking + local mapping + loop closing + global BA."""

    def __init__(self, cam: cam_mod.Intrinsics, cfg: SlamConfig, sensor: str = "stereo",
                 client_id: int = 1, voc: Optional[vocab_mod.Vocabulary] = None, transport=None,
                 enable_loop_closing: bool = True, run_gba: bool = True,
                 metrics_path: Optional[str] = None, device="cuda"):
        if transport is not None:
            raise NotImplementedError("CorbslamClient(transport=...): the collaboration layer "
                                      "(collab/: client cache, server, transports) is not ported")
        dev = kernels.resolve_device(device)
        self.cam = cam
        self.cfg = cfg
        self.sensor = sensor
        self.client_id = client_id
        self.voc = voc
        self.loop_closer = None
        if enable_loop_closing and voc is not None:
            if voc.words.device.type != dev.type:
                raise ValueError(f"vocabulary on {voc.words.device}, client on {dev}")
            self.loop_closer = LoopCloser(cam, cfg, voc, fix_scale=(sensor != "mono"),
                                          run_gba=run_gba, seed=client_id)
        self.tracker = StereoTracker(cam, cfg, client=client_id, loop_closer=self.loop_closer,
                                     device=dev)
        self._metrics = open(metrics_path, "a") if metrics_path else None

    # ------------------------------------------------------------------
    # Ingest (System::TrackStereo / TrackRGBD / TrackMonocular)
    # ------------------------------------------------------------------

    def track_stereo(self, img_l, img_r, timestamp: float) -> np.ndarray:
        t0 = time.perf_counter()
        pose = self.tracker.process_stereo(img_l, img_r, timestamp)
        self._after_frame(t0, timestamp)
        return pose

    def track_rgbd(self, img, depth, timestamp: float) -> np.ndarray:
        t0 = time.perf_counter()
        pose = self.tracker.process_rgbd(img, depth, timestamp)
        self._after_frame(t0, timestamp)
        return pose

    def track_monocular(self, img, timestamp: float) -> np.ndarray:
        t0 = time.perf_counter()
        pose = self.tracker.process_mono(img, timestamp)
        self._after_frame(t0, timestamp)
        return pose

    def _after_frame(self, t0: float, timestamp: float):
        """One JSON line of metrics per frame to `metrics_path`, if given (the
        state read flushes the tracker's pipeline)."""
        if self._metrics is None:
            return
        tr = self.tracker
        rec = {
            "t": timestamp,
            "frame": tr.stats.n_frames,
            "state": tr.state.name,
            "track_ms": round((time.perf_counter() - t0) * 1e3, 2),
            "n_kf": int(tr.map.n_kf),
            "n_mp": int(tr.map.mp.valid.sum()),
            "inliers": tr.stats.inliers_history[-1] if tr.stats.inliers_history else 0,
        }
        self._metrics.write(json.dumps(rec) + "\n")

    # ------------------------------------------------------------------
    def shutdown(self):
        """Flush the tracker, wait for a running global BA and merge it
        (System::Shutdown)."""
        self.tracker.flush()
        lc = self.loop_closer
        if lc is not None and lc.gba_runner is not None:
            lc.gba_runner.wait()
            self.tracker.map = lc.try_merge_gba(self.tracker.map)
        if self._metrics is not None:
            self._metrics.close()
            self._metrics = None

    @property
    def state(self) -> TrackState:
        return self.tracker.state
