"""Top-level client facade (port of `corbslam_tpu/system.py`: the
`CorbslamClient` constructor, `track_stereo`, `track_rgbd`,
`track_monocular`, the per-frame metrics lines and sync cadence, `shutdown`
and `state`).

One object wiring the tracker (`frontend/tracking.StereoTracker`), the
loop closer (`loop/loop_closing.LoopCloser`, with global BA when `run_gba`)
and, with `transport=`, the collaboration cache (`collab/client_cache`,
uplink on a worker thread) on `device` ("cuda" unless the caller asks for
"cpu"). A mono client's loop closer estimates the Sim3's scale
(`fix_scale=False`). The trajectory and map files are not ported yet.
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
    """One SLAM client: tracking + local mapping + loop closing + global BA
    + (optionally) collaboration with a fusion server."""

    def __init__(self, cam: cam_mod.Intrinsics, cfg: SlamConfig, sensor: str = "stereo",
                 client_id: int = 1, voc: Optional[vocab_mod.Vocabulary] = None, transport=None,
                 enable_loop_closing: bool = True, run_gba: bool = True,
                 metrics_path: Optional[str] = None, device="cuda"):
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
        self.cache = None
        if transport is not None:
            from .collab.client_cache import ClientCache

            # The cache registers its compaction and reset hooks with the
            # tracker, so compaction stays on under collaboration.
            self.cache = ClientCache(self.tracker, transport, client_id, cfg,
                                     loop_closer=self.loop_closer)
            self.cache.start_async_uplink()
        # Sync cadence in frames (the reference syncs on wall-clock: 6 s
        # uplink Cache.cc:370, 2 s downlink poll; at the 10 fps replay rate
        # that is 60 / 20 frames).
        self.uplink_every = 60
        self.downlink_every = 20
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
        """The sync cadence (downlink, then an uplink handed to the worker:
        tracking never waits for the server's ACK), then one JSON line of
        metrics per frame to `metrics_path`, if given (the state read
        flushes the tracker's pipeline)."""
        tr = self.tracker
        if self.cache is not None:
            n = tr.stats.n_frames
            if n % self.downlink_every == 0:
                self.cache.downlink_step()
            if n % self.uplink_every == 0:
                self.cache.request_uplink()
        if self._metrics is None:
            return
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
        """Flush the tracker, drain the uplink worker and make the final
        push and pull, wait for a running global BA and merge it
        (System::Shutdown)."""
        self.tracker.flush()
        if self.cache is not None:
            self.cache.stop_async_uplink()
            # The final push must land: the server may be busy fusing, so
            # retry with a growing pause until it is acknowledged.
            for attempt in range(5):
                if self.cache.uplink_step():
                    break
                time.sleep(0.5 * (attempt + 1))
            self.cache.downlink_step()
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
