"""Top-level client facade (port of `corbslam_tpu/system.py`: the
`CorbslamClient` constructor, `track_stereo`, `track_rgbd`,
`track_monocular`, the per-frame metrics lines and sync cadence, `shutdown`,
`state`, the trajectory exports and the map checkpoint).

One object wiring the tracker (`frontend/tracking.StereoTracker`), the
loop closer (`loop/loop_closing.LoopCloser`, with global BA when `run_gba`)
and, with `transport=`, the collaboration cache (`collab/client_cache`,
uplink on a worker thread) on `device` ("cuda" unless the caller asks for
"cpu"). A mono client's loop closer estimates the Sim3's scale
(`fix_scale=False`).

The map checkpoint is the reference's npz key for key (`kf_<field>`,
`mp_<field>`, `n_kf`, `n_mp`, and with a loop closer `db_bow`, `db_valid`,
`voc_bits`, `voc_idf`), so a map saved by either package loads in the
other. `voc_bits` holds the vocabulary's centres unpacked to 0/1 in the
reference's bit order (bit i of a word meets bit i of a descriptor unpacked
LSB-first); the port keeps them packed, so they are unpacked when written.
Like the reference, `load_map` restores no vocabulary.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np

from . import kernels
import torch

from .config import SlamConfig
from .frontend.tracking import StereoTracker, TrackState
from .geometry import camera as cam_mod
from .geometry import se3
from .io import trajectory as traj_mod
from .loop.loop_closing import LoopCloser
from .mapstate import mapstate as ms
from .ops import descriptors as D
from .place import vocab as vocab_mod
from .place.database import BowDatabase


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

    # ------------------------------------------------------------------
    # Trajectory export (SaveTrajectory*, System.cc:254-403)
    # ------------------------------------------------------------------

    def save_trajectory_kitti(self, path: str):
        traj_mod.save_kitti(path, self.tracker.trajectory_kitti())

    def save_trajectory_tum(self, path: str):
        ts = [t for t, _ in self.tracker.trajectory]
        Twc = [se3.inverse(torch.from_numpy(np.asarray(T, np.float32))).numpy()
               for _, T in self.tracker.trajectory]
        traj_mod.save_tum(path, ts, Twc, _quat)

    def save_keyframe_trajectory_tum(self, path: str):
        m = self.tracker.map
        rows = torch.nonzero(m.kf.valid).flatten()
        ts = m.kf.timestamp[rows].cpu().numpy()
        Twc = se3.inverse(m.kf.Tcw[rows]).cpu().numpy()
        traj_mod.save_tum(path, ts.tolist(), Twc, _quat)

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------

    def save_map(self, path: str):
        """The whole map (and the keyframe database) to one npz."""
        m = self.tracker.map
        arrays = {f"kf_{k}": v.cpu().numpy() for k, v in m.kf._asdict().items()}
        arrays.update({f"mp_{k}": v.cpu().numpy() for k, v in m.mp._asdict().items()})
        arrays["n_kf"] = m.n_kf.cpu().numpy()
        arrays["n_mp"] = m.n_mp.cpu().numpy()
        if self.loop_closer is not None:
            arrays["db_bow"] = self.loop_closer.db.bow.cpu().numpy()
            arrays["db_valid"] = self.loop_closer.db.valid.cpu().numpy()
            arrays["voc_bits"] = D.unpack_bits(self.voc.words).cpu().numpy()
            arrays["voc_idf"] = self.voc.idf.cpu().numpy()
        np.savez_compressed(path, **arrays)

    def load_map(self, path: str):
        """Replace the map (and the keyframe database) by a saved one on the
        client's device; the next frame relocalizes into it."""
        tr = self.tracker
        dev = tr.device
        data = np.load(path)
        t = lambda k: torch.from_numpy(np.array(data[k])).to(dev)  # noqa: E731
        kf = ms.KeyFrames(*(t(f"kf_{k}") for k in ms.KeyFrames._fields))
        mp = ms.MapPoints(*(t(f"mp_{k}") for k in ms.MapPoints._fields))
        tr.map = ms.MapState(kf, mp, t("n_kf").to(torch.int32), t("n_mp").to(torch.int32))
        if self.loop_closer is not None and "db_bow" in data:
            self.loop_closer.db = BowDatabase(t("db_bow"), t("db_valid"))
        # Resume allocation after the loaded rows.
        n_kf = int(data["n_kf"])
        tr.ref_kf = max(n_kf - 1, 0)
        tr._ref_kf_dev = torch.tensor(tr.ref_kf, dtype=torch.int32, device=dev)
        tr._kf_cursor_est = n_kf
        tr.state = TrackState.LOST  # relocalize into the loaded map


def _quat(R) -> np.ndarray:
    """(w, x, y, z) of a numpy rotation, by `se3.quat_from_R` in f32."""
    return se3.quat_from_R(torch.from_numpy(np.asarray(R, np.float32))).numpy()
