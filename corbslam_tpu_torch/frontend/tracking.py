"""Host-side tracking state machine (port of
`corbslam_tpu/frontend/tracking.py`: `TrackState`, `TrackerStats`,
`StereoTracker` with its stereo, RGB-D and monocular paths).

The control-flow half of the reference's Tracking thread (Tracking.cc:266
Track, :414 OK / LOST, :995 NeedNewKeyFrame) and of its LocalMapping thread:
a host object that sequences the device steps of `frontend/track_ops.py`
and `mapping/local_mapping.py` and branches only on small summaries.

- NOT_INITIALIZED: stereo / RGB-D initialization seeds the map at the first
  frame with >= 100 depth features. Mono holds a reference frame, matches
  each later frame to it (`search_for_initialization`), runs the two-view
  bootstrap (`solvers/initializer.py`, K12) with a sample from the
  tracker's generator, scales the map to unit median depth, inserts both
  frames as keyframes with the triangulated points and runs the two-view
  local BA (K8); a failed bootstrap keeps or replaces the reference frame.
- OK: the fused step `track_frame_stereo` (two frames per call with
  `frames_per_dispatch=2`; one frame per call for RGB-D and mono,
  `track_frame_rgbd` / `track_frame_mono`) is dispatched at once and retired
  `pipeline_depth` frames later, when its 24-float summary (read through a
  non-blocking copy into pinned memory and an event) drives the state, the
  trajectory and the keyframe policy. A keyframe made at retire time is built
  from that frame's own tracked state.
- LOST: with <= 5 keyframes a hard reset; with a loop closer attached,
  relocalization against its keyframe database (`frontend/reloc.py`) is the
  only way back; without one, re-acquisition through the separate programs
  (`track_motion_model`, `track_reference_kf`, `track_local_map`,
  `update_tracking_stats`).
- Mapping: each keyframe queues its stages (mono first triangulates new
  points with its covisible keyframes, `mapping/triangulation.py`, K5's
  band mode and K13;
  fuse; point cull and geometry
  refresh on every second keyframe; the split local BA from the third;
  keyframe cull on every third after the fifth; the full sweep on every
  sixth); one stage runs per frame, more while more than 4 wait; `flush`
  drains all. With a loop closer (`loop/loop_closing.LoopCloser`) every
  keyframe also queues its loop-closing stage; the keyframe cull drops culled
  rows from the database and a compaction remaps it; a finished global BA is
  merged into the map before the next frame is tracked. A split local BA
  whose window was built before a `map_epoch` bump (loop correction, global
  BA merge, compaction, reset) does not write back. Mono drains the whole
  queue at each keyframe (triangulation is its only source of points), culls
  points with 2 observations instead of 3, and asks for a keyframe below
  `kf_ref_ratio_mono` of the tracked count.

The map is updated in place where the reference donates it (see
`mapstate.mapstate`); a global BA merge replaces its pose and position
tables. Mono takes a loop closer made with `fix_scale=False` (free-scale
Sim3), as `system.CorbslamClient` makes it.
"""

from __future__ import annotations

import sys
from collections import Counter, deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapping import local_mapping, triangulation
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..optim import ba_dense
from ..solvers import initializer, pnp
from . import frame as frame_mod
from . import track_ops


class TrackState(Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


@dataclass
class TrackerStats:
    n_frames: int = 0
    n_keyframes: int = 0
    n_relocalizations: int = 0
    n_resets: int = 0
    n_compactions: int = 0
    inliers_history: list = field(default_factory=list)
    # Mapping stages run, by kind (triangulate, fuse, cull_points, refresh,
    # ba_build, ba_a, ba_b, cull_keyframes, sweep, loop_closing); not in the
    # reference's stats.
    stages: Counter = field(default_factory=Counter)


class StereoTracker:
    """Single-client stereo tracking + local mapping pipeline on `device`
    ("cuda" unless the caller asks for "cpu")."""

    def __init__(self, cam: cam_mod.Intrinsics, cfg: SlamConfig, client: int = 0,
                 loop_closer=None, device="cuda"):
        self.device = kernels.resolve_device(device)
        dev = self.device
        self.cam = cam
        self.cfg = cfg
        self.client = client
        self.loop_closer = loop_closer  # loop.loop_closing.LoopCloser or None
        if loop_closer is not None and loop_closer.device.type != dev.type:
            raise ValueError(f"loop closer on {loop_closer.device}, tracker on {dev}")
        # Relocalization's PnP (K10) and the mono bootstrap (K12) take every
        # feature of a frame in one CTA's shared memory.
        pnp.check_capacity(cfg.orb.n_features, dev)
        initializer.check_capacity(cfg.orb.n_features, dev)
        # The RANSAC draws of relocalization and of the mono two-view
        # bootstrap (the reference splits both from PRNGKey(client + 17)).
        self._gen = torch.Generator(device=dev).manual_seed(client + 17)
        self.map = ms.empty(cfg.capacity, dev)
        self._state = TrackState.NOT_INITIALIZED
        self.last_frame: Optional[frame_mod.FrameData] = None
        self.velocity = torch.eye(4, device=dev)
        self.last_kf_frame_id = 0
        self.frame_id = 0
        self.ref_kf = 0
        self._ref_kf_dev = torch.zeros((), dtype=torch.int32, device=dev)
        self._pending: deque = deque()   # dispatched frames not retired yet
        self._pair_buf: list = []        # frames_per_dispatch=2 buffer
        self._stage_q: deque = deque()   # (kind, callable) mapping stages
        self.ref_obs = 0
        self.scales = torch.tensor(cfg.orb.scales(), dtype=torch.float32, device=dev)
        self._traj: list = []            # (timestamp, Tcw numpy [4, 4])
        self._frame_states: list = []
        self.stats = TrackerStats()
        self.on_compact: list = []
        self.on_reset: list = []
        # Bumped when keyframe poses move outside the local-BA stages: a split
        # local BA built before the bump aborts its writeback (mbAbortBA).
        self.map_epoch = 0
        self._kf_cursor_est = 0  # host mirror of the device keyframe cursor
        self._compact_cooldown = 0
        self._warned_kf_full = False
        K1 = cfg.capacity.local_window_kfs
        self._local_rows = torch.zeros(K1, dtype=torch.int32, device=dev)
        self._local_ok = torch.zeros(K1, dtype=torch.bool, device=dev)
        self.sensor = "stereo"
        self._init_ref: Optional[frame_mod.FrameData] = None  # mono bootstrap reference

    # ------------------------------------------------------------------
    # External views flush the pipeline first.
    # ------------------------------------------------------------------
    @property
    def state(self) -> TrackState:
        self.flush()
        return self._state

    @state.setter
    def state(self, v):
        self._state = v

    @property
    def trajectory(self) -> list:
        self.flush()
        return self._traj

    @property
    def frame_states(self) -> list:
        self.flush()
        return self._frame_states

    # ------------------------------------------------------------------
    def process_stereo(self, img_l, img_r, timestamp: float):
        self.sensor = "stereo"
        return self._process((img_l, img_r), timestamp)

    def process_rgbd(self, img, depth_map, timestamp: float):
        """RGB-D ingest: a gray image and its registered depth map."""
        self.sensor = "rgbd"
        return self._process((img, depth_map), timestamp)

    def process_mono(self, img, timestamp: float):
        """Monocular ingest (System::TrackMonocular, System.cc:185)."""
        self.sensor = "mono"
        return self._process((img,), timestamp)

    def _process(self, images, timestamp: float):
        if self._state == TrackState.OK:
            return self._dispatch_fused(images, timestamp)
        self.flush()  # the in-flight frames decide the real state
        if self._state == TrackState.OK:
            return self._dispatch_fused(images, timestamp)
        cam, orb_cfg, dev = self.cam, self.cfg.orb, self.device
        if self.sensor == "stereo":
            cur = frame_mod.build_frame_stereo(images[0], images[1], cam, orb_cfg, device=dev)
        elif self.sensor == "rgbd":
            cur = frame_mod.build_frame_rgbd(images[0], images[1], cam, orb_cfg, device=dev)
        else:
            cur = frame_mod.build_frame_mono(images[0], cam, orb_cfg, device=dev)
        return self._track(cur, timestamp)

    # ------------------------------------------------------------------
    # Pipelined OK-state path.
    # ------------------------------------------------------------------
    def _read_summary_later(self, summary: torch.Tensor):
        """Start the device-to-host copy of a summary now; returns what
        `_summary_numpy` needs to read it without waiting on later work."""
        if not summary.is_cuda:
            return summary, None
        host = torch.empty(summary.shape, dtype=summary.dtype, pin_memory=True)
        host.copy_(summary, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _summary_numpy(handle) -> np.ndarray:
        host, ev = handle
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    def _advance(self, out):
        self.map = out.map
        self.last_frame = out.cur
        self.velocity = out.velocity
        self._local_rows = out.local_rows
        self._local_ok = out.local_ok
        self._ref_kf_dev = out.ref_kf

    def _dispatch_fused(self, images, timestamp: float):
        if (self.frame_id >= self._compact_cooldown
                and self._kf_cursor_est >= int(0.85 * self.cfg.capacity.max_keyframes)):
            self.flush()
            self._compact_map()
        self._merge_gba()
        # Amortized local mapping: one stage per frame, more while the
        # backlog exceeds 4.
        if self._stage_q:
            self._run_stage()
            while len(self._stage_q) > 4:
                self._run_stage()
        kw = dict(ref_kf=self._ref_kf_dev, prev_local_rows=self._local_rows,
                  prev_local_ok=self._local_ok, cam=self.cam, cfg=self.cfg, device=self.device)
        if self.sensor != "stereo":  # one frame per dispatch
            step = (track_ops.track_frame_rgbd if self.sensor == "rgbd"
                    else track_ops.track_frame_mono)
            out = step(self.map, self.last_frame, self.velocity, *images, **kw)
            outs = ((out, timestamp),)
        elif self.cfg.tracking.frames_per_dispatch >= 2:
            self._pair_buf.append((images, timestamp))
            if len(self._pair_buf) < 2:
                return self.current_pose()
            (im0, t0), (im1, t1) = self._pair_buf
            self._pair_buf.clear()
            o0, o1 = track_ops.track_frame_stereo2(self.map, self.last_frame, self.velocity,
                                                   im0[0], im0[1], im1[0], im1[1], **kw)
            outs = ((o0, t0), (o1, t1))
        else:
            out = track_ops.track_frame_stereo(self.map, self.last_frame, self.velocity,
                                               images[0], images[1], **kw)
            outs = ((out, timestamp),)
        self._advance(outs[-1][0])
        for o, ts in outs:
            self._pending.append((o, ts, self.frame_id, self._read_summary_later(o.summary)))
            self.frame_id += 1
        while len(self._pending) > self.cfg.tracking.pipeline_depth:
            self._retire(*self._pending.popleft())
        return self.current_pose()

    def flush(self):
        """Retire every in-flight frame and drain the mapping stages."""
        if self._pair_buf:
            (im, ts), = self._pair_buf  # odd last frame: the one-frame step
            self._pair_buf.clear()
            out = track_ops.track_frame_stereo(
                self.map, self.last_frame, self.velocity, im[0], im[1], ref_kf=self._ref_kf_dev,
                prev_local_rows=self._local_rows, prev_local_ok=self._local_ok, cam=self.cam,
                cfg=self.cfg, device=self.device)
            self._advance(out)
            self._pending.append((out, ts, self.frame_id, self._read_summary_later(out.summary)))
            self.frame_id += 1
        while self._pending:
            self._retire(*self._pending.popleft())
        while self._stage_q:
            self._run_stage()

    def _retire(self, out, timestamp: float, fid: int, handle):
        """Consume a fused frame's summary: state, trajectory, keyframe policy."""
        s = self._summary_numpy(handle)
        n_track, n_local = int(s[0]), int(s[2])
        self._traj.append((timestamp, s[8:24].reshape(4, 4).copy()))
        self.stats.n_frames += 1
        if (n_track < self.cfg.tracking.min_inliers_motion
                or n_local < self.cfg.tracking.min_tracked_points // 2):
            self._state = TrackState.LOST
            self._frame_states.append(self._state)
            if self._kf_cursor_est <= 5:  # lost soon after init: hard reset
                self.reset()
            return
        self._state = TrackState.OK
        self.ref_kf = int(s[3])
        if self._need_new_keyframe(out.cur, n_local, int(s[4]), int(s[5]), fid=fid):
            self._create_keyframe(out.cur, timestamp, n_local, fid=fid)
        self._frame_states.append(self._state)
        self.stats.inliers_history.append(n_local)

    # ------------------------------------------------------------------
    def _track(self, cur: frame_mod.FrameData, timestamp: float):
        if self.state == TrackState.NOT_INITIALIZED:
            if self.sensor == "mono":
                self._initialize_mono(cur, timestamp)
            else:
                self._initialize(cur, timestamp)
            return self.current_pose()
        if self.state == TrackState.LOST:
            if self._kf_cursor_est <= 5:
                self.reset()  # nothing worth relocalizing against (Tracking.cc:470-478)
                return self._track(cur, timestamp)
            if self._try_relocalize(cur, timestamp):
                return self.current_pose()
            if self.loop_closer is not None:
                # Relocalization is the only way back (Tracking.cc:414-417).
                self._finish_frame(cur, timestamp, lost=True)
                return self.current_pose()
        self._merge_gba()
        # Motion-model re-acquisition from the last pose (without a keyframe
        # database), the reference keyframe as its fallback.
        cfgt = self.cfg.tracking
        T_pred = se3.compose(self.velocity, self.last_frame.Tcw)
        Tcw, mp_idx, n_inl = track_ops.track_motion_model(
            self.cam, self.map.mp.pos, self.last_frame, cur, T_pred, self.scales,
            radius=self.cfg.matcher.search_radius_motion)
        n_inl = int(n_inl)
        if n_inl < cfgt.min_inliers_motion:
            Tcw, mp_idx, n_inl = track_ops.track_reference_kf(self.cam, self.map, self.ref_kf, cur,
                                                              self.last_frame.Tcw)
            n_inl = int(n_inl)
        if n_inl < cfgt.min_inliers_motion:
            self.state = TrackState.LOST
            self._finish_frame(cur._replace(Tcw=Tcw, mp_idx=mp_idx), timestamp, lost=True)
            return self.current_pose()
        res = track_ops.track_local_map(self.cam, self.map, cur, Tcw, mp_idx, self.cfg)
        n_local = int(res.n_inliers)
        cur = cur._replace(Tcw=res.Tcw, mp_idx=res.mp_idx)
        self.ref_kf = int(res.ref_kf)
        self._ref_kf_dev = torch.tensor(self.ref_kf, dtype=torch.int32, device=self.device)
        self.map = track_ops.update_tracking_stats(self.map, res.visible_rows, res.visible_mask,
                                                   res.found_rows_mask)
        if n_local < cfgt.min_tracked_points // 2:
            self.state = TrackState.LOST
            self._finish_frame(cur, timestamp, lost=True)
            return self.current_pose()
        self.state = TrackState.OK
        close = (cur.depth > 0.01) & (cur.depth < cfgt.th_depth * self.cam.baseline) & cur.fvalid
        if self._need_new_keyframe(cur, n_local, int((close & (cur.mp_idx >= 0)).sum()),
                                   int((close & (cur.mp_idx < 0)).sum())):
            self._create_keyframe(cur, timestamp, n_local)
        self._finish_frame(cur, timestamp)
        self.stats.inliers_history.append(n_local)
        return self.current_pose()

    def _merge_gba(self):
        """Fold in a finished global BA (the loop closer returns the same map
        when none is waiting); a merge moves poses, so the epoch moves."""
        if self.loop_closer is not None:
            m2 = self.loop_closer.try_merge_gba(self.map)
            if m2 is not self.map:
                self.map_epoch += 1
                self.map = m2

    def _try_relocalize(self, cur: frame_mod.FrameData, timestamp: float) -> bool:
        """Relocalization (Tracking.cc:1368) through the loop closer's
        keyframe database, consolidated by a local-map tracking pass."""
        if self.loop_closer is None:
            return False
        from . import reloc as reloc_mod

        lc = self.loop_closer
        res = reloc_mod.relocalize(self.cam, self.map, lc.db, lc.voc, cur, self.cfg,
                                   generator=self._gen)
        if res is None:
            return False
        out = track_ops.track_local_map(self.cam, self.map, cur, res.Tcw, res.mp_idx, self.cfg)
        if int(out.n_inliers) < self.cfg.tracking.min_tracked_points:
            return False
        cur = cur._replace(Tcw=out.Tcw, mp_idx=out.mp_idx)
        self.ref_kf = int(out.ref_kf)
        self._ref_kf_dev = torch.tensor(self.ref_kf, dtype=torch.int32, device=self.device)
        self.state = TrackState.OK
        self.velocity = torch.eye(4, device=self.device)
        self.stats.n_relocalizations += 1
        self._finish_frame(cur, timestamp, lost=True)  # no velocity update
        return True

    def _initialize(self, cur: frame_mod.FrameData, timestamp: float) -> bool:
        """StereoInitialization (Tracking.cc:509): the first frame with >= 100
        depth features seeds the map at the origin."""
        if int(((cur.depth > 0) & cur.fvalid).sum()) < 100:
            self._finish_frame(cur, timestamp, lost=True)
            return False
        cur = cur._replace(Tcw=torch.eye(4, device=self.device))
        self.map, kf_row, mp_idx = track_ops.insert_keyframe_with_points(
            self.cam, self.map, cur, self.frame_id, timestamp, self.cfg, client=self.client)
        cur = cur._replace(mp_idx=mp_idx)
        self.ref_kf = int(kf_row)
        self._ref_kf_dev = kf_row.to(torch.int32)
        self.state = TrackState.OK
        self.last_kf_frame_id = self.frame_id
        self._finish_frame(cur, timestamp)
        self.stats.n_keyframes += 1
        self._kf_cursor_est += 1
        return True

    def _initialize_mono(self, cur: frame_mod.FrameData, timestamp: float) -> bool:
        """MonocularInitialization + CreateInitialMapMonocular (Tracking.cc:569,
        :643): hold a reference frame, match it to the current one in a
        100-px area window, bootstrap from two views (K12), scale the map to
        unit median depth, insert both frames as keyframes with the
        triangulated points, and run the two-view local BA."""
        n_feat = int(cur.fvalid.sum())
        if self._init_ref is None or n_feat < 100:
            self._init_ref = cur if n_feat >= 100 else None
            self._finish_frame(cur, timestamp, lost=True)
            return False
        ref, cfg, dev = self._init_ref, self.cfg, self.device
        res = matcher.search_for_initialization(
            ref.xy, ref.desc, ref.angle, ref.fvalid, cur.xy, cur.desc, cur.angle, cur.fvalid,
            window=100.0, max_dist=cfg.matcher.th_low, ratio=0.9)
        has = res.idx >= 0
        if int(has.sum()) < 100:  # Tracking.cc:607 asks for >= 100
            self._init_ref = cur
            self._finish_frame(cur, timestamp, lost=True)
            return False
        f2 = res.idx.clamp_min(0).long()
        two = initializer.initialize_two_view(self.cam, ref.xy, cur.xy[f2], has,
                                              generator=self._gen, min_triangulated=50)
        if not bool(two.ok):  # the one host read of the bootstrap
            self._finish_frame(cur, timestamp, lost=True)
            return False
        # Unit median depth of the good points (Tracking.cc:714 invMedianDepth).
        good = two.good
        med = triangulation.nanmedian(torch.where(good, two.X[:, 2],
                                                  torch.full_like(two.X[:, 2], float("nan"))))
        inv_med = 1.0 / med.clamp_min(1e-6)
        X = two.X * inv_med
        T2 = se3.from_Rt(two.R, two.t * inv_med)
        F = ref.xy.shape[0]
        dist = cam_mod.norm3(X)
        max_dist = dist * self.scales[ref.octave.long()]
        min_dist = matcher.div(max_dist, cfg.orb.scale_factor ** (cfg.orb.n_levels - 1))
        normal = X / dist.clamp_min(1e-9)[:, None]
        self.map, rows = ms.add_map_points(self.map, X, ref.desc, normal, min_dist, max_dist,
                                           ref_kf=0, create=good, client=self.client)
        mp_ref = torch.where(good, rows, torch.full_like(rows, ms.NO_MP))
        # Bind the matched current features; lanes that are not good are dropped.
        mp_cur = torch.full((F + 1,), ms.NO_MP, dtype=torch.int32, device=dev)
        mp_cur[torch.where(good, f2, torch.full_like(f2, F))] = rows
        mp_cur = mp_cur[:F]
        ref = ref._replace(Tcw=torch.eye(4, device=dev), mp_idx=mp_ref)
        cur = cur._replace(Tcw=T2, mp_idx=mp_cur)
        for fr, fid in ((ref, self.frame_id - 1), (cur, self.frame_id)):
            self.map, _ = ms.insert_keyframe(self.map, fr.Tcw, fr.xy, fr.octave, fr.angle, fr.desc,
                                             fr.uright, fr.depth, fr.fvalid, fr.mp_idx,
                                             frame_id=fid, timestamp=timestamp,
                                             client=self.client)
        kf1 = self._kf_cursor_est + 1
        self.map = local_mapping.local_ba(self.cam, self.map, kf1, cfg)  # Tracking.cc:689
        self.ref_kf = kf1
        self._ref_kf_dev = torch.tensor(kf1, dtype=torch.int32, device=dev)
        self.state = TrackState.OK
        self.last_kf_frame_id = self.frame_id
        self.ref_obs = int(good.sum())
        self.stats.n_keyframes += 2
        self._kf_cursor_est += 2
        self._init_ref = None
        self._finish_frame(cur, timestamp)
        return True

    def _need_new_keyframe(self, cur, n_tracked: int, n_close_tracked: int = 1 << 30,
                           n_close_spawnable: int = 0, fid: Optional[int] = None) -> bool:
        """NeedNewKeyFrame (Tracking.cc:995): the max-frame gap, few tracked
        points, thinning close points with enough spawnable ones
        (Tracking.cc:1036-1044), or the tracked count under thRefRatio of the
        count at the last keyframe."""
        cfgt = self.cfg.tracking
        frames_since_kf = (self.frame_id if fid is None else fid) - self.last_kf_frame_id
        if frames_since_kf < cfgt.min_frames_between_kf + 1:
            return False
        if frames_since_kf >= cfgt.max_frames_between_kf or n_tracked < 50:
            return True
        if n_close_tracked < 100 and n_close_spawnable > 70:
            return True
        ratio = cfgt.kf_ref_ratio_mono if self.sensor == "mono" else cfgt.kf_ref_ratio_stereo
        return ratio * max(self.ref_obs, 1) > n_tracked > 15

    def _create_keyframe(self, cur, timestamp: float, n_tracked: int = 0,
                         fid: Optional[int] = None):
        """CreateNewKeyFrame: insert `cur` with its new points at the host
        mirror of the cursor and queue its mapping stages. The new points'
        bindings stay local to this call."""
        fid = self.frame_id if fid is None else fid
        kf_row = self._kf_cursor_est
        if kf_row >= self.cfg.capacity.max_keyframes:
            if not self._warned_kf_full:
                self._warned_kf_full = True
                print(f"[tracking] keyframe capacity reached ({self.cfg.capacity.max_keyframes});"
                      " no further keyframes will be created", file=sys.stderr)
            return
        self.ref_obs = max(n_tracked, 100)
        self.map, kf_row_dev, _ = track_ops.insert_keyframe_with_points(
            self.cam, self.map, cur, fid, timestamp, self.cfg, client=self.client)
        self.last_kf_frame_id = fid
        self.ref_kf = kf_row
        self._ref_kf_dev = kf_row_dev.to(torch.int32)
        self.stats.n_keyframes += 1
        self._kf_cursor_est += 1
        self._enqueue_mapping_stages(kf_row)
        if self.sensor == "mono":
            # Mono drains its mapping stages at once: triangulation is its only
            # source of points, and interleaving the stages of several
            # keyframes lets a later cull meet points before fuse binds them.
            while self._stage_q:
                self._run_stage()

    def _set_map(self, m):
        self.map = m

    def _enqueue_mapping_stages(self, kf_row: int):
        """Queue the per-keyframe LocalMapping pipeline (LocalMapping.cc:44),
        one device step per entry, drained one per frame."""
        q = self._stage_q
        nk = self.stats.n_keyframes
        cam, cfg = self.cam, self.cfg
        mono = self.sensor == "mono"
        if mono:  # mono's only landmarks come from triangulation (LocalMapping.cc:190)
            q.append(("triangulate", lambda: self._set_map(
                triangulation.create_new_points(cam, self.map, kf_row, cfg))))
        q.append(("fuse", lambda: self._set_map(
            local_mapping.fuse_into_kf(cam, self.map, kf_row, cfg))))
        if nk % 2 == 0:
            q.append(("cull_points", lambda: self._set_map(
                local_mapping.cull_map_points(self.map, kf_row, cfg, mono=mono))))
            q.append(("refresh", lambda: self._set_map(
                local_mapping.refresh_point_geometry(self.map, kf_row, cfg))))
        if nk >= 3:
            st: dict = {}
            q.append(("ba_build", lambda: self._stage_local_ba_build(kf_row, st)))
            q.append(("ba_a", lambda: self._stage_local_ba_a(st)))
            q.append(("ba_b", lambda: self._stage_local_ba_b(st)))
        if nk % 3 == 0 and nk > 5:
            q.append(("cull_keyframes", lambda: self._stage_cull_keyframes(kf_row)))
        if nk % 6 == 0 and nk > 5:
            q.append(("sweep", lambda: self._set_map(local_mapping.sweep_detached(self.map))))
        if self.loop_closer is not None:
            q.append(("loop_closing", lambda: self._stage_loop_closing(kf_row)))

    def _run_stage(self):
        kind, fn = self._stage_q.popleft()
        fn()
        self.stats.stages[kind] += 1

    def _stage_loop_closing(self, kf_row: int):
        """Loop-closing stage; a closure, or a global BA that finished
        meanwhile, bumps the map epoch (aborts the split local BAs built
        before it)."""
        lc = self.loop_closer

        def finished():
            return lc.gba_runner.runs_finished if lc.gba_runner is not None else 0

        loops0, merges0 = lc.stats.n_loops_closed, finished()
        self.map = lc.process_keyframe(self.map, kf_row)
        if lc.stats.n_loops_closed != loops0 or finished() != merges0:
            self.map_epoch += 1

    def _stage_local_ba_build(self, kf_row: int, st: dict):
        """Local BA stage 0: window selection and the problem (copies)."""
        st["epoch"] = self.map_epoch
        st["sel"], st["prob"] = local_mapping.local_ba_build(self.map, kf_row, self.cfg)

    def _stage_local_ba_a(self, st: dict):
        """Local BA stage 1: the robust LM phase."""
        if st["epoch"] != self.map_epoch:
            st["res"] = None  # aborted: poses moved under the window
            return
        st["res"] = ba_dense.optimize(self.cam, st["prob"],
                                      n_iters=max(self.cfg.mapping.local_ba_iters - 2, 1),
                                      cg_iters=self.cfg.mapping.local_ba_cg_iters, huber_iters=3)

    def _stage_local_ba_b(self, st: dict):
        """Local BA stage 2: plain polish on the re-classified inliers, then
        the writeback into the (newer) map, unless the epoch moved."""
        if st.get("res") is None or st["epoch"] != self.map_epoch:
            return
        sel, prob, res = st["sel"], st["prob"], st["res"]
        prob2 = prob._replace(Tcw=res.Tcw, X=res.X, obs_active=prob.obs_active & res.inlier)
        res2 = ba_dense.optimize(self.cam, prob2, n_iters=2,
                                 cg_iters=self.cfg.mapping.local_ba_cg_iters, huber_iters=0)
        self.map = local_mapping.local_ba_writeback(
            self.map, sel.kf_rows, sel.kf_free, sel.kf_ok, sel.mp_rows, sel.mp_ok, res2.Tcw,
            res2.X, res2.inlier, prob.obs_active)

    def _stage_cull_keyframes(self, kf_row: int):
        """Redundant-keyframe culling (KeyFrameCulling, LocalMapping.cc:590)."""
        self.map, kill = local_mapping.cull_keyframes(self.map, kf_row, self.cfg)
        if self.loop_closer is not None:
            self.loop_closer.db = self.loop_closer.db.remove(kill)

    def _mapping_step(self, kf_row: int):
        """The per-keyframe pipeline run at once (tools and tests)."""
        self._enqueue_mapping_stages(kf_row)
        while self._stage_q:
            self._run_stage()

    def _compact_map(self):
        """Repack the map (`ms.compact`) and remap every host row reference;
        runs with the pipeline flushed."""
        cap = self.cfg.capacity.max_keyframes
        if int(self.map.n_kf) < int(0.5 * cap):
            self._kf_cursor_est = int(self.map.n_kf)  # the estimate drifted: resync
            return
        res = ms.compact(self.map)
        self.map = res.m
        kmap = res.kf_old2new.cpu().numpy()
        new_ref = int(kmap[self.ref_kf]) if self.ref_kf >= 0 else -1
        self.ref_kf = max(new_ref, 0)
        self._ref_kf_dev = torch.tensor(self.ref_kf, dtype=torch.int32, device=self.device)
        lr = res.kf_old2new[self._local_rows.clamp_min(0).long()]
        self._local_ok = self._local_ok & (lr >= 0)
        self._local_rows = lr.clamp_min(0)
        if self.last_frame is not None:
            idx = self.last_frame.mp_idx
            idx = torch.where(idx >= 0, res.mp_old2new[idx.clamp_min(0).long()],
                              torch.full_like(idx, ms.NO_MP))
            self.last_frame = self.last_frame._replace(mp_idx=idx)
        if self.loop_closer is not None:
            self.loop_closer.remap_rows(res)
        for cb in self.on_compact:
            cb(res)
        self.map_epoch += 1  # rows renumbered
        self.stats.n_compactions += 1
        self._kf_cursor_est = int(self.map.n_kf)
        if self._kf_cursor_est >= int(0.85 * cap):
            self._compact_cooldown = self.frame_id + 60  # full map: back off

    def reset(self):
        """Hard reset (Tracking::Reset, Tracking.cc:1533): empty map, drop
        in-flight work, NOT_INITIALIZED."""
        self._pending.clear()
        self._stage_q.clear()
        self._pair_buf.clear()
        self.map = ms.empty(self.cfg.capacity, self.device)
        self._state = TrackState.NOT_INITIALIZED
        self.last_frame = None
        self.velocity = torch.eye(4, device=self.device)
        self.last_kf_frame_id = 0
        self.ref_kf = 0
        self._ref_kf_dev = torch.zeros((), dtype=torch.int32, device=self.device)
        self.ref_obs = 0
        self._init_ref = None
        self._kf_cursor_est = 0
        self._compact_cooldown = 0
        self.map_epoch += 1
        self.stats.n_resets += 1
        if self.loop_closer is not None:
            self.loop_closer.reset()
        for cb in self.on_reset:
            cb()

    def _finish_frame(self, cur, timestamp: float, lost: bool = False):
        """Bookkeeping tail of a frame tracked outside the fused path."""
        if self.last_frame is not None and not lost:
            self.velocity = se3.compose(cur.Tcw, se3.inverse(self.last_frame.Tcw))
        self.last_frame = cur
        self._traj.append((timestamp, cur.Tcw.detach().cpu().numpy()))
        self._frame_states.append(self._state)
        self.frame_id += 1
        self.stats.n_frames += 1

    # ------------------------------------------------------------------
    def current_pose(self) -> np.ndarray:
        """Latest retired pose (may lag the in-flight frames)."""
        return self._traj[-1][1] if self._traj else np.eye(4)

    def trajectory_kitti(self) -> np.ndarray:
        """[T, 3, 4] Twc rows, the SaveTrajectoryKITTI format (System.cc:350)."""
        out = [se3.inverse(torch.from_numpy(np.asarray(T, np.float32)))[:3, :4].numpy()
               for _, T in self.trajectory]
        return np.stack(out) if out else np.zeros((0, 3, 4))
