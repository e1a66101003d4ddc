"""Client-side collaboration cache: dirty tracking, uplink, downlink (port of
`corbslam_tpu/collab/client_cache.py`: `IdMap`, copied, and `ClientCache`).

Replaces the reference's `Cache` module and `DataDriver` RPC client
(corbslam_client/src/Cache.cc: the dirty sets filled by AddKeyFrameToMap
:67 / addUpdateKeyframe :223; the uplink thread runUpdateToServer :322; the
downlink subscriptions and handlers :418-634; DataDriver.cc's service
calls). The map is fixed-capacity SoA tensors with a monotone allocation
cursor, so "new since the last push" is a row range and "updated poses" a
diff against the snapshot of the last acknowledged push. Cursors and
snapshots move only on an ACK, so a failed uplink retries next period.

Identity: own entities get gid = cid * stride + uid, the uid from a
monotone counter (the reference's (clientId-1)*1e6 offset, KeyFrame.cc:49-51);
foreign entities keep the gid they arrived with, in host-side tables.

The uplink works on a host (numpy) copy of the map. `request_uplink` (the
asynchronous path) starts that copy on the tracker's stream into pinned
memory and records an event; the worker thread waits on the event and reads
only the copy, so the tracker's later in-place writes and the global BA's
stream are never waited on. The downlink writes the tracker's map in place
on the map's device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import sim3
from ..mapstate import mapstate as ms
from . import fusion_ops, wire
from .transport import Transport


class IdMap:
    """Bidirectional row <-> gid bookkeeping for one map's entity class.

    gid = origin_cid * stride + origin-local UID. Own uids come from a
    monotone counter (NOT the row index): map compaction renumbers rows,
    and row-derived gids would collide with the server's existing entities
    once a reclaimed row is reused. Uids stay < stride for any realistic
    run (stride = 1e6), so the reverse map is a dense [cid][gid % stride]
    table, grown on demand — all lookups are vectorized numpy indexing,
    no per-gid Python loops.
    """

    def __init__(self, capacity: int, cid: int, stride: int):
        self.gid_of_row = np.full(capacity, -1, np.int64)
        self._row_of: Dict[int, np.ndarray] = {}  # origin cid -> [local-id] rows
        self.cid = cid
        self.stride = stride
        self.capacity = capacity

    def _table(self, cid: int, need: int = 0) -> np.ndarray:
        t = self._row_of.get(cid)
        if t is None:
            t = np.full(max(self.capacity, need), -1, np.int32)
            self._row_of[cid] = t
        elif need > len(t):
            n = len(t)
            while n < need:
                n *= 2
            t2 = np.full(n, -1, np.int32)
            t2[: len(t)] = t
            self._row_of[cid] = t2
            t = t2
        return t

    def assign_own(self, rows: np.ndarray, uids: np.ndarray):
        rows = np.asarray(rows, np.int64)
        uids = np.asarray(uids, np.int64)
        gids = self.cid * self.stride + uids
        self.gid_of_row[rows] = gids
        t = self._table(self.cid, int(uids.max()) + 1 if len(uids) else 0)
        t[uids] = rows.astype(np.int32)
        return gids

    def assign_foreign(self, rows: np.ndarray, gids: np.ndarray):
        rows = np.asarray(rows, np.int64)
        gids = np.asarray(gids, np.int64)
        self.gid_of_row[rows] = gids
        for c in np.unique(gids // self.stride):
            sel = (gids // self.stride) == c
            loc = gids[sel] % self.stride
            t = self._table(int(c), int(loc.max()) + 1 if len(loc) else 0)
            t[loc] = rows[sel].astype(np.int32)

    def rows_for(self, gids: np.ndarray) -> np.ndarray:
        gids = np.asarray(gids, np.int64)
        out = np.full(gids.shape, -1, np.int32)
        valid = gids >= 0
        for c in np.unique(gids[valid] // self.stride):
            sel = valid & ((gids // self.stride) == c)
            loc = gids[sel] % self.stride
            t = self._table(int(c))
            in_range = loc < len(t)
            vals = np.full(len(loc), -1, np.int32)
            vals[in_range] = t[loc[in_range]]
            out[sel] = vals
        return out

    def known_mask(self, gids: np.ndarray) -> np.ndarray:
        return self.rows_for(gids) >= 0

    def remap_rows(self, old2new: np.ndarray):
        """Apply a map-compaction row permutation: surviving rows keep
        their gids at their new positions; dropped rows' gids retire."""
        old2new = np.asarray(old2new)
        new_gid = np.full_like(self.gid_of_row, -1)
        sel = (self.gid_of_row >= 0) & (old2new >= 0)
        new_gid[old2new[sel]] = self.gid_of_row[sel]
        self.gid_of_row = new_gid
        # Rebuild every reverse table from the surviving forward map.
        rows = np.nonzero(new_gid >= 0)[0]
        gids = new_gid[rows]
        self._row_of = {}
        if len(rows):
            self.assign_foreign(rows, gids)


def host_map(m: ms.MapState) -> ms.MapState:
    """The map as numpy arrays (a copy of a tensor map; a host map as is)."""
    if isinstance(m.n_kf, np.ndarray):
        return m
    cvt = lambda t: t.detach().to("cpu", copy=True).numpy()  # noqa: E731
    return ms.MapState(ms.KeyFrames(*map(cvt, m.kf)), ms.MapPoints(*map(cvt, m.mp)),
                       cvt(m.n_kf), cvt(m.n_mp))


def _start_host_copy(m: ms.MapState):
    """Start copying a tensor map to host memory on the current stream;
    returns (copy, event or None). The copy reads the map as the stream has
    it now, whatever the caller writes afterwards."""
    dev = m.kf.Tcw.device
    if dev.type != "cuda":
        return host_map(m), None

    def cp(t):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t, non_blocking=True)

    snap = ms.MapState(ms.KeyFrames(*map(cp, m.kf)), ms.MapPoints(*map(cp, m.mp)), cp(m.n_kf),
                       cp(m.n_mp))
    ev = torch.cuda.Event()
    ev.record()
    return snap, ev


def _finish_host_copy(snap, ev) -> ms.MapState:
    if ev is None:
        return snap
    ev.synchronize()
    cvt = lambda t: t.numpy()  # noqa: E731
    return ms.MapState(ms.KeyFrames(*map(cvt, snap.kf)), ms.MapPoints(*map(cvt, snap.mp)),
                       cvt(snap.n_kf), cvt(snap.n_mp))


class ClientCache:
    """Owns sync state for one client's tracker map."""

    def __init__(
        self,
        tracker,                      # frontend.tracking.StereoTracker-like
        transport: Transport,
        cid: int,
        cfg: SlamConfig,
        loop_closer=None,             # gets foreign keyframes into its BoW db
    ):
        self.tracker = tracker
        self.transport = transport
        self.cid = cid
        self.cfg = cfg
        self.loop_closer = loop_closer
        cap = cfg.capacity
        stride = cfg.collab.client_id_stride
        self.kf_ids = IdMap(cap.max_keyframes, cid, stride)
        self.mp_ids = IdMap(cap.max_map_points, cid, stride)
        self.synced_kf = 0   # own rows < cursor AND gid assigned are pushed
        self.synced_mp = 0
        self._kf_pose_snap = np.zeros((cap.max_keyframes, 4, 4), np.float32)
        self._mp_pos_snap = np.zeros((cap.max_map_points, 3), np.float32)
        # Own-world -> global alignment, set by the server via TRANSM.
        self.Ttrans: Optional[tuple] = None
        self.stats = {
            "kfs_pushed": 0, "mps_pushed": 0, "kf_poses_pushed": 0,
            "mp_pos_pushed": 0, "failed_calls": 0,
            "foreign_kfs": 0, "foreign_mps": 0,
        }
        # Serializes uplink (worker thread) against downlink (main thread):
        # both touch the id maps and sync cursors.
        self._lock = threading.Lock()
        self._uq: Optional[queue.Queue] = None
        self._uplink_thread: Optional[threading.Thread] = None
        # Stable per-row identity for OWN entities: uids from a monotone
        # counter, assigned in row order the first time a row is seen by
        # the uplink builder. Row-derived gids would collide after map
        # compaction reuses row numbers.
        self._kf_uid = np.full(cap.max_keyframes, -1, np.int64)
        self._mp_uid = np.full(cap.max_map_points, -1, np.int64)
        self._next_kf_uid = 0
        self._next_mp_uid = 0
        # Bumped by remap_rows (map compaction); an uplink cycle built
        # against the old numbering aborts its commit and retries.
        self._gen = 0
        # Compaction and reset hooks of the tracker.
        if hasattr(tracker, "on_compact"):
            tracker.on_compact.append(self.remap_rows)
        if hasattr(tracker, "on_reset"):
            tracker.on_reset.append(self.handle_reset)
        transport.register_client(cid)

    @property
    def device(self) -> torch.device:
        return self.tracker.map.kf.Tcw.device

    # ------------------------------------------------------------------
    # Async uplink (the reference's dedicated uplink thread, Cache.cc:322
    # runUpdateToServer): tracking must not block on the server's ACK,
    # which waits while the server fuses. The main thread starts a host
    # copy of the map and a worker pushes and retries.
    # ------------------------------------------------------------------

    def start_async_uplink(self):
        if self._uq is not None:
            return
        self._uq = queue.Queue(maxsize=1)
        self._uplink_thread = threading.Thread(
            target=self._uplink_worker, daemon=True)
        self._uplink_thread.start()

    def request_uplink(self) -> bool:
        """Queue one uplink cycle against a host copy of the current map;
        skipped (False) while the previous cycle is still in flight —
        cursors only advance on ACK, so nothing is lost."""
        if self._uq is None:
            return self.uplink_step()
        if self._uq.full():
            return False
        self._uq.put(_start_host_copy(self.tracker.map))
        return True

    def _uplink_worker(self):
        while True:
            item = self._uq.get()
            if item is None:
                return
            try:
                self.uplink_step(_finish_host_copy(*item))
            except Exception:  # pragma: no cover - keep the worker alive
                import traceback

                traceback.print_exc()

    def stop_async_uplink(self):
        if self._uq is None:
            return
        self._uq.put(None)
        self._uplink_thread.join(timeout=30)
        self._uq = None
        self._uplink_thread = None

    # ------------------------------------------------------------------
    # Uplink (runUpdateToServer, Cache.cc:322)
    # ------------------------------------------------------------------

    def uplink_step(self, m: Optional[ms.MapState] = None) -> bool:
        """One sync cycle: push new map points, new keyframes, then pose /
        position deltas. Returns True if everything was acknowledged. `m`
        may be a host (numpy) map; the tracker's map is copied to the host
        when none is given.

        Map points MUST be acked before the keyframes that observe them go
        out: kf_insert_msg encodes observations as mp gids via
        `mp_ids.gid_of_row`, which is only assigned on MP ack. A failed MP
        push therefore aborts the cycle and the whole batch retries next
        period.

        Locking: the transport call can block while the server is busy;
        each push builds its message and commits its cursors and id maps
        under the lock but makes the call outside it — safe because only
        this single uplink worker advances cursors and assigns OWN rows,
        while the downlink only assigns FOREIGN rows."""
        m = host_map(self.tracker.map if m is None else m)
        for build in (self._build_new_mps, self._build_new_kfs,
                      self._build_pose_deltas, self._build_pos_deltas):
            with self._lock:
                gen = self._gen
                prep = build(m)
            if prep is None:
                continue  # nothing to push for this stage
            service, msg, commit = prep
            if not self.transport.call(service, self.cid, msg):
                self.stats["failed_calls"] += 1
                return False
            with self._lock:
                if self._gen != gen:
                    # Map compacted mid-flight: the build's row numbering
                    # is stale. Abort the cycle; the next period re-pushes
                    # the same GIDS (stable uids), which the server
                    # deduplicates — nothing is lost or duplicated.
                    return False
                commit()
        return True

    def _own_new_rows(self, client_arr, valid_arr, lo: int, hi: int, fixed_arr):
        rows = np.arange(lo, hi, dtype=np.int64)
        if len(rows) == 0:
            return rows
        cl = client_arr[lo:hi]
        vd = valid_arr[lo:hi]
        fx = fixed_arr[lo:hi]
        return rows[(cl == self.cid) & vd & ~fx]

    def _kf_uids_up_to(self, hi: int) -> np.ndarray:
        """Assign uids (monotone, row order) to keyframe rows < hi that
        lack one; returns the row->uid view. Called under the lock."""
        missing = np.nonzero(self._kf_uid[:hi] < 0)[0]
        if len(missing):
            self._kf_uid[missing] = np.arange(
                self._next_kf_uid, self._next_kf_uid + len(missing))
            self._next_kf_uid += len(missing)
        return self._kf_uid

    def _mp_uids_up_to(self, hi: int) -> np.ndarray:
        missing = np.nonzero(self._mp_uid[:hi] < 0)[0]
        if len(missing):
            self._mp_uid[missing] = np.arange(
                self._next_mp_uid, self._next_mp_uid + len(missing))
            self._next_mp_uid += len(missing)
        return self._mp_uid

    def _build_new_mps(self, m: ms.MapState):
        """Build the new-map-point push (called under the lock). Returns
        (service, msg, commit) or None; `commit` runs under the lock after
        the server ACKs."""
        hi = int(m.n_mp)
        rows = self._own_new_rows(m.mp.client, m.mp.valid, self.synced_mp, hi, m.mp.fixed)
        if len(rows) == 0:
            self.synced_mp = hi
            return None
        uids = self._mp_uids_up_to(hi)[rows]
        gids = self.cid * self.mp_ids.stride + uids
        ref_rows = m.mp.ref_kf[rows]
        kf_uid = self._kf_uids_up_to(int(m.n_kf))
        ref_uid = kf_uid[np.clip(ref_rows, 0, None)]
        pos = m.mp.pos[rows]
        msg = wire.mp_insert_msg(
            gid=gids, client=np.full(len(rows), self.cid, np.int32),
            pos=pos, normal=m.mp.normal[rows], desc=m.mp.desc[rows],
            min_dist=m.mp.min_dist[rows], max_dist=m.mp.max_dist[rows],
            ref_kf_gid=np.where(
                ref_rows >= 0, self.cid * self.kf_ids.stride + ref_uid, -1
            ).astype(np.int64),
        )

        def commit():
            self.mp_ids.assign_own(rows, uids)
            self._mp_pos_snap[rows] = pos
            self.synced_mp = hi
            self.stats["mps_pushed"] += len(rows)

        return wire.SRV_INSERT_MPS, msg, commit

    def _build_new_kfs(self, m: ms.MapState):
        hi = int(m.n_kf)
        rows = self._own_new_rows(m.kf.client, m.kf.valid, self.synced_kf, hi, m.kf.fixed)
        if len(rows) == 0:
            self.synced_kf = hi
            return None
        uids = self._kf_uids_up_to(hi)[rows]
        gids = self.cid * self.kf_ids.stride + uids
        mp_idx = m.kf.mp_idx[rows]  # [K, F] local rows
        mp_gid = np.where(
            mp_idx >= 0, self.mp_ids.gid_of_row[np.clip(mp_idx, 0, None)], -1
        )
        Tcw = m.kf.Tcw[rows]
        msg = wire.kf_insert_msg(
            gid=gids, client=np.full(len(rows), self.cid, np.int32),
            Tcw=Tcw, xy=m.kf.xy[rows], octave=m.kf.octave[rows], angle=m.kf.angle[rows],
            desc=m.kf.desc[rows], uright=m.kf.uright[rows], depth=m.kf.depth[rows],
            fvalid=m.kf.fvalid[rows], mp_gid=mp_gid, frame_id=m.kf.frame_id[rows],
            timestamp=m.kf.timestamp[rows],
        )

        def commit():
            self.kf_ids.assign_own(rows, uids)
            self._kf_pose_snap[rows] = Tcw
            self.synced_kf = hi
            self.stats["kfs_pushed"] += len(rows)

        return wire.SRV_INSERT_KFS, msg, commit

    def _build_pose_deltas(self, m: ms.MapState):
        """Keyframes already on the server whose pose moved (local BA, loop
        correction) — the reference's updateKFs dirty set (Cache.cc:223),
        here a vectorized diff against the last acked snapshot."""
        lo = self.synced_kf
        own = (self.kf_ids.gid_of_row >= 0) & (
            np.arange(len(self.kf_ids.gid_of_row)) < lo
        )
        if not own.any():
            return None
        Tcw = m.kf.Tcw
        moved = own & (
            np.abs(Tcw - self._kf_pose_snap).reshape(len(Tcw), -1).max(axis=1)
            > 1e-7
        ) & m.kf.valid & ~m.kf.fixed
        rows = np.nonzero(moved)[0]
        if len(rows) == 0:
            return None
        msg = wire.kf_pose_msg(self.kf_ids.gid_of_row[rows], Tcw[rows])

        def commit():
            self._kf_pose_snap[rows] = Tcw[rows]
            self.stats["kf_poses_pushed"] += len(rows)

        return wire.SRV_UPDATE_KFS, msg, commit

    def _build_pos_deltas(self, m: ms.MapState):
        lo = self.synced_mp
        own = (self.mp_ids.gid_of_row >= 0) & (
            np.arange(len(self.mp_ids.gid_of_row)) < lo
        )
        if not own.any():
            return None
        pos = m.mp.pos
        moved = own & (
            np.abs(pos - self._mp_pos_snap).max(axis=1) > 1e-7
        ) & m.mp.valid & ~m.mp.fixed
        rows = np.nonzero(moved)[0]
        if len(rows) == 0:
            return None
        msg = wire.mp_pos_msg(self.mp_ids.gid_of_row[rows], pos[rows])

        def commit():
            self._mp_pos_snap[rows] = pos[rows]
            self.stats["mp_pos_pushed"] += len(rows)

        return wire.SRV_UPDATE_MPS, msg, commit

    def remap_rows(self, res) -> None:
        """Apply a map compaction (mapstate.CompactResult) to every
        row-addressed structure: id maps, uid tables, ack snapshots, and
        the sync cursors (stable repack: surviving rows below a cursor
        stay below it, so the cursor becomes the survivor count). Bumps
        the generation so an uplink cycle built against the old numbering
        aborts its commit — with stable uids the retry re-sends the same
        gids and the server deduplicates, so compaction stays enabled
        under collaboration."""
        kmap = res.kf_old2new.cpu().numpy()
        pmap = res.mp_old2new.cpu().numpy()
        with self._lock:
            self._gen += 1
            self.kf_ids.remap_rows(kmap)
            self.mp_ids.remap_rows(pmap)

            def permute(arr, old2new, fill):
                out = np.full_like(arr, fill)
                sel = old2new >= 0
                out[old2new[sel]] = arr[sel]
                return out

            self._kf_uid = permute(self._kf_uid, kmap, -1)
            self._mp_uid = permute(self._mp_uid, pmap, -1)
            self._kf_pose_snap = permute(self._kf_pose_snap, kmap, 0.0)
            self._mp_pos_snap = permute(self._mp_pos_snap, pmap, 0.0)
            self.synced_kf = int((kmap[: self.synced_kf] >= 0).sum())
            self.synced_mp = int((pmap[: self.synced_mp] >= 0).sum())

    def handle_reset(self) -> None:
        """Apply a tracker hard reset (Tracking::Reset, Tracking.cc:1533):
        every row-addressed structure starts over with the empty map. The
        uid counters stay MONOTONE — entities already pushed live on at the
        server as a dead sub-map (the reference's Reset does not retract
        served keyframes either) and re-used uids would collide with them.
        A resync request repopulates the foreign (global-map) entities the
        reset threw away."""
        cap = self.cfg.capacity
        stride = self.cfg.collab.client_id_stride
        with self._lock:
            self._gen += 1
            self.kf_ids = IdMap(cap.max_keyframes, self.cid, stride)
            self.mp_ids = IdMap(cap.max_map_points, self.cid, stride)
            self.synced_kf = 0
            self.synced_mp = 0
            self._kf_pose_snap[:] = 0.0
            self._mp_pos_snap[:] = 0.0
            self._kf_uid[:] = -1
            self._mp_uid[:] = -1
        try:
            self.request_resync()
        except Exception:  # transport may be gone at shutdown
            pass

    def request_resync(self) -> bool:
        """Ask the server to replay the full global map in chunks — the
        late-join / lost-message recovery path (the reference re-sends the
        whole map after every fusion, MapFusion.cpp:370-423; here it is a
        pull so steady-state broadcasts stay delta-only). The replay
        arrives on the normal downlink topics; gids this client already
        knows are skipped by _fresh_foreign."""
        return self.transport.call(wire.SRV_RESYNC, self.cid, {})

    # ------------------------------------------------------------------
    # Downlink (Cache::runSubFromServer + handlers, Cache.cc:418-634)
    # ------------------------------------------------------------------

    def downlink_step(self):
        """Drain all four topics and apply them to the local map."""
        with self._lock:
            for msg in self.transport.poll(wire.TOPIC_NEW_MPS, self.cid):
                self._note_transm(msg)
                self._apply_new_mps(msg)
            for msg in self.transport.poll(wire.TOPIC_NEW_KFS, self.cid):
                self._note_transm(msg)
                self._apply_new_kfs(msg)
            for msg in self.transport.poll(wire.TOPIC_UPD_KFS, self.cid):
                self._note_transm(msg)
                self._apply_kf_poses(msg)
            for msg in self.transport.poll(wire.TOPIC_UPD_MPS, self.cid):
                self._note_transm(msg)
                self._apply_mp_pos(msg)

    def _note_transm(self, msg):
        """Record this client's alignment from the message's TRANSM map
        whether or not any entity in the message is applied: the reference
        attaches TRANSM to every downlink message (PubToClient.cpp:48-52)
        so that clients learn their alignment as a side channel."""
        tr = wire.transm_lookup(msg, self.cid)
        if tr is not None:
            self.Ttrans = tr

    def _t(self, a, dtype=None) -> torch.Tensor:
        """A wire array as a tensor on the map's device (copied: the wire
        codec's arrays are read-only views of the message)."""
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(self.device, dtype) if dtype is not None else t.to(self.device)

    def _own_transform_inv(self, msg):
        tr = wire.transm_lookup(msg, self.cid)
        if tr is not None:
            self.Ttrans = tr
        if self.Ttrans is None:
            return sim3.identity(device=self.device)
        R, t, s = self.Ttrans
        return sim3.inverse((self._t(R), self._t(t), torch.tensor(float(s), device=self.device)))

    def _fresh_foreign(self, gids: np.ndarray, idmap: IdMap) -> np.ndarray:
        """Mask of entities to insert: not ours, not already known
        (Cache.cc:471-474 skips own-client and existing ids)."""
        own = (gids // idmap.stride) == self.cid
        return ~own & ~idmap.known_mask(gids)

    def _apply_new_mps(self, msg):
        gids = msg["gid"]
        take = self._fresh_foreign(gids, self.mp_ids)
        if not take.any():
            return
        Sinv = self._own_transform_inv(msg)
        m = self.tracker.map
        free = m.mp.capacity - int(m.n_mp)
        idxs = np.nonzero(take)[0][: max(free, 0)]
        for lo in range(0, len(idxs), fusion_ops.MP_CHUNK):
            sel = idxs[lo:lo + fusion_ops.MP_CHUNK]
            C = len(sel)
            pos = sim3.transform(Sinv, self._t(msg["pos"][sel]))
            normal = self._t(msg["normal"][sel]) @ Sinv[0].transpose(0, 1)
            m, rows = fusion_ops.insert_mp_chunk(
                m, pos, normal, self._t(msg["desc"][sel]),
                self._t(msg["min_dist"][sel]) * Sinv[2], self._t(msg["max_dist"][sel]) * Sinv[2],
                self._t(msg["client"][sel]), torch.zeros(C, dtype=torch.int32, device=self.device),
                use=torch.ones(C, dtype=torch.bool, device=self.device),
                fixed=torch.ones(C, dtype=torch.bool, device=self.device),  # read-only (:534)
            )
            self.mp_ids.assign_foreign(rows.cpu().numpy(), gids[sel])
            self.stats["foreign_mps"] += C
        self.tracker.map = m

    def _apply_new_kfs(self, msg):
        gids = msg["gid"]
        take = self._fresh_foreign(gids, self.kf_ids)
        if not take.any():
            return
        Sinv = self._own_transform_inv(msg)
        m = self.tracker.map
        free = m.kf.capacity - int(m.n_kf)
        idxs = np.nonzero(take)[0][: max(free, 0)]
        dev = self.device
        for lo in range(0, len(idxs), fusion_ops.KF_CHUNK):
            sel = idxs[lo:lo + fusion_ops.KF_CHUNK]
            C = len(sel)
            Tcw = fusion_ops.transform_poses(self._t(msg["Tcw"][sel]), Sinv)
            mp_gid = msg["mp_gid"][sel]
            mp_rows = np.where(
                mp_gid >= 0, self.mp_ids.rows_for(mp_gid.reshape(-1)).reshape(mp_gid.shape), -1)
            m, rows = fusion_ops.insert_kf_chunk(
                m, Tcw, self._t(msg["xy"][sel]), self._t(msg["octave"][sel]),
                self._t(msg["angle"][sel]), self._t(msg["desc"][sel]),
                self._t(msg["uright"][sel]), self._t(msg["depth"][sel]),
                self._t(msg["fvalid"][sel]), self._t(mp_rows, torch.int32),
                self._t(msg["client"][sel]), self._t(msg["frame_id"][sel]),
                self._t(msg["timestamp"][sel]),
                use=torch.ones(C, dtype=torch.bool, device=dev),
                fixed=torch.ones(C, dtype=torch.bool, device=dev),  # setFixed (Cache.cc:482)
            )
            rows_np = rows.cpu().numpy()
            self.kf_ids.assign_foreign(rows_np, gids[sel])
            self.stats["foreign_kfs"] += C
            # Keep the tracker's host mirror of the keyframe cursor exact
            # (it gates keyframe creation without a device sync).
            if hasattr(self.tracker, "_kf_cursor_est"):
                self.tracker._kf_cursor_est = max(
                    self.tracker._kf_cursor_est, int(rows_np.max()) + 1)
            # Foreign keyframes join the local BoW database so they serve
            # relocalization and loop detection (Cache.cc:484
            # addKeyFrametoDB): the server's sparse BoW scattered, or, without
            # it, one batched transform.
            if self.loop_closer is not None and C:
                from ..place import vocab as vocab_mod

                lc = self.loop_closer
                rj = rows.to(dev).long()
                if "bow_ids" in msg:
                    ids = self._t(msg["bow_ids"][sel]).long()
                    vals = self._t(msg["bow_vals"][sel])
                    bows = torch.zeros(C, lc.voc.n_words, dtype=torch.float32, device=dev)
                    bows.index_put_((torch.arange(C, device=dev)[:, None], ids.clamp_min(0)),
                                    torch.where(ids >= 0, vals, torch.zeros_like(vals)),
                                    accumulate=True)
                else:
                    bows = vocab_mod.transform_many(lc.voc, m.kf.desc[rj], m.kf.fvalid[rj])
                lc.db = lc.db.add_batch(rj.to(torch.int32), bows)
        self.tracker.map = m

    def _apply_kf_poses(self, msg):
        """Server-optimized poses for FIXED (foreign) keyframes only — own
        entities are authoritative locally (Cache.cc:574)."""
        gids = msg["gid"]
        rows = self.kf_ids.rows_for(gids)
        m = self.tracker.map
        fixed = m.kf.fixed.cpu().numpy()
        sel = (rows >= 0) & fixed[np.clip(rows, 0, None)]
        if not sel.any():
            return
        Sinv = self._own_transform_inv(msg)
        Tcw = fusion_ops.transform_poses(self._t(msg["Tcw"][sel]), Sinv)
        m.kf.Tcw[self._t(rows[sel]).long()] = Tcw

    def _apply_mp_pos(self, msg):
        gids = msg["gid"]
        rows = self.mp_ids.rows_for(gids)
        m = self.tracker.map
        fixed = m.mp.fixed.cpu().numpy()
        sel = (rows >= 0) & fixed[np.clip(rows, 0, None)]
        if not sel.any():
            return
        Sinv = self._own_transform_inv(msg)
        m.mp.pos[self._t(rows[sel]).long()] = sim3.transform(Sinv, self._t(msg["pos"][sel]))
