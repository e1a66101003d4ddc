"""Map-fusion server: per-client sub-maps, overlap detection, global map
merge, optimization, broadcast (port of `corbslam_tpu/collab/server.py`:
`SubMap`, `MapFusionServer`).

Replaces `corbslam_server` (src/main.cpp service wiring :49-62;
MapFusion.cpp: service handlers :31-306, fuseSubMapToMap :432,
mapFuseToGlobalMap :456, insertServerMapToGlobleMap :622,
detectKeyFrameInServerMap :660, runPubTopic :315, resentGlobalMapToClient
:370; ServerMap.cpp; GlobalOptimize.cpp: the server-side Sim3, CorrectLoop
and GBA; PubToClient.cpp: 4 broadcast topics with the per-client TRANSM).

Every sub-map, the global map and their BoW databases sit on the server's
`device` ("cuda" unless the caller asks for "cpu"). Fusion scores a
sub-map's keyframes in blocks of 256 against the global database (K9: one
batched BoW transform and one score launch a block), verifies the best few
(query, candidate) pairs with `fusion_ops.detect_overlap` (K7, K5, K10's PnP
RANSAC and weighted Horn), moves the whole sub-map by the alignment and
appends it in chunks, then fuses the seam (K5), optimizes the essential
graph (K11 and B17) and, with `run_gba`, runs global BA (K8). The
broadcast publishes what changed since the last one by a diff against host
snapshots. The RANSAC draws come from a `torch.Generator` seeded with
`seed`.

The handlers run on whichever thread delivers a call: the caller's own
thread with `InProcTransport` (a client's uplink worker), or the thread that
calls `serve_calls` for the socket and shm transports. The maps are written
in place, so a reentrant lock serializes the handlers against `fuse_step`,
`broadcast_step` and each other; `_serve_between_steps` drains the socket
and shm transports inside a long step on the thread that holds the lock,
while an in-process call waits until the step ends.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from .. import kernels
from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import sim3
from ..loop import gba as gba_mod
from ..loop import loop_closing as lc
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..place import database as db_mod
from ..place import vocab as vocab_mod
from ..solvers import pnp as pnp_mod
from . import fusion_ops, wire
from .client_cache import IdMap
from .transport import Transport


@dataclass
class SubMap:
    """(Cache, Map) pair per client — ServerMap.cpp."""

    map: ms.MapState
    kf_ids: IdMap
    mp_ids: IdMap
    db: db_mod.BowDatabase
    fused: bool = False
    n_kfs_received: int = 0


def _locked(fn):
    def run(self, *args, **kw):
        with self._lock:
            return fn(self, *args, **kw)

    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


class MapFusionServer:
    def __init__(
        self,
        cam: cam_mod.Intrinsics,
        cfg: SlamConfig,
        voc: vocab_mod.Vocabulary,
        transport: Transport,
        run_gba: bool = True,
        synchronous_gba: bool = True,
        seed: int = 0,
        device="cuda",
    ):
        dev = kernels.resolve_device(device)
        if voc.words.device.type != dev.type:
            raise ValueError(f"vocabulary on {voc.words.device}, server on {dev}")
        cap = cfg.capacity
        pnp_mod.check_capacity(cap.max_features, dev)
        covis.check_capacity(cap.max_keyframes, cap.max_features, dev)
        self.device = dev
        self.cam = cam
        self.cfg = cfg
        self.voc = voc
        self.transport = transport
        self.sub: Dict[int, SubMap] = {}
        self._lock = threading.RLock()
        self.gmap = ms.empty(cap, dev)
        self.g_kf_ids = IdMap(cap.max_keyframes, 0, cfg.collab.client_id_stride)
        self.g_mp_ids = IdMap(cap.max_map_points, 0, cfg.collab.client_id_stride)
        self.gdb = db_mod.BowDatabase.empty(cap.max_keyframes, voc.n_words, dev)
        # Per-client alignment: sub-map world -> global world (R, t, s) —
        # subMapTransM (MapFusion.h:89). The seeding client gets identity.
        self.transMs: Dict[int, tuple] = {}
        # Broadcast cursors + snapshots (dirty tracking on the global map).
        self._bcast_kf = 0
        self._bcast_mp = 0
        self._kf_pose_snap = np.zeros((cap.max_keyframes, 4, 4), np.float32)
        self._mp_pos_snap = np.zeros((cap.max_map_points, 3), np.float32)
        self._transm_sent: tuple = ()
        # Full-map replay cursors (None = no replay in progress).
        self._resync_kf: Optional[int] = None
        self._resync_mp: Optional[int] = None
        self.gba = gba_mod.GlobalBARunner(
            cam, cfg, synchronous=synchronous_gba) if run_gba else None
        # Seam constraints accumulated across merges — the server-side
        # essential graph's loop edges (GlobalOptimize::CorrectLoop).
        self._loops = lc.LoopEdges.empty(device=dev)
        self._n_loops = 0
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.stats = {
            "kfs_received": 0, "mps_received": 0, "fusions": 0,
            "fusion_attempts": 0, "kf_updates": 0, "mp_updates": 0,
            "seam_fuses": 0, "essential_graph_runs": 0,
        }
        transport.register_handler(wire.SRV_INSERT_KFS, self.insert_keyframes)
        transport.register_handler(wire.SRV_INSERT_MPS, self.insert_mappoints)
        transport.register_handler(wire.SRV_UPDATE_KFS, self.update_kf_poses)
        transport.register_handler(wire.SRV_UPDATE_MPS, self.update_mp_positions)
        transport.register_handler(wire.SRV_RESYNC, self.request_resync)

    # ------------------------------------------------------------------
    def _t(self, a, dtype=None) -> torch.Tensor:
        """A wire or host array as a tensor on the server's device (copied:
        the wire codec's arrays are read-only views)."""
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(self.device, dtype) if dtype is not None else t.to(self.device)

    @staticmethod
    def _np(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def _submap(self, cid: int) -> SubMap:
        if cid not in self.sub:
            cap = self.cfg.capacity
            stride = self.cfg.collab.client_id_stride
            self.sub[cid] = SubMap(
                map=ms.empty(cap, self.device),
                kf_ids=IdMap(cap.max_keyframes, cid, stride),
                mp_ids=IdMap(cap.max_map_points, cid, stride),
                db=db_mod.BowDatabase.empty(cap.max_keyframes, self.voc.n_words, self.device),
            )
        return self.sub[cid]

    # ------------------------------------------------------------------
    # Service handlers (MapFusion.cpp:31-306)
    # ------------------------------------------------------------------

    def _insert_kfs_into(self, m, kf_ids, mp_ids, db, msg, align: Optional[tuple], fixed: bool):
        """Insert keyframe records into a map, optionally re-expressed by
        `align` (sub-world -> dst-world). Returns (map, db, count)."""
        gids = msg["gid"]
        idxs = np.nonzero(~kf_ids.known_mask(gids))[0]
        free = m.kf.capacity - int(m.n_kf)
        idxs = idxs[: max(free, 0)]
        dev = self.device
        for lo in range(0, len(idxs), fusion_ops.KF_CHUNK):
            sel = idxs[lo:lo + fusion_ops.KF_CHUNK]
            C = len(sel)
            Tcw = self._t(msg["Tcw"][sel])
            if align is not None:
                Tcw = fusion_ops.transform_poses(Tcw, align)
            mp_gid = msg["mp_gid"][sel]
            mp_rows = np.where(
                mp_gid >= 0, mp_ids.rows_for(mp_gid.reshape(-1)).reshape(mp_gid.shape), -1)
            m, rows = fusion_ops.insert_kf_chunk(
                m, Tcw, self._t(msg["xy"][sel]), self._t(msg["octave"][sel]),
                self._t(msg["angle"][sel]), self._t(msg["desc"][sel]),
                self._t(msg["uright"][sel]), self._t(msg["depth"][sel]),
                self._t(msg["fvalid"][sel]), self._t(mp_rows, torch.int32),
                self._t(msg["client"][sel]), self._t(msg["frame_id"][sel]),
                self._t(msg["timestamp"][sel]),
                use=torch.ones(C, dtype=torch.bool, device=dev),
                fixed=torch.full((C,), fixed, dtype=torch.bool, device=dev),
            )
            kf_ids.assign_foreign(self._np(rows), gids[sel])
            # BoW vectors for retrieval: one batched transform a chunk.
            rj = rows.long()
            bows = vocab_mod.transform_batch(self.voc, m.kf.desc[rj], m.kf.fvalid[rj])
            db = db.add_batch(rows, bows)
        return m, db, len(idxs)

    def _insert_mps_into(self, m, mp_ids, kf_ids, msg, align: Optional[tuple]):
        gids = msg["gid"]
        idxs = np.nonzero(~mp_ids.known_mask(gids))[0]
        free = m.mp.capacity - int(m.n_mp)
        idxs = idxs[: max(free, 0)]
        dev = self.device
        for lo in range(0, len(idxs), fusion_ops.MP_CHUNK):
            sel = idxs[lo:lo + fusion_ops.MP_CHUNK]
            C = len(sel)
            pos = self._t(msg["pos"][sel])
            normal = self._t(msg["normal"][sel])
            mind = self._t(msg["min_dist"][sel])
            maxd = self._t(msg["max_dist"][sel])
            if align is not None:
                R, _, s = align
                pos = sim3.transform(align, pos)
                normal = normal @ R.transpose(0, 1)
                mind = mind * s
                maxd = maxd * s
            ref_rows = kf_ids.rows_for(msg["ref_kf_gid"][sel])
            m, rows = fusion_ops.insert_mp_chunk(
                m, pos, normal, self._t(msg["desc"][sel]), mind, maxd,
                self._t(msg["client"][sel]), self._t(np.clip(ref_rows, 0, None), torch.int32),
                use=torch.ones(C, dtype=torch.bool, device=dev),
                fixed=torch.zeros(C, dtype=torch.bool, device=dev),  # the server owns all
            )
            mp_ids.assign_foreign(self._np(rows), gids[sel])
        return m, len(idxs)

    @_locked
    def insert_keyframes(self, cid: int, msg) -> bool:
        """insertKeyFrameToMap (MapFusion.cpp:31): already-fused clients
        write straight into the global map via their alignment."""
        if self.sub.get(cid) is not None and self.sub[cid].fused:
            self.gmap, self.gdb, n = self._insert_kfs_into(
                self.gmap, self.g_kf_ids, self.g_mp_ids, self.gdb, msg,
                self._align_tuple(cid), fixed=False)
        else:
            sm = self._submap(cid)
            sm.map, sm.db, n = self._insert_kfs_into(
                sm.map, sm.kf_ids, sm.mp_ids, sm.db, msg, None, fixed=False)
            sm.n_kfs_received += n
        self.stats["kfs_received"] += n
        return True

    @_locked
    def insert_mappoints(self, cid: int, msg) -> bool:
        if self.sub.get(cid) is not None and self.sub[cid].fused:
            self.gmap, n = self._insert_mps_into(
                self.gmap, self.g_mp_ids, self.g_kf_ids, msg, self._align_tuple(cid))
        else:
            sm = self._submap(cid)
            sm.map, n = self._insert_mps_into(sm.map, sm.mp_ids, sm.kf_ids, msg, None)
        self.stats["mps_received"] += n
        return True

    @_locked
    def update_kf_poses(self, cid: int, msg) -> bool:
        """updateKeyFrameToMap (MapFusion.cpp:172)."""
        fused = self.sub.get(cid) is not None and self.sub[cid].fused
        ids = self.g_kf_ids if fused else self._submap(cid).kf_ids
        rows = ids.rows_for(msg["gid"])
        sel = rows >= 0
        if not sel.any():
            return True
        Tcw = self._t(msg["Tcw"][sel])
        m = self.gmap if fused else self.sub[cid].map
        if fused:
            Tcw = fusion_ops.transform_poses(Tcw, self._align_tuple(cid))
        m.kf.Tcw[self._t(rows[sel]).long()] = Tcw
        self.stats["kf_updates"] += int(sel.sum())
        return True

    @_locked
    def update_mp_positions(self, cid: int, msg) -> bool:
        fused = self.sub.get(cid) is not None and self.sub[cid].fused
        ids = self.g_mp_ids if fused else self._submap(cid).mp_ids
        rows = ids.rows_for(msg["gid"])
        sel = rows >= 0
        if not sel.any():
            return True
        pos = self._t(msg["pos"][sel])
        m = self.gmap if fused else self.sub[cid].map
        if fused:
            pos = sim3.transform(self._align_tuple(cid), pos)
        m.mp.pos[self._t(rows[sel]).long()] = pos
        self.stats["mp_updates"] += int(sel.sum())
        return True

    def _align_tuple(self, cid: int):
        R, t, s = self.transMs[cid]
        return self._t(R), self._t(t), torch.tensor(float(s), device=self.device)

    # ------------------------------------------------------------------
    # Fusion loop (fuseSubMapToMap, MapFusion.cpp:432)
    # ------------------------------------------------------------------

    @_locked
    def fuse_step(self) -> bool:
        """One scan over unfused sub-maps; returns True if a fusion (or
        seeding) happened."""
        for cid, sm in sorted(self.sub.items()):
            if sm.fused or int(sm.map.n_kf) == 0:
                continue
            if int(self.gmap.n_kf) == 0:
                self._merge_submap(cid, sm, sim3.identity(device=self.device))
                return True
            align = self._try_align(sm)
            self.stats["fusion_attempts"] += 1
            if align is not None:
                (R, t, s), q_sub, cand_old = align
                kf_row_map = self._merge_submap(cid, sm, (R, t, s))
                self._post_fusion_optimize(int(kf_row_map[q_sub]), cand_old)
                return True
        return False

    _ALIGN_QUERY_CHUNK = 256   # sub-map keyframes BoW-scored per dispatch
    _ALIGN_VERIFY_MAX = 8      # geometric verifications per fusion attempt

    def _serve_between_steps(self):
        """Drain pending service calls of a transport that queues them (the
        socket and shm transports) at a safe boundary inside long fusion
        work, so that client uplinks are not left waiting for their ACK for
        the whole scan. The handlers run on this thread, which holds the
        lock; entities inserted mid-scan are merged by _merge_submap's own
        fresh read (or the next scan)."""
        t = getattr(self, "transport", None)
        if t is not None and hasattr(t, "serve_calls"):
            try:
                t.serve_calls()
            except Exception:
                pass

    def _try_align(self, sm: SubMap) -> Optional[tuple]:
        """detectKeyFrameInServerMap over the sub-map's keyframes
        (MapFusion.cpp:488-521), batched: every sub-map keyframe is scored
        against the whole global BoW database in blocks of up to 256 (one
        transform_batch and one pair top-k each; unlike the reference, which
        pads every block to 256 rows for a static shape, a block holds only
        the sub-map's keyframes, and the flat index q N + r of a pair does
        not depend on the block's length); only the best few (query,
        candidate) pairs get the geometric verification. Returns ((R, t,
        s), q_sub, cand_glob) — the alignment plus the seam keyframe pair
        that produced it."""
        kfv = np.nonzero(self._np(sm.map.kf.valid))[0]
        if len(kfv) == 0:
            return None
        QC = self._ALIGN_QUERY_CHUNK
        pairs = []
        for lo in range(0, len(kfv), QC):
            self._serve_between_steps()
            sel = kfv[lo:lo + QC]
            selj = self._t(sel).long()
            bows = vocab_mod.transform_batch(self.voc, sm.map.kf.desc[selj],
                                             sm.map.kf.fvalid[selj])
            q_ok = torch.ones(len(sel), dtype=torch.bool, device=self.device)
            qi, rows, vals, ok = db_mod.detect_map_fusion_pairs(
                self.gdb, self.gmap.kf.valid, bows, q_ok)
            vals_l = vals.tolist()
            qi_l, rows_l, ok_l = torch.stack([qi, rows, ok.long()]).tolist()
            for a, r, v, o in zip(qi_l, rows_l, vals_l, ok_l):
                if o:
                    pairs.append((v, int(sel[a]), r))
        pairs.sort(reverse=True)
        for _, q, r in pairs[: self._ALIGN_VERIFY_MAX]:
            self._serve_between_steps()
            res = fusion_ops.detect_overlap(self.cam, self.gmap, r, sm.map, q, self.cfg,
                                            generator=self.generator)
            if bool(res.ok):
                return (res.R, res.t, res.s), q, r
        return None

    def _merge_submap(self, cid: int, sm: SubMap, align):
        """insertServerMapToGlobleMap (MapFusion.cpp:622): transform the
        whole sub-map by `align` and append it to the global map, remapping
        landmark references; record the client's alignment; clear the
        sub-map (MapFusion.cpp:523)."""
        R, t, s = align
        dev = self.device
        moved = fusion_ops.transform_map(sm.map, R, t, s)

        # --- map points first (keyframes reference their rows) ----------
        sub_mp_rows = np.nonzero(self._np(moved.mp.valid))[0]
        mp_row_map = np.full(moved.mp.capacity, -1, np.int32)
        g = self.gmap
        for lo in range(0, len(sub_mp_rows), fusion_ops.MP_CHUNK):
            sel = sub_mp_rows[lo:lo + fusion_ops.MP_CHUNK]
            C = len(sel)
            selj = self._t(sel).long()
            g, rows = fusion_ops.insert_mp_chunk(
                g, moved.mp.pos[selj], moved.mp.normal[selj], moved.mp.desc[selj],
                moved.mp.min_dist[selj], moved.mp.max_dist[selj], moved.mp.client[selj],
                torch.zeros(C, dtype=torch.int32, device=dev),
                use=torch.ones(C, dtype=torch.bool, device=dev),
                fixed=torch.zeros(C, dtype=torch.bool, device=dev),
            )
            rows_np = self._np(rows)
            mp_row_map[sel] = rows_np
            self.g_mp_ids.assign_foreign(rows_np, sm.mp_ids.gid_of_row[sel])

        # --- keyframes with remapped observations ------------------------
        sub_kf_rows = np.nonzero(self._np(moved.kf.valid))[0]
        kf_row_map = np.full(moved.kf.capacity, -1, np.int32)
        mp_idx_all = self._np(moved.kf.mp_idx)
        for lo in range(0, len(sub_kf_rows), fusion_ops.KF_CHUNK):
            sel = sub_kf_rows[lo:lo + fusion_ops.KF_CHUNK]
            C = len(sel)
            selj = self._t(sel).long()
            mp_idx = mp_idx_all[sel]
            mp_idx = np.where(mp_idx >= 0, mp_row_map[np.clip(mp_idx, 0, None)], -1)
            g, rows = fusion_ops.insert_kf_chunk(
                g, moved.kf.Tcw[selj], moved.kf.xy[selj], moved.kf.octave[selj],
                moved.kf.angle[selj], moved.kf.desc[selj], moved.kf.uright[selj],
                moved.kf.depth[selj], moved.kf.fvalid[selj], self._t(mp_idx, torch.int32),
                moved.kf.client[selj], moved.kf.frame_id[selj], moved.kf.timestamp[selj],
                use=torch.ones(C, dtype=torch.bool, device=dev),
                fixed=torch.zeros(C, dtype=torch.bool, device=dev),
            )
            rows_np = self._np(rows)
            kf_row_map[sel] = rows_np
            self.g_kf_ids.assign_foreign(rows_np, sm.kf_ids.gid_of_row[sel])
            rj = rows.long()
            bows = vocab_mod.transform_batch(self.voc, g.kf.desc[rj], g.kf.fvalid[rj])
            self.gdb = self.gdb.add_batch(rows, bows)

        # --- second pass: remap landmark reference keyframes --------------
        # MP chunks were inserted before the keyframes (KFs reference MP
        # rows), so their ref_kf anchors could not be remapped inline; fix
        # them up now so server-side correction propagation (GBA merge-back,
        # essential-graph writeback) moves these points with their true
        # anchor instead of the pinned gauge keyframe.
        ins_mp = sub_mp_rows[mp_row_map[sub_mp_rows] >= 0]
        if len(ins_mp):
            old_ref = self._np(moved.mp.ref_kf)[ins_mp]
            new_ref = np.where(old_ref >= 0, kf_row_map[np.clip(old_ref, 0, None)], -1)
            g.mp.ref_kf[self._t(mp_row_map[ins_mp]).long()] = self._t(
                np.clip(new_ref, 0, None), torch.int32)

        self.gmap = g
        self.transMs[cid] = (self._np(R), self._np(t), float(s))
        sm.fused = True
        # Clear the sub-map (its content now lives in the global map).
        cap = self.cfg.capacity
        sm.map = ms.empty(cap, dev)
        sm.db = db_mod.BowDatabase.empty(cap.max_keyframes, self.voc.n_words, dev)
        self.stats["fusions"] += 1
        return kf_row_map

    def _post_fusion_optimize(self, kf_q: int, kf_c: int):
        """GlobalOptimize::CorrectLoop (GlobalOptimize.cpp:228-433) after a
        merge, on the server's own global map:

        1. cross-seam SearchAndFuse — project the OLD side's local landmarks
           into the newly merged seam keyframe (and, through relabeled
           bindings, its covisible window) and collapse duplicate landmarks
           (GlobalOptimize.cpp:406 / SearchAndFuse);
        2. essential-graph optimization with the accumulated seam edges
           (GlobalOptimize.cpp:389 -> OptimizeEssentialGraph) — a no-op for
           the first seam (the merge already applied the rigid alignment),
           but it re-distributes error once several seams/updates constrain
           the same keyframes;
        3. global bundle adjustment (GlobalOptimize.cpp:399,435).

        Corrected poses/positions re-broadcast automatically through the
        snapshot-diff in broadcast_step."""
        # 1. Old-side points into the seam keyframe, then seam-side points
        # back into the old candidate keyframe.
        self.gmap = lc.fuse_loop_points(self.cam, self.gmap, kf_q, kf_c, self.cfg)
        self.gmap = lc.fuse_loop_points(self.cam, self.gmap, kf_c, kf_q, self.cfg)
        self.stats["seam_fuses"] += 1
        self._serve_between_steps()

        # 2. Essential graph over the merged map with the seam edge. The
        # measurement is the CURRENT relative Sim3 (the seam is consistent
        # right after the rigid merge).
        Sq = sim3.from_se3(self.gmap.kf.Tcw[kf_q])
        Sc = sim3.from_se3(self.gmap.kf.Tcw[kf_c])
        Rqc, tqc, sqc = sim3.compose(Sq, sim3.inverse(Sc))
        slot = self._n_loops % lc.MAX_LOOP_EDGES
        self._loops = self._loops.add(slot, kf_c, kf_q, Rqc, tqc, sqc)
        self._n_loops += 1
        self.gmap, _costs = lc.optimize_essential_graph(
            self.gmap, self._loops, kf_c, self.gmap.kf.Tcw.clone(), self.cfg,
            n_iters=self.cfg.loop.pose_graph_iters)
        self.stats["essential_graph_runs"] += 1
        self._serve_between_steps()

        # 3. Global BA.
        if self.gba is not None:
            self.gba.launch(self.gmap)
            self.gmap = self.gba.try_merge(self.gmap)

    # ------------------------------------------------------------------
    # Broadcast loop (runPubTopic, MapFusion.cpp:315 + PubToClient.cpp)
    # ------------------------------------------------------------------

    def _publish_mp_rows(self, rows: np.ndarray, trans):
        """Publish one batch of global map-point rows on TOPIC_NEW_MPS."""
        m = self.gmap
        rj = self._t(rows).long()
        msg = wire.mp_insert_msg(
            gid=self.g_mp_ids.gid_of_row[rows], client=self._np(m.mp.client[rj]),
            pos=self._np(m.mp.pos[rj]), normal=self._np(m.mp.normal[rj]),
            desc=self._np(m.mp.desc[rj]), min_dist=self._np(m.mp.min_dist[rj]),
            max_dist=self._np(m.mp.max_dist[rj]),
            ref_kf_gid=np.full(len(rows), -1, np.int64),
        )
        msg.update(trans)
        self.transport.publish(wire.TOPIC_NEW_MPS, msg)

    def _publish_kf_rows(self, rows: np.ndarray, trans):
        """Publish one batch of global keyframe rows on TOPIC_NEW_KFS."""
        m = self.gmap
        rj = self._t(rows).long()
        mp_idx = self._np(m.kf.mp_idx[rj])
        mp_gid = np.where(mp_idx >= 0, self.g_mp_ids.gid_of_row[np.clip(mp_idx, 0, None)], -1)
        msg = wire.kf_insert_msg(
            gid=self.g_kf_ids.gid_of_row[rows], client=self._np(m.kf.client[rj]),
            Tcw=self._np(m.kf.Tcw[rj]), xy=self._np(m.kf.xy[rj]),
            octave=self._np(m.kf.octave[rj]), angle=self._np(m.kf.angle[rj]),
            desc=self._np(m.kf.desc[rj]), uright=self._np(m.kf.uright[rj]),
            depth=self._np(m.kf.depth[rj]), fvalid=self._np(m.kf.fvalid[rj]), mp_gid=mp_gid,
            frame_id=self._np(m.kf.frame_id[rj]), timestamp=self._np(m.kf.timestamp[rj]),
        )
        # Ship the BoW vectors the server already computed for its own
        # database in sparse form: the first F nonzero words of each row in
        # ascending order (the reference ships mBowVec inside the serialized
        # KeyFrame the same way, KeyFrame.h:60-87).
        bow = self.gdb.bow[rj]                                   # [K, W]
        W, F = bow.shape[1], m.kf.n_features
        word = torch.arange(W, dtype=torch.int32, device=bow.device).expand_as(bow)
        key = torch.where(bow != 0, word, torch.full_like(word, W))
        ids = torch.sort(key, dim=1)[0][:, :F]
        hit = ids < W
        vals = torch.gather(bow, 1, ids.clamp(max=W - 1).long())
        msg["bow_ids"] = self._np(torch.where(hit, ids, torch.full_like(ids, -1)))
        msg["bow_vals"] = self._np(torch.where(hit, vals, torch.zeros_like(vals)))
        msg.update(trans)
        self.transport.publish(wire.TOPIC_NEW_KFS, msg)

    @_locked
    def request_resync(self, cid: int, msg=None) -> bool:
        """SRV_RESYNC handler: a (late-joining or message-dropping) client
        asks for the whole global map again. Replay starts from row 0 and
        proceeds in resend_chunk_* batches per broadcast tick — the
        reference's chunked resentGlobalMapToClient (MapFusion.cpp:403-423)
        as a pull. Receivers that already know a gid skip it
        (ClientCache._fresh_foreign), so replay is idempotent for everyone
        else on the topic."""
        self._resync_kf = 0
        self._resync_mp = 0
        return True

    def _resync_chunk(self, trans):
        """Emit one chunk of the in-progress full-map replay. All map-point
        chunks go out before the first keyframe chunk: a replayed keyframe
        references map-point gids by its observations, and a receiver that
        does not know them yet would bind -1 and then skip the (now known)
        keyframe gid on every later replay."""
        if self._resync_mp is not None:
            hi = min(self._resync_mp + self.cfg.collab.resend_chunk_mps, self._bcast_mp)
            rows = np.arange(self._resync_mp, hi)
            if len(rows):
                rows = rows[self._np(self.gmap.mp.valid[self._t(rows).long()])]
            if len(rows):
                self._publish_mp_rows(rows, trans)
            self._resync_mp = hi if hi < self._bcast_mp else None
            return
        if self._resync_kf is not None:
            hi = min(self._resync_kf + self.cfg.collab.resend_chunk_kfs, self._bcast_kf)
            rows = np.arange(self._resync_kf, hi)
            if len(rows):
                rows = rows[self._np(self.gmap.kf.valid[self._t(rows).long()])]
            if len(rows):
                self._publish_kf_rows(rows, trans)
            self._resync_kf = hi if hi < self._bcast_kf else None

    @_locked
    def broadcast_step(self):
        """Publish new global-map entities and changed poses/positions with
        the per-client TRANSM attached."""
        m = self.gmap
        trans = wire.transm_msg(self.transMs)
        n_kf, n_mp = int(m.n_kf), int(m.n_mp)

        # TRANSM heartbeat: a client fused AFTER the map contents went out
        # would otherwise never see its alignment (no new entities -> no
        # messages -> no TRANSM side channel). When the alignment set
        # changes, push one empty pose-delta message whose only payload is
        # the TRANSM map.
        tkey = tuple(sorted(self.transMs.keys()))
        if tkey != self._transm_sent:
            hb = wire.kf_pose_msg(np.zeros(0, np.int64), np.zeros((0, 4, 4), np.float32))
            hb.update(trans)
            self.transport.publish(wire.TOPIC_UPD_KFS, hb)
            self._transm_sent = tkey

        # New map points since last broadcast.
        if n_mp > self._bcast_mp:
            rows = np.arange(self._bcast_mp, n_mp)
            rows = rows[self._np(m.mp.valid[self._bcast_mp:n_mp])]
            if len(rows):
                self._publish_mp_rows(rows, trans)
            self._mp_pos_snap[self._bcast_mp:n_mp] = self._np(m.mp.pos[self._bcast_mp:n_mp])
            self._bcast_mp = n_mp

        # New keyframes since last broadcast.
        if n_kf > self._bcast_kf:
            rows = np.arange(self._bcast_kf, n_kf)
            rows = rows[self._np(m.kf.valid[self._bcast_kf:n_kf])]
            if len(rows):
                self._publish_kf_rows(rows, trans)
            self._kf_pose_snap[self._bcast_kf:n_kf] = self._np(m.kf.Tcw[self._bcast_kf:n_kf])
            self._bcast_kf = n_kf

        # In-progress full-map replay for late joiners (MP chunk first so
        # the KF chunk's observation gids resolve on arrival).
        if self._resync_mp is not None or self._resync_kf is not None:
            self._resync_chunk(trans)

        # Updated poses / positions among already-broadcast rows.
        if self._bcast_kf > 0:
            Tcw = self._np(m.kf.Tcw[: self._bcast_kf])
            moved = (
                np.abs(Tcw - self._kf_pose_snap[: self._bcast_kf])
                .reshape(len(Tcw), -1).max(axis=1) > 1e-7
            ) & self._np(m.kf.valid[: self._bcast_kf])
            rows = np.nonzero(moved)[0]
            if len(rows):
                msg = wire.kf_pose_msg(self.g_kf_ids.gid_of_row[rows], Tcw[rows])
                msg.update(trans)
                self.transport.publish(wire.TOPIC_UPD_KFS, msg)
                self._kf_pose_snap[rows] = Tcw[rows]

        if self._bcast_mp > 0:
            pos = self._np(m.mp.pos[: self._bcast_mp])
            movedp = (
                np.abs(pos - self._mp_pos_snap[: self._bcast_mp]).max(axis=1) > 1e-7
            ) & self._np(m.mp.valid[: self._bcast_mp])
            rows = np.nonzero(movedp)[0]
            if len(rows):
                msg = wire.mp_pos_msg(self.g_mp_ids.gid_of_row[rows], pos[rows])
                msg.update(trans)
                self.transport.publish(wire.TOPIC_UPD_MPS, msg)
                self._mp_pos_snap[rows] = pos[rows]
