"""Loop closing (port of `corbslam_tpu/loop/loop_closing.py`: `Sim3Between`,
`compute_sim3`, `LoopEdges`, `build_essential_graph`, `correct_window`,
`optimize_essential_graph`, `fuse_loop_points`, `LoopCloser`).

Detection is one dense BoW score over the database (K9); verification
matches the two keyframes' bound features (K5), runs Sim3 RANSAC and its
refinement (K10), widens by projection (K7 window, K5) and refines the
query pose against the candidate side's points (K6); correction moves the
query's covisible window, fuses the duplicate points (K5 again), and runs
the essential-graph Sim3 pose graph (K11, with its [N, N] covisibility
count). The host keeps only the consistency groups and reads one flag per
verified candidate. With `run_gba` a closure aborts the running global BA
first and launches a new one last (`loop/gba.GlobalBARunner`, K8 in a worker
thread); `try_merge_gba` folds a finished one into the map.

RNG lineage: the reference draws each RANSAC sample from a key split off
`PRNGKey(seed)`; the port draws from a `torch.Generator` seeded with the
same seed on the map's device, so the two packages sample differently and a
run is compared by outcome (which loop, inlier counts, ATE).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3, sim3
from ..mapping import local_mapping
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..optim import pose_graph as pg
from ..optim import pose_opt
from ..place import database as db_mod
from ..place import vocab as vocab_mod
from ..solvers import sim3_solver
from . import gba as gba_mod

MAX_LOOP_EDGES = 32       # loop edges remembered (KeyFrame::mspLoopEdges)
ESSENTIAL_MIN_WEIGHT = 100  # strong covisibility of the essential graph (Optimizer.cc:840)


class Sim3Between(NamedTuple):
    R: torch.Tensor        # candidate-cam -> query-cam rotation
    t: torch.Tensor
    s: torch.Tensor
    n_bow: torch.Tensor    # descriptor matches between bound features
    n_inliers: torch.Tensor
    n_total: torch.Tensor  # widened projection matches
    ok: torch.Tensor


def _scales(cfg: SlamConfig, dev) -> torch.Tensor:
    return torch.tensor(cfg.orb.scales(), dtype=torch.float32, device=dev)


def _widen_rows(m: ms.MapState, kf_c: int, cfg: SlamConfig):
    """The candidate side's local map: its covisible window (itself pinned
    first) and their points, compacted to 2F rows."""
    nb_rows, nb_ok = covis.top_covisible_of(m, kf_c, cfg.capacity.local_window_kfs,
                                            self_weight=covis.SELF_WEIGHT_PINNED)
    pmask = covis.local_map_mask(m, nb_rows, nb_ok)
    return covis.compact_indices(pmask, m.kf.n_features * 2)


class Sim3Matches(NamedTuple):
    p1: torch.Tensor       # [F, 3] query-camera coordinates of the query's points
    p2: torch.Tensor       # [F, 3] candidate-camera coordinates of the matched points
    pair_ok: torch.Tensor  # [F]
    s2_q: torch.Tensor     # [F] octave sigma^2, query
    s2_c: torch.Tensor     # [F] octave sigma^2, matched candidate feature


def sim3_matches(m: ms.MapState, kf_q: int, kf_c: int, cfg: SlamConfig) -> Sim3Matches:
    """The RANSAC's correspondences: the points bound to each keyframe's
    features, matched by descriptor (the SearchByBoW stand-in, K5)."""
    mp_q, mp_c = m.kf.mp_idx[kf_q], m.kf.mp_idx[kf_c]
    res = matcher.search_by_descriptor(
        m.kf.desc[kf_q], m.kf.fvalid[kf_q] & (mp_q >= 0), m.kf.desc[kf_c],
        m.kf.fvalid[kf_c] & (mp_c >= 0), max_dist=cfg.matcher.th_low, ratio=0.75)
    ci = res.idx.clamp_min(0).long()
    mp_c_matched = mp_c[ci]
    sf2 = cfg.orb.scale_factor ** 2
    return Sim3Matches(
        se3.transform(m.kf.Tcw[kf_q], m.mp.pos[mp_q.clamp_min(0).long()]).contiguous(),
        se3.transform(m.kf.Tcw[kf_c], m.mp.pos[mp_c_matched.clamp_min(0).long()]).contiguous(),
        (res.idx >= 0) & (mp_c_matched >= 0),
        (sf2 ** m.kf.octave[kf_q].to(torch.float32)).contiguous(),
        (sf2 ** m.kf.octave[kf_c][ci].to(torch.float32)).contiguous())


def compute_sim3(cam, m: ms.MapState, kf_q: int, kf_c: int, cfg: SlamConfig,
                 fix_scale: bool = True, generator: Optional[torch.Generator] = None,
                 sample: Optional[torch.Tensor] = None) -> Sim3Between:
    """Sim3 candidate -> query (LoopClosing::ComputeSim3, LoopClosing.cc:233):
    match the points bound to each keyframe's features, Horn RANSAC in the
    two camera frames (`sample` [256, 3] overrides the draw), the iterative
    refinement, the projection widening, then three rounds of the query
    pose against the candidate side's points; the refined pose folds back
    into the Sim3. Non-finite poses are replaced, never kept."""
    dev = m.kf.Tcw.device
    p1, p2, pair_ok, s2_q, s2_c = sim3_matches(m, kf_q, kf_c, cfg)
    n_bow = pair_ok.sum(dtype=torch.int32)
    Tc = m.kf.Tcw[kf_c]
    att = sim3_solver.solve_and_refine_sim3(
        cam, cam, p1, p2, pair_ok, s2_q, s2_c, generator=generator, n_hyp=256,
        min_inliers=cfg.loop.min_sim3_inliers, fix_scale=fix_scale, idx=sample, n_rounds=3)
    ransac, R, t, s, n_inliers = att.ransac, att.R, att.t, att.s, att.n_inliers

    rows, rows_ok = _widen_rows(m, kf_c, cfg)
    r = rows.long()
    Rq = R @ Tc[:3, :3]
    tq = s * (R @ Tc[:3, 3]) + t
    T_pred = torch.eye(4, device=dev)
    T_pred[:3, :3] = Rq
    T_pred[:3, 3] = tq / s.clamp_min(1e-9)
    scales = _scales(cfg, dev)
    mp_args = (m.mp.pos[r], m.mp.desc[r], rows_ok, m.mp.min_dist[r], m.mp.max_dist[r],
               m.mp.normal[r])
    feat_args = (m.kf.xy[kf_q], m.kf.octave[kf_q], m.kf.desc[kf_q], m.kf.fvalid[kf_q])

    def search(T, radius):
        out, _ = matcher.search_by_projection_points(
            cam, T, *mp_args, *feat_args, scales, cfg.orb.scale_factor, radius=radius,
            max_dist=cfg.matcher.th_low, ratio=1.0, view_cos_limit=-1.0)
        return out

    res2 = search(T_pred, 7.5)
    n_total = (res2.idx >= 0).sum(dtype=torch.int32)
    obs_q = torch.cat([m.kf.xy[kf_q], m.kf.uright[kf_q][:, None]], dim=-1).contiguous()
    octv = m.kf.octave[kf_q].to(torch.float32)
    inv_s2 = (1.0 / (cfg.orb.scale_factor ** (2.0 * octv))).contiguous()
    is_stereo = (m.kf.uright[kf_q] > 0).contiguous()
    X_rows = m.mp.pos[r]

    def pose(T0, match):
        return pose_opt.optimize_pose(cam, T0.contiguous(),
                                      X_rows[match.idx.clamp_min(0).long()].contiguous(), obs_q,
                                      inv_s2, is_stereo, (match.idx >= 0).contiguous())

    def widen_and_opt(T0, radius):
        p = pose(T0, search(T0, radius))
        pok = torch.isfinite(p.Tcw).all()
        return torch.where(pok, p.Tcw, T0), p.n_inliers, pok

    po = pose(T_pred, res2)
    T_ref = torch.where(torch.isfinite(po.Tcw).all(), po.Tcw, T_pred)
    T_ref, n_po, ok2 = widen_and_opt(T_ref, 7.5)
    T_ref, n_po2, ok3 = widen_and_opt(T_ref, 4.0)
    po_n = torch.where(ok3, n_po2, torch.where(ok2, n_po, po.n_inliers))
    po_ok = torch.isfinite(T_ref).all() & (po_n >= cfg.loop.min_total_matches)
    R_rel = T_ref[:3, :3] @ Tc[:3, :3].T
    t_rel = s * (T_ref[:3, 3] - R_rel @ Tc[:3, 3])
    R = torch.where(po_ok, R_rel, R)
    t = torch.where(po_ok, t_rel, t)
    n_total = torch.where(po_ok, po_n, n_total)
    ok = (ransac.ok & po_ok & (n_inliers >= cfg.loop.min_sim3_inliers)
          & (n_bow >= cfg.loop.min_bow_matches) & (n_total >= cfg.loop.min_total_matches))
    return Sim3Between(R, t, s, n_bow, n_inliers, n_total, ok)


class LoopEdges(NamedTuple):
    """Accepted loop closures, fixed capacity (KeyFrame::mspLoopEdges)."""

    i: torch.Tensor      # [L] candidate keyframe row
    j: torch.Tensor      # [L] query keyframe row
    R: torch.Tensor      # [L, 3, 3] Sim3 candidate -> query at acceptance
    t: torch.Tensor      # [L, 3]
    s: torch.Tensor      # [L]
    valid: torch.Tensor  # [L]

    @staticmethod
    def empty(capacity: int = MAX_LOOP_EDGES, device="cpu") -> "LoopEdges":
        return LoopEdges(
            torch.zeros(capacity, dtype=torch.int32, device=device),
            torch.zeros(capacity, dtype=torch.int32, device=device),
            torch.eye(3, device=device).repeat(capacity, 1, 1),
            torch.zeros(capacity, 3, device=device), torch.ones(capacity, device=device),
            torch.zeros(capacity, dtype=torch.bool, device=device))

    def add(self, n: int, kf_c: int, kf_q: int, R, t, s) -> "LoopEdges":
        """Slot n (a host int, written once) := the edge."""
        out = LoopEdges(*(x.clone() for x in self))
        out.i[n], out.j[n] = kf_c, kf_q
        out.R[n], out.t[n], out.s[n] = R, t, s
        out.valid[n] = True
        return out


def _is_loop_pair(loops: LoopEdges, a, b) -> torch.Tensor:
    li, lj = loops.i[None, :], loops.j[None, :]
    hit = ((a[:, None] == li) & (b[:, None] == lj)) | ((a[:, None] == lj) & (b[:, None] == li))
    return (loops.valid[None, :] & hit).any(dim=1)


def build_essential_graph(m: ms.MapState, loops: LoopEdges, fixed_row: int,
                          meas_Tcw: torch.Tensor, covis_k: int = 8,
                          min_weight: int = ESSENTIAL_MIN_WEIGHT) -> pg.PoseGraph:
    """The essential graph's Sim3 pose graph (OptimizeEssentialGraph,
    Optimizer.cc:840): the spanning chain, the top-k strong covisibility
    edges of each row's upper triangle (`lax.top_k` order) and the loop
    edges; a pair held by a loop edge gets no odometry edge. Measurements
    from the pre-correction snapshot `meas_Tcw`, loop edges with their
    accepted Sim3; vertices from the current poses. E = N + N k + L."""
    N = m.kf.capacity
    dev = meas_Tcw.device
    Rm, tm = meas_Tcw[:, :3, :3], meas_Tcw[:, :3, 3]
    sm = torch.ones(N, device=dev)
    parent = covis.spanning_parents(m)
    sp_i = parent.clamp_min(0)
    sp_j = torch.arange(N, dtype=torch.int32, device=dev)
    sp_ok = (parent >= 0) & m.kf.valid

    W = covis.covis_matrix(m)
    live = m.kf.valid[:, None] & m.kf.valid[None, :]
    upper = torch.ones(N, N, dtype=torch.bool, device=dev).triu(1)
    Wu = torch.where(live & upper, W, torch.zeros_like(W))
    cv_vals, cv_j = covis.topk_stable(Wu, covis_k)
    cv_j = cv_j.to(torch.int32)
    cv_i = torch.arange(N, dtype=torch.int32, device=dev)[:, None].expand(N, covis_k)
    cv_ok = (cv_vals >= min_weight) & (cv_i != sp_i[cv_j.long()])
    sp_ok &= ~_is_loop_pair(loops, sp_i, sp_j)
    cv_ok &= ~_is_loop_pair(loops, cv_i.reshape(-1), cv_j.reshape(-1)).view(N, covis_k)

    e_i = torch.cat([sp_i, cv_i.reshape(-1), loops.i])
    e_j = torch.cat([sp_j, cv_j.reshape(-1), loops.j])
    e_ok = torch.cat([sp_ok, cv_ok.reshape(-1), loops.valid]) & (e_i != e_j)
    a, b = e_i.long(), e_j.long()
    mR, mt, msc = sim3.compose((Rm[b], tm[b], sm[b]), sim3.inverse((Rm[a], tm[a], sm[a])))
    n_base = N + N * covis_k
    mR[n_base:], mt[n_base:], msc[n_base:] = loops.R, loops.t, loops.s

    fixed = ~m.kf.valid | m.kf.fixed
    fixed[fixed_row] = True
    fixed[0] = True  # gauge: the first keyframe
    E = e_i.shape[0]
    return pg.PoseGraph(m.kf.Tcw[:, :3, :3].contiguous(), m.kf.Tcw[:, :3, 3].contiguous(),
                        torch.ones(N, device=dev), fixed, e_i.contiguous(), e_j.contiguous(),
                        mR.contiguous(), mt.contiguous(), msc.contiguous(), e_ok,
                        torch.ones(E, device=dev))


def _pose_rows(R, t, s):
    """[N, 4, 4] with the scale folded into the translation (t / s)."""
    T = torch.eye(4, dtype=R.dtype, device=R.device).repeat(R.shape[0], 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = t / s.clamp_min(1e-9)[:, None]
    return se3.orthonormalize_fast(T)


def _move_points(m: ms.MapState, S_old, S_new, movable):
    """p' = S_new(anchor)^-1 (S_old(anchor) p) for the movable points."""
    anchor = m.mp.ref_kf.clamp_min(0).long()
    mp_move = m.mp.valid & ~m.mp.fixed & movable[anchor]
    p_cam = sim3.transform(tuple(x[anchor] for x in S_old), m.mp.pos)
    p_new = sim3.transform(sim3.inverse(tuple(x[anchor] for x in S_new)), p_cam)
    return torch.where(mp_move[:, None], p_new, m.mp.pos)


def correct_window(m: ms.MapState, kf_q: int, kf_c: int, R_qc, t_qc, s_qc, cfg: SlamConfig):
    """First-order loop correction of the query's covisible window
    (LoopClosing.cc:430-520): each window keyframe i gets S_iw = (T_i o
    T_q^-1) o S_qc o S_cw; points anchored in the window follow their anchor.
    In place; returns (map, window mask [N])."""
    w = covis.covis_weights_single(m, kf_q) * m.kf.valid
    window = (w > 0) & m.kf.valid
    window[kf_q] = True
    window &= ~m.kf.fixed
    Sq_corr = sim3.compose((R_qc, t_qc, s_qc), sim3.from_se3(m.kf.Tcw[kf_c]))
    T_iq = m.kf.Tcw @ se3.inverse(m.kf.Tcw[kf_q])
    S_corr = sim3.compose(sim3.from_se3(T_iq), tuple(x[None] for x in Sq_corr))
    S_old = sim3.from_se3(m.kf.Tcw)
    m.mp.pos.copy_(_move_points(m, S_old, S_corr, window))
    m.kf.Tcw.copy_(torch.where(window[:, None, None], _pose_rows(*S_corr), m.kf.Tcw))
    return m, window


def optimize_essential_graph(m: ms.MapState, loops: LoopEdges, fixed_row: int,
                             meas_Tcw: torch.Tensor, cfg: SlamConfig, n_iters: int = 20):
    """The essential graph's pose graph (20 x 40 CG) and its writeback: poses
    of live, non-fixed keyframes, points by their anchor's current ->
    optimized move (Optimizer.cc:1032-1110). In place; returns (map, costs)."""
    S_old = (m.kf.Tcw[:, :3, :3].clone(), m.kf.Tcw[:, :3, 3].clone(),
             torch.ones(m.kf.capacity, device=m.kf.Tcw.device))
    g = build_essential_graph(m, loops, fixed_row, meas_Tcw)
    (R, t, s), costs = pg.optimize(g, n_iters=n_iters, cg_iters=40)
    writable = m.kf.valid & ~m.kf.fixed
    m.kf.Tcw.copy_(torch.where(writable[:, None, None], _pose_rows(R, t, s), m.kf.Tcw))
    m.mp.pos.copy_(_move_points(m, S_old, (R, t, s), writable))
    return m, costs


def fuse_loop_points(cam, m: ms.MapState, kf_q: int, kf_c: int, cfg: SlamConfig) -> ms.MapState:
    """SearchAndFuse (LoopClosing.cc:594): the loop side's local points into
    the corrected query keyframe, merging duplicates over the whole table."""
    rows, rows_ok = _widen_rows(m, kf_c, cfg)
    return local_mapping.fuse_rows_into_kf(cam, m, kf_q, rows, rows_ok, cfg, radius=4.0,
                                           full_relabel=True)


@dataclass
class _ConsistentGroup:
    rows: set
    count: int


@dataclass
class LoopCloserStats:
    n_detections: int = 0
    n_sim3_attempts: int = 0
    n_loops_closed: int = 0
    last_loop: Optional[tuple] = None  # (kf_q, kf_c)
    # (kf_q, kf_c, n_bow, n_inliers, n_total, ok) of the latest attempts
    sim3_log: list = field(default_factory=list)

    def log_sim3(self, kf_q, kf_c, sb, cap: int = 64):
        vals = torch.stack([sb.n_bow.to(torch.int32), sb.n_inliers.to(torch.int32),
                            sb.n_total.to(torch.int32), sb.ok.to(torch.int32)]).tolist()
        self.sim3_log.append((int(kf_q), int(kf_c), vals[0], vals[1], vals[2], bool(vals[3])))
        if len(self.sim3_log) > cap:
            del self.sim3_log[: len(self.sim3_log) - cap]


class LoopCloser:
    """Loop closing for one client map: the consistency groups of
    LoopClosing::DetectLoop (LoopClosing.cc:150-231) on the host, the rest
    on the device."""

    def __init__(self, cam: cam_mod.Intrinsics, cfg: SlamConfig, voc: vocab_mod.Vocabulary,
                 fix_scale: bool = True, run_gba: bool = True, seed: int = 0):
        self.cam = cam
        self.cfg = cfg
        self.voc = voc
        self.device = voc.words.device
        sim3_solver.check_capacity(cfg.capacity.max_features, self.device)
        covis.check_capacity(cfg.capacity.max_keyframes, cfg.capacity.max_features,
                             self.device)
        self.fix_scale = fix_scale
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.stats = LoopCloserStats()
        self.gba_runner = gba_mod.GlobalBARunner(cam, cfg) if run_gba else None
        self.reset()

    def reset(self):
        """Tracking::Reset's share (Tracking.cc:1533): empty database, loop
        edges and consistency state; a running global BA is aborted."""
        self.db = db_mod.BowDatabase.empty(self.cfg.capacity.max_keyframes, self.voc.n_words,
                                           self.device)
        self.loops = LoopEdges.empty(device=self.device)
        self.n_loops = 0
        self.consistent_groups: List[_ConsistentGroup] = []
        self.last_loop_kf = -(10 ** 9)
        if self.gba_runner is not None:
            self.gba_runner.abort()

    def compute_bow(self, m: ms.MapState, kf_row: int, out=None) -> torch.Tensor:
        return vocab_mod.transform(self.voc, m.kf.desc[kf_row], m.kf.fvalid[kf_row], out=out)

    def process_keyframe(self, m: ms.MapState, kf_row: int) -> ms.MapState:
        """Add the keyframe's BoW to the database (written into its row), then
        detect, verify and correct; returns the (possibly corrected) map."""
        bow = self.compute_bow(m, kf_row, out=self.db.bow[kf_row])
        self.db.add(kf_row)
        if kf_row < 10 or kf_row - self.last_loop_kf < 10:  # LoopClosing.cc:111
            self.consistent_groups = []
            return m
        cand_rows, cand_ok = db_mod.detect_loop_candidates(self.db, m, kf_row, bow, k=8)
        rows, ok = torch.stack([cand_rows, cand_ok.to(torch.int32)]).tolist()
        cand = [r for r, o in zip(rows, ok) if o]
        if not cand:
            self.consistent_groups = []
            return m
        self.stats.n_detections += 1
        for kf_c in self._update_consistency(m, cand):
            self.stats.n_sim3_attempts += 1
            sb = compute_sim3(self.cam, m, kf_row, kf_c, self.cfg, fix_scale=self.fix_scale,
                              generator=self.generator)
            self.stats.log_sim3(kf_row, kf_c, sb)
            if not self.stats.sim3_log[-1][5]:
                continue
            return self.close_loop(m, kf_row, kf_c, sb)
        return m

    def _update_consistency(self, m: ms.MapState, cand: List[int]) -> List[int]:
        """Covisibility-consistency filtering (LoopClosing.cc:150-231): a
        candidate fires once its group was re-detected in
        covisibility_consistency_th consecutive keyframes."""
        grp, gok = covis.covis_groups_rows(
            m, torch.tensor(cand, dtype=torch.int32, device=m.kf.valid.device), n_group=24)
        grp_l, gok_l = grp.tolist(), gok.tolist()
        enough, new_groups = [], []
        for ci, c in enumerate(cand):
            group = {g for g, o in zip(grp_l[ci], gok_l[ci]) if o} | {c}
            consistent = False
            for prev in self.consistent_groups:
                if group & prev.rows:
                    cnt = prev.count + 1
                    new_groups.append(_ConsistentGroup(group, cnt))
                    consistent = True
                    if cnt >= self.cfg.loop.covisibility_consistency_th:
                        enough.append(c)
                    break
            if not consistent:
                new_groups.append(_ConsistentGroup(group, 0))
        self.consistent_groups = new_groups
        return enough

    def close_loop(self, m: ms.MapState, kf_q: int, kf_c: int, sb: Sim3Between) -> ms.MapState:
        """CorrectLoop (LoopClosing.cc:404): abort a running global BA,
        correct the window, fuse the duplicates, record the edge, optimize
        the essential graph, then launch a new global BA."""
        if self.gba_runner is not None:
            self.gba_runner.abort()
        meas_Tcw = m.kf.Tcw.clone()  # pre-correction snapshot (NonCorrectedSim3)
        m, _ = correct_window(m, kf_q, kf_c, sb.R, sb.t, sb.s, self.cfg)
        m = fuse_loop_points(self.cam, m, kf_q, kf_c, self.cfg)
        self.loops = self.loops.add(self.n_loops % MAX_LOOP_EDGES, kf_c, kf_q, sb.R, sb.t, sb.s)
        self.n_loops += 1
        m, _ = optimize_essential_graph(m, self.loops, kf_c, meas_Tcw, self.cfg,
                                        n_iters=self.cfg.loop.pose_graph_iters)
        self.last_loop_kf = kf_q
        self.stats.n_loops_closed += 1
        self.stats.last_loop = (kf_q, kf_c)
        self.consistent_groups = []
        if self.gba_runner is not None:
            self.gba_runner.launch(m)
        return m

    def remap_rows(self, res: ms.CompactResult):
        """Follow a map compaction: database rows, loop edges, last loop row;
        a running global BA holds the old row numbers and is aborted."""
        self.db = self.db.reorder(res.kf_order, res.m.n_kf)
        kmap = res.kf_old2new
        li = kmap[self.loops.i.clamp_min(0).long()]
        lj = kmap[self.loops.j.clamp_min(0).long()]
        self.loops = self.loops._replace(i=li.clamp_min(0), j=lj.clamp_min(0),
                                         valid=self.loops.valid & (li >= 0) & (lj >= 0))
        self.consistent_groups = []
        if self.last_loop_kf >= 0:
            nl = int(kmap[self.last_loop_kf])
            self.last_loop_kf = nl if nl >= 0 else -(10 ** 9)
        if self.gba_runner is not None:
            self.gba_runner.abort()

    def try_merge_gba(self, m: ms.MapState) -> ms.MapState:
        """The map with a finished global BA folded in (a new MapState), or
        the same map when none is waiting."""
        if self.gba_runner is None:
            return m
        return self.gba_runner.try_merge(m)
