"""K10's and K12's, K3's and K10's, K1's and K4's, K2's and K6's, K5's and K11's, K7's
and K8's calls and launches, timed on the card.

    python -m corbslam_tpu_torch.kernel_times [--out PATH]
        [--parts k10k12,k3k10,k1k4,k6k2,k6sweep,k11k5,k7k8]

Run from the root of a checkout (it drives the phases of `chip_smoke.py`
there for its inputs): the tracking path (frame 12's K5 and K6 calls and
local-map window, as chip_smoke's phase 6 replays them; it keeps the
tracked frames' times), the front end's entry pair (K2), the flagship
tracker (its final map's mapping-stage window and its first local-BA
problem) and the e2e stereo lap (its first GBA chunk's problem); it keeps
the tracker's and the 2.5-lap orbit's frame times (asynchronous global BA
beside the tracker). `--parts` picks what to time (default all). Then:

- K10's PnP RANSAC (`pnp.solve_pnp_ransac`) on `chip_smoke.check_full_width`'s
  set (`pnp_full_width`: the flagship's newest keyframe, F 2048, 256 draws
  of 6) and on the loop orbit's frame marked LOST against its first
  relocalization candidate (`pnp_lost_frame`), and K12
  (`initializer.initialize_two_view`) on the mono bootstrap's successful
  attempt (H), on it with every row of the draw degenerate (tied scores)
  and on `plane_scene(False)` (F) (`two_view_inputs`): for each, the whole
  call and each of its launches alone as replayed graphs, each launch that
  takes the match count again with N = 0 (its model solves without the
  per-match work, `NO_MATCHES`), torch.profiler by kernel name, launches a
  call, and hashes of the outputs and of the hypotheses' models (K12's
  models and scores on the bootstrap also to `--out`'s stem + _k12.npz);
  the output hashes at both kernels' edges (`pnp_edge_inputs`,
  `two_view_edge_inputs`);
  ptxas' registers, spill and stack of their kernels; then a rebuild with
  -DKERNEL_STAMPS and each call's `%globaltimer` split (`stamped`) (k10k12);
- K3 (`brief.describe`) on the entry pair's pyramid and keypoints as a
  replayed graph (`chip_smoke.graph_ms`), its launches a call and a hash of
  its patch, angle and descriptor buffers; one Sim3 attempt of
  `loop_closing.compute_sim3` (RANSAC, refinement and their combine;
  `sim3_attempt`) at full width on `sim3_full_width`'s match set and draw
  (`chip_smoke.check_full_width`'s) as a replayed graph, each of its
  launches alone (`recorded_launches`) as a replayed graph, its device time
  by kernel name (torch.profiler), its launches, and hashes of its outputs
  there and on the loop orbit's first closure; the tracker's device time a
  frame with K3's share, and the loop orbit's attempts and closure (k3k10);
- K1 (`pyramid.build_pyramid`) and K4 (`stereo.stereo_match`) on the
  entry pair (1241x376, 8 levels, both images; K4 on the pair's features)
  as CUDA graphs of up to 100 calls replayed between CUDA events
  (`chip_smoke.graph_ms`), each call's launches, a hash of K1's two
  buffers and of K4's five outputs (to compare trees bit for bit), and the
  tracker's device time and launches a frame (torch.profiler over 10
  frames of the schedule after its warm part, as `profile_frame
  --tracker`) with K1's and K4's share (k1k4);
- K6 (`pose_opt.optimize_pose`): frame 12's two calls, and each alone, as
  a CUDA graph of up to 100 calls replayed between CUDA events
  (`chip_smoke.graph_ms`), and the two calls with CUDA events around
  back-to-back eager calls;
- K2 (`fast.detect_pyramid` of the entry pair's pyramid): the whole call
  and each of its two launches on its own (`recorded_launches`), as
  replayed graphs; and over the pyramid's interior pixels the share that
  scores above 0, the share that passes FAST's 4-point test (two of ring
  points 0, 4, 8, 12 beyond +-th) and the share of 32-pixel row segments
  holding a pixel that passes it (k6k2);
- K6 on `chip_smoke.pose_scene` at K = 1, 2048 and 8192 observations, with
  4 rounds of 10 iterations and of none: the cost of an LM iteration
  whatever K (k6sweep);
- K5 (`matcher.match_select`): frame 12's two calls (the motion-model and
  the local-map search) together and each alone as replayed graphs, each
  of their C entries on its own (`recorded_launches`), and K5's launches a
  frame; K11 (`pose_graph.optimize(g, 20, 40)`) with CUDA events around
  back-to-back calls on `ring_graph` at 512, 1024 and 2048 live rows of
  2048 and on the flagship map's essential graph (`flagship_graph`), its
  launches a call, and `optimize_plain` on the 2048-row ring; the tracker's
  device time a frame (torch.profiler over 10 frames of the schedule after
  its warm part, as `profile_frame --tracker`); the loop orbit's and the
  stereo e2e lap's closure times and largest frame (k11k5);
- each of K7's C entry points on its own, on the buffers of one wrapper
  call (`recorded_launches`), as a CUDA graph of up to 100 launches
  replayed between CUDA events (`chip_smoke.graph_ms`),
  with the whole wrapper calls (`local_map_window`; `top_covisible_of` +
  `local_map_mask` + `compact_indices`) and `torch.topk` of the compaction
  key beside them;
- K8 (`ba_dense.optimize`) with CUDA events around back-to-back calls: call
  a of the first local BA and a 2-iteration chunk of the first GBA problem,
  and `build_point_major` of each as a replayed graph.

Prints one JSON object (with the card's `nvidia-smi` name and power limit)
and writes it to `--out`. `recorded_launches` is also how `chip_smoke.py`
times K7 launch by launch, and `ring_graph` / `flagship_graph` are the
graphs it holds K11 to. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from . import kernels
from .frontend import frame as frame_mod
from .frontend import track_ops
from .geometry import se3, sim3
from .loop import loop_closing
from .mapstate import covisibility as covis
from .matching import matcher
from .ops import fast, pyramid
from .optim import ba_dense, pose_graph, pose_opt
from .solvers import initializer, pnp, sim3_solver


def recorded_launches(call, edit: Optional[dict] = None) -> dict:
    """Every kernel launch of one `call()` (through `kernels.launch`), each
    as a closure that repeats that launch alone: {entry name: closure}. The
    tensors whose pointers the call passed stay referenced by the closures,
    so a repeat reads and writes the buffers of the recorded call. With
    `edit` ({entry: (argument position, value)}) only the launches of those
    entries, each with that argument replaced."""
    launch, ptr = kernels.launch, kernels.ptr
    rec, keep = [], []

    def record(counter, fn, *args):
        rec.append((counter, fn, args))
        launch(counter, fn, *args)

    def hold(t):
        keep.append(t)
        return ptr(t)

    kernels.launch, kernels.ptr = record, hold
    try:
        call()
    finally:
        kernels.launch, kernels.ptr = launch, ptr
    out = {}
    for counter, fn, args in rec:
        if edit is not None:
            if fn not in edit:
                continue
            args = list(args)
            args[edit[fn][0]] = edit[fn][1]
            args = tuple(args)
        name = fn if fn not in out else f"{fn}_{len(out)}"
        out[name] = lambda counter=counter, fn=fn, args=args, keep=keep: launch(counter, fn, *args)
    return out


def window_args(te, st, img_l, img_r) -> tuple:
    """The arguments of frame `img_l, img_r`'s `local_map_window` call from
    tracking state `st`, as `_track_core` makes them (motion-model matches
    and their pose; the card's kernels)."""
    cam, cfg, _ = te
    m, prev = st.m, st.prev
    cur = frame_mod.build_frame_stereo(img_l, img_r, cam, cfg.orb, device=m.mp.pos.device)
    T_pred = se3.compose(st.velocity, prev.Tcw)
    ff = matcher.match_select(**track_ops.motion_model_query(cam, m, prev, cur, T_pred, cfg))
    match_mp = track_ops.lookup(ff.idx, prev.mp_idx)
    po = pose_opt.optimize_pose(cam, T_pred, *track_ops.pose_inputs(cur, m.mp.pos, match_mp))
    mp0 = torch.where(po.inliers, match_mp, torch.full_like(match_mp, -1))
    return cam, m, mp0, st.local_rows, st.local_ok, st.ref_kf, po.Tcw, cfg


def pose_args(te, st, img_l, img_r) -> tuple:
    """(cam, T_pred, inputs 1, Tcw0, inputs 2): the two `optimize_pose`
    calls of frame `img_l, img_r` from tracking state `st`, as `_track_core`
    makes them (motion-model matches, then the local map's)."""
    cam, m, mp0, rows, ok, ref_kf, Tcw0, cfg = window_args(te, st, img_l, img_r)
    cur = frame_mod.build_frame_stereo(img_l, img_r, cam, cfg.orb, device=m.mp.pos.device)
    T_pred = se3.compose(st.velocity, st.prev.Tcw)
    ff = matcher.match_select(**track_ops.motion_model_query(cam, m, st.prev, cur, T_pred, cfg))
    pin1 = track_ops.pose_inputs(cur, m.mp.pos, track_ops.lookup(ff.idx, st.prev.mp_idx))
    win = track_ops.local_map_window(cam, m, mp0, rows, ok, ref_kf, Tcw0, cfg)
    has = mp0 >= 0
    pr = matcher.match_select(**track_ops.local_map_query(m, cur, win, has, cfg))
    merged = torch.where(has, mp0, track_ops.lookup(pr.idx, win.rows))
    return cam, T_pred, pin1, Tcw0, track_ops.pose_inputs(cur, m.mp.pos, merged)


def ring_graph(N: int = 2048, covis_k: int = 8, n_loop_slots: int = 32, radius: float = 50.0,
               seed: int = 13, device="cuda", live: int | None = None,
               hub: bool = False) -> pose_graph.PoseGraph:
    """A populated essential graph in `build_essential_graph`'s layout
    (E = N + N covis_k + n_loop_slots): `live` keyframes (all N by default)
    on a ring of radius x live / N metres (0.15 m apart at 2048 and 50 m),
    the spanning chain (parent i - 1, row 0 without one), each row's
    covisibility edges to rows i + 2 .. i + covis_k + 1 (those past the last
    live row unweighted), and two loop edges closing the ring in the first
    two of the loop slots, or with `hub` every loop slot holding an edge of
    row live // 2 to rows spread over the ring. Measurements are the true
    relative poses with 2 cm / 0.01 rad of noise, the vertices the true
    poses with 5 cm / 0.02 rad of drift; row 0 is fixed (the gauge), and so
    are the rows past `live` (the identity, as a map's unused rows)."""
    L = N if live is None else live
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(N) / L
    xi = np.zeros((N, 7), np.float32)
    r = radius * L / N
    xi[:L, 0], xi[:L, 2], xi[:L, 4] = r * np.cos(th[:L]), r * np.sin(th[:L]), th[:L]
    gt = sim3.exp(torch.from_numpy(xi))
    rows = np.arange(N)
    sp_i, sp_j = np.maximum(rows - 1, 0), rows
    cv_j = rows[:, None] + 2 + np.arange(covis_k)[None, :]
    cv_ok = cv_j < L
    lp_i, lp_j = np.zeros(n_loop_slots, np.int64), np.zeros(n_loop_slots, np.int64)
    lp_ok = np.arange(n_loop_slots) < 2
    if hub:
        h = L // 2
        lp_i[:] = h
        lp_j[:] = (h + 2 + np.arange(n_loop_slots) * max(1, (L - 3) // n_loop_slots)) % L
        lp_ok[:] = True
    else:
        lp_i[:2], lp_j[:2] = (L - 1, L - 2), (0, 1)
    e_i = np.concatenate([sp_i, np.repeat(rows, covis_k), lp_i])
    e_j = np.concatenate([sp_j, np.where(cv_ok, cv_j, 0).reshape(-1), lp_j])
    e_ok = np.concatenate([(rows > 0) & (rows < L), cv_ok.reshape(-1), lp_ok])
    E = e_i.shape[0]
    sd = np.array([0.02, 0.02, 0.02, 0.01, 0.01, 0.01, 0.0], np.float32)
    noise = torch.from_numpy((rng.normal(size=(E, 7)) * sd).astype(np.float32))
    drift = torch.from_numpy((rng.normal(size=(N, 7)) * 2.5 * sd).astype(np.float32))
    drift[L:] = 0.0
    take = lambda S, idx: tuple(x[torch.from_numpy(idx)] for x in S)  # noqa: E731
    mR, mt, msc = sim3.compose(sim3.exp(noise),
                               sim3.compose(take(gt, e_j), sim3.inverse(take(gt, e_i))))
    R, t, sc = sim3.compose(sim3.exp(drift), gt)
    dev = torch.device(device)
    i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    return pose_graph.PoseGraph(
        R.contiguous().to(dev), t.contiguous().to(dev), sc.contiguous().to(dev),
        torch.from_numpy((rows == 0) | (rows >= L)).to(dev), i32(e_i), i32(e_j),
        mR.contiguous().to(dev), mt.contiguous().to(dev), msc.contiguous().to(dev),
        torch.from_numpy(e_ok).to(dev), torch.ones(E, device=dev))


class _StereoSide:
    """Features of one side of a stereo edge case, added one at a time."""

    def __init__(self):
        self.rows = []

    def add(self, x, y, octave, desc, patch, valid=True) -> int:
        self.rows.append((np.float32(x), np.float32(y), octave, desc, patch, valid))
        return len(self.rows) - 1

    def arrays(self) -> dict:
        x, y, o, d, p, v = zip(*self.rows)
        return dict(xy=np.stack([np.asarray(x, np.float32), np.asarray(y, np.float32)], -1),
                    octave=np.asarray(o, np.int32), valid=np.asarray(v, bool),
                    desc=np.stack(d).astype(np.uint8), patch=np.stack(p).astype(np.float32))


def stereo_edge_cases(n_levels: int = 8, scale_factor: float = 1.2, seed: int = 5) -> dict:
    """Stereo inputs at the edges of K4's row buckets and mask: {name:
    (left, right, scales)}, each side a dict of numpy arrays (xy [n, 2] f32,
    octave i32, valid bool, desc [n, 32] u8, patch [n, 32, 32] f32), scales
    [L] f32 as the front end's (scale_factor ** l). In each case a feature
    the mask must drop has a better descriptor than the one it must keep.
    Every case but "m1" carries invalid padded rows at (0, 0) on both sides.

    - row_tol: right features at exactly |dy| = 2 scale[o_r] (kept) and at
      the next float beyond (dropped), at octaves 0, 2 and 7 near the top
      of the image (the bucket range wraps below row 0) and at octave 0 mid
      image, above and below;
    - disparity: disparity exactly -1 and 192 (kept), one float beyond each
      (dropped);
    - octave: |o_l - o_r| 1 (kept) and 2 (dropped) at octaves 0 and 7;
    - ties: equal distances in different rows, the lower index on the row
      below (a scan in row order meets the higher index first);
    - no_candidate: valid left features with no right feature on their
      rows (index 0, distance 512, not ok);
    - one_row: every valid right feature on one row;
    - padded: left features at and near (0, 0) beside the padded rows;
    - m1: a single right feature."""
    rng = np.random.default_rng(seed)
    scales = np.asarray([scale_factor ** l for l in range(n_levels)], np.float32)
    up = lambda v: np.nextafter(np.float32(v), np.float32(np.inf))  # noqa: E731
    down = lambda v: np.nextafter(np.float32(v), np.float32(-np.inf))  # noqa: E731

    def desc():
        return rng.integers(0, 256, 32, dtype=np.uint8)

    def flip(d, n_bits):
        out = np.unpackbits(d.copy())
        out[rng.choice(256, n_bits, replace=False)] ^= 1
        return np.packbits(out)

    def patch():
        return rng.uniform(0, 255, (32, 32)).astype(np.float32)

    def twin(p):
        return p + rng.normal(0, 2.0, p.shape).astype(np.float32)

    def pad(side, n):
        for _ in range(n):
            side.add(0.0, 0.0, 0, np.zeros(32, np.uint8), np.zeros((32, 32), np.float32), False)

    def pair(L, R, x, y, o, kept, dropped, n_bits=6):
        """A left feature, a kept right candidate (distance n_bits) at
        `kept` = (x, y, octave) and a dropped one (distance 0) at `dropped`."""
        d, p = desc(), patch()
        L.add(x, y, o, d, p)
        R.add(*kept, flip(d, n_bits), twin(p))
        if dropped is not None:
            R.add(*dropped, d, twin(p))

    cases = {}
    L, R = _StereoSide(), _StereoSide()
    pad(L, 2)
    pad(R, 3)
    for o, y in ((0, 8.0), (2, 8.0), (7, 8.0), (0, 200.0)):
        tol = np.float32(2.0) * scales[o]
        yr = np.float32(np.float64(y) + np.float64(tol))
        assert np.abs(np.float32(y) - yr) == tol and np.abs(np.float32(y) - up(yr)) > tol
        pair(L, R, 400.0 + 37 * o, y, o, (390.0 + 37 * o, yr, o), (391.0 + 37 * o, up(yr), o))
    pair(L, R, 700.0, 200.0, 0, (690.0, 198.0, 0), (691.0, down(198.0), 0))
    cases["row_tol"] = (L.arrays(), R.arrays(), scales)

    L, R = _StereoSide(), _StereoSide()
    pad(L, 1)
    pad(R, 2)
    pair(L, R, 300.0, 120.0, 1, (301.0, 120.0, 1), (up(301.0), 120.0, 1))
    pair(L, R, 500.0, 140.0, 1, (308.0, 140.0, 1), (down(308.0), 140.0, 1))
    pair(L, R, 600.0, 160.0, 3, (580.0, 160.5, 3), (601.5, 160.0, 3))
    cases["disparity"] = (L.arrays(), R.arrays(), scales)

    L, R = _StereoSide(), _StereoSide()
    pad(L, 1)
    pad(R, 1)
    pair(L, R, 200.0, 50.0, 0, (190.0, 50.0, 1), (191.0, 50.0, 2))
    pair(L, R, 400.0, 250.0, 7, (390.0, 250.0, 6), (391.0, 250.0, 5))
    pair(L, R, 600.0, 300.0, 7, (590.0, 300.0, 7), None)
    cases["octave"] = (L.arrays(), R.arrays(), scales)

    L, R = _StereoSide(), _StereoSide()
    pad(R, 2)
    d, p = desc(), patch()
    L.add(500.0, 100.0, 1, d, p)
    tie = flip(d, 9)
    R.add(492.0, 101.5, 1, tie, twin(p))  # lower index, the row below
    for k in range(5):
        R.add(300.0 + k, 60.0 + 20 * k, 0, desc(), patch())
    R.add(493.0, 98.5, 1, tie.copy(), twin(p))  # higher index, the row above
    pad(L, 2)
    cases["ties"] = (L.arrays(), R.arrays(), scales)

    L, R = _StereoSide(), _StereoSide()
    pad(L, 1)
    pad(R, 2)
    for k in range(6):
        R.add(200.0 + 50 * k, 300.0, k % 3, desc(), patch())
    for k in range(4):
        L.add(220.0 + 60 * k, 40.0 + 30 * k, k % 3, desc(), patch())
    cases["no_candidate"] = (L.arrays(), R.arrays(), scales)

    L, R = _StereoSide(), _StereoSide()
    pad(L, 2)
    pad(R, 2)
    for k in range(40):
        d, p = desc(), patch()
        x = 100.0 + 25 * k
        R.add(x - 4.0 - (k % 9), 210.0, k % 3, flip(d, k % 7), twin(p))
        if k % 2 == 0:
            L.add(x, 210.0 + (k % 5) * 0.75, k % 3, d, p)
    cases["one_row"] = (L.arrays(), R.arrays(), scales)

    L, R = _StereoSide(), _StereoSide()
    pad(R, 2)
    d, p = desc(), patch()
    L.add(0.0, 0.0, 0, d, p)
    L.add(0.5, 0.5, 0, desc(), patch())
    pad(L, 2)
    R.add(0.0, 0.5, 0, flip(d, 3), twin(p))
    pad(R, 2)
    pair(L, R, 900.0, 350.0, 4, (880.0, 351.0, 4), None)
    cases["padded"] = (L.arrays(), R.arrays(), scales)

    L, R = _StereoSide(), _StereoSide()
    d, p = desc(), patch()
    L.add(640.0, 180.0, 2, d, p)
    L.add(100.0, 20.0, 2, desc(), patch())
    R.add(628.0, 180.5, 2, flip(d, 4), twin(p))
    cases["m1"] = (L.arrays(), R.arrays(), scales)
    return cases


def flagship_graph(m) -> pose_graph.PoseGraph:
    """The essential graph of map `m` (`build_essential_graph`, N = its
    keyframe capacity) with one synthetic loop edge between its first and
    last live keyframes, their relative pose moved 5 cm; the first is the
    fixed row."""
    live = torch.nonzero(m.kf.valid)[:, 0].tolist()
    a0, a1 = live[0], live[-1]
    dev = m.kf.Tcw.device
    T_rel = m.kf.Tcw[a1] @ se3.inverse(m.kf.Tcw[a0])
    loops = loop_closing.LoopEdges.empty(device=dev).add(
        0, a0, a1, T_rel[:3, :3], T_rel[:3, 3] + torch.tensor([0.05, 0.0, 0.0], device=dev),
        torch.ones((), device=dev))
    return loop_closing.build_essential_graph(m, loops, a0, m.kf.Tcw.clone())


def match_queries(te, st, img_l, img_r) -> tuple:
    """The two `match_select` queries of frame `img_l, img_r` from tracking
    state `st`, as `_track_core` makes them: the motion-model match, then
    the local map's projection search."""
    cam, m, mp0, rows, ok, ref_kf, Tcw0, cfg = window_args(te, st, img_l, img_r)
    cur = frame_mod.build_frame_stereo(img_l, img_r, cam, cfg.orb, device=m.mp.pos.device)
    T_pred = se3.compose(st.velocity, st.prev.Tcw)
    q_ff = track_ops.motion_model_query(cam, m, st.prev, cur, T_pred, cfg)
    win = track_ops.local_map_window(cam, m, mp0, rows, ok, ref_kf, Tcw0, cfg)
    q_pr = track_ops.local_map_query(m, cur, win, mp0 >= 0, cfg)
    return q_ff, q_pr


def time_k5(cs, te, tp) -> dict:
    """K5 on frame CHECK_FRAME's two calls: together, each alone and each C
    entry alone, as replayed graphs; the launches a frame."""
    q_ff, q_pr = match_queries(te, tp["check_state"], *tp["imgs"][cs.CHECK_FRAME])
    ff = lambda: matcher.match_select(**q_ff)  # noqa: E731
    pr = lambda: matcher.match_select(**q_pr)  # noqa: E731
    both = lambda: (ff(), pr())  # noqa: E731
    out = dict(queries=[[int(q["valid_q"].sum()), int(q["valid_t"].sum()),
                         q["desc_q"].shape[0], q["desc_t"].shape[0]] for q in (q_ff, q_pr)],
               frame_graph_ms=cs.graph_ms(both), motion_graph_ms=cs.graph_ms(ff),
               local_map_graph_ms=cs.graph_ms(pr), launches_per_frame=cs.launches_of(
                   both, "match_masked"))
    for name, fn in (("motion", ff), ("local_map", pr)):
        out[f"{name}_launches_graph_ms"] = {k: cs.graph_ms(f)
                                           for k, f in recorded_launches(fn).items()}
    return out


def time_k11(cs, graphs: dict, reps: int = 3) -> dict:
    """K11's `optimize(g, 20, 40)` on each graph, CUDA events around
    back-to-back calls, and its launches a call."""
    out = {}
    for name, g in graphs.items():
        opt = lambda g=g: pose_graph.optimize(g, 20, 40)  # noqa: E731
        out[name] = dict(free_vertices=int((~g.fixed).sum()),
                         weighted_edges=int(g.e_valid.sum()), edges=g.e_i.shape[0],
                         launches_per_optimize=cs.launches_of(opt, "pose_graph"),
                         optimize_events_ms=events_ms(opt, reps))
    return out


def device_per_frame(step, n: int, watch=(), top: Optional[int] = 12) -> dict:
    """torch.profiler over n step() calls: wall and device ms a frame, the
    device's idle share, launches a frame (as `profile_frame` reports), the
    `top` kernels by device ms a frame (all of them when None), and the
    device ms and launches a frame of the kernels whose names hold one of
    `watch`."""
    from time import perf_counter

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    per = defaultdict(float)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (perf_counter() - t0) * 1e3 / n
    count = 0
    watched = {w: [0.0, 0] for w in watch}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per[ev.name] += ev.device_time_total / 1e3 / n
            count += 1
            for w in watch:
                if w in ev.name:
                    watched[w][0] += ev.device_time_total / 1e3 / n
                    watched[w][1] += 1
    dev_ms = sum(per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    return dict(wall_ms_per_frame=wall, device_ms_per_frame=dev_ms,
                device_idle_share=max(0.0, 1.0 - dev_ms / wall), launches_per_frame=count / n,
                top_kernels_ms=[[k[:80], v] for k, v in ranked],
                watched={w: dict(ms_per_frame=v[0], launches_per_frame=v[1] / n)
                         for w, v in watched.items()})


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes, in order (16 hex digits)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_k1_k4(cs) -> dict:
    """K1 and K4 on the entry pair (replayed graphs, launches a call, output
    hashes) and the tracker's device time a frame with K1's and K4's share."""
    from . import profile_frame
    from .ops import orb, stereo

    _, entry_imgs = cs.entry("cuda")
    imgs = orb.as_images(list(entry_imgs), torch.device("cuda"))
    prm = orb.params(cs.CFG, imgs.shape[1], imgs.shape[2], "cuda")
    pyr = pyramid.build_pyramid(imgs, prm)
    f = orb.extract_batch(imgs, prm)
    fl, fr = f.select(0), f.select(1)
    bf = float(cs.CAM.bf)
    build = lambda: pyramid.build_pyramid(imgs, prm)  # noqa: E731
    match = lambda: stereo.stereo_match(fl, fr, prm.scales, bf)  # noqa: E731
    m = match()
    torch.cuda.synchronize()
    out = dict(
        k1=dict(graph_ms=cs.graph_ms(build), launches_per_call=cs.launches_of(build, "pyramid"),
                levels_hash=digest(pyr.levels), blurred_hash=digest(pyr.blurred),
                pixels=prm.total, images=imgs.shape[0]),
        k4=dict(graph_ms=cs.graph_ms(match),
                launches_per_call=cs.launches_of(match, "stereo_match"),
                outputs_hash=digest(m.idx, m.dist, m.u_right, m.depth, m.ok),
                left=int(fl.valid.sum()), right=int(fr.valid.sum()), ok=int(m.ok.sum())))
    out["tracker_device"] = device_per_frame(
        profile_frame.tracker_frames(10), 10,
        watch=("pyramid", "resize_level", "blur_levels", "stereo"))
    return out


def sim3_full_width(m, gen: torch.Generator) -> tuple:
    """`chip_smoke.check_full_width`'s Sim3 match set and draw on map m: the
    second-newest live keyframe's points in its camera and under a known
    Sim3 (1 cm noise from `gen`, a quarter of the rows shuffled as
    outliers), and 256 draws of 3 from its bound rows: (Sim3Matches, idx)."""
    dev = m.kf.Tcw.device
    F = m.kf.n_features
    b = torch.nonzero(m.kf.valid)[:, 0].tolist()[-2]
    idx_b = m.kf.mp_idx[b]
    bound_b = (idx_b >= 0) & m.kf.fvalid[b]
    p2 = se3.transform(m.kf.Tcw[b], m.mp.pos[idx_b.clamp_min(0).long()]).contiguous()
    S = sim3.exp(torch.tensor([0.3, -0.1, 0.5, 0.02, -0.05, 0.03, 0.0], device=dev))
    noise = torch.randn(p2.shape, generator=gen, device=dev) * 0.01
    p1 = sim3.transform(S, p2) + noise
    out_rows = torch.arange(F // 4, device=dev)
    p1[out_rows] = p1[out_rows.flip(0)]
    s2 = (1.44 ** m.kf.octave[b].to(torch.float32)).contiguous()
    mt = loop_closing.Sim3Matches(p1.contiguous(), p2, bound_b, s2, s2)
    return mt, sim3_solver.sample_indices(bound_b, 256, 3, gen)


def sim3_attempt(cam, mt, idx, fix_scale: bool = True, min_inliers: int = 20) -> tuple:
    """One Sim3 attempt of `loop_closing.compute_sim3`
    (`sim3_solver.solve_and_refine_sim3` on draw `idx`) as one flat tuple:
    RANSAC R, t, s, inliers, n, ok; refined R, t, s, inliers, n; combined
    R, t, s, n."""
    a = sim3_solver.solve_and_refine_sim3(cam, cam, *mt, idx=idx, min_inliers=min_inliers,
                                          fix_scale=fix_scale)
    return (*a.ransac, *a.refined, a.R, a.t, a.s, a.n_inliers)


def time_sim3(cs, cam, mt, idx) -> dict:
    """One Sim3 attempt (`sim3_attempt`) on (mt, idx): replayed graph,
    host-inclusive CUDA events, each launch alone, torch.profiler by kernel
    name, launches and an output hash."""
    attempt = lambda: sim3_attempt(cam, mt, idx)  # noqa: E731
    out = attempt()
    torch.cuda.synchronize()
    return dict(graph_ms=cs.graph_ms(attempt), host_ms=cs.host_ms(attempt),
                launches_per_attempt=cs.launches_of(attempt, "sim3"),
                launch_graph_ms={k: cs.graph_ms(f) for k, f in recorded_launches(attempt).items()},
                profiler=device_per_frame(attempt, 20, top=None), outputs_hash=digest(*out),
                n_inliers=[int(out[4]), int(out[10]), int(out[14])],
                matches=int(mt.pair_ok.sum()))


def time_k3_k10(cs) -> dict:
    """K3 on the entry pair (replayed graph, launches a call, output hashes),
    one Sim3 attempt at full width and on the loop orbit's first closure,
    the tracker's device time a frame with K3's share, the loop orbit."""
    from . import profile_frame
    from .ops import brief, orb

    _, entry_imgs = cs.entry("cuda")
    imgs = orb.as_images(list(entry_imgs), torch.device("cuda"))
    prm = orb.params(cs.CFG, imgs.shape[1], imgs.shape[2], "cuda")
    pyr = pyramid.build_pyramid(imgs, prm)
    kp = fast.detect_pyramid(pyr, prm)
    describe = lambda: brief.describe(pyr, kp, prm)  # noqa: E731
    patch, angle, desc = describe()
    torch.cuda.synchronize()
    out = dict(k3=dict(graph_ms=cs.graph_ms(describe), host_ms=cs.host_ms(describe),
                       launches_per_call=cs.launches_of(describe, "orb_describe"),
                       patch_hash=digest(patch), angle_hash=digest(angle),
                       desc_hash=digest(desc), slots=int(kp.cell_id.numel()),
                       valid=int(kp.valid.sum())))
    tp = cs.run_tracker_phase()
    fl = cs.run_flagship_with_loop_closer(tp)
    del tp
    tracker = fl["tracker"]
    mt, idx = sim3_full_width(tracker.map, torch.Generator(device="cuda").manual_seed(11))
    out["sim3_full_width"] = time_sim3(cs, tracker.cam, mt, idx)
    del fl, tracker
    lp = cs.run_loop_phase()
    kept, ltr = lp["kept"], lp["tracker"]
    mt = loop_closing.sim3_matches(kept["m"], kept["kf_q"], kept["kf_c"], ltr.cfg)
    idx = sim3_solver.sample_indices(mt.pair_ok, 256, 3,
                                     torch.Generator(device="cuda").manual_seed(7))
    out["sim3_loop_map"] = time_sim3(cs, ltr.cam, mt, idx)
    out["loop_orbit"] = dict(attempts=lp["attempts"], sim3_launches=lp["launches"]["sim3"],
                             first_loop=lp["first_loop"], loops=lp["loops"], ate_m=lp["ate_m"],
                             close_ms=lp["close_ms"], frame_ms_p50=lp["frame_ms_p50"],
                             frame_ms_p90=lp["frame_ms_p90"],
                             loop_stage_ms_p50=float(np.percentile(lp["loop_stage_ms"], 50)),
                             sim3_log=lp["sim3_log"])
    del lp, kept, ltr
    out["tracker_device"] = device_per_frame(profile_frame.tracker_frames(10), 10,
                                             watch=("orb_describe",))
    return out


def pnp_full_width(m, gen: torch.Generator) -> tuple:
    """`chip_smoke.check_full_width`'s PnP set on map m: the newest live
    keyframe's observations of its bound points and a 256-row draw of 6 from
    `gen` (which has made `sim3_full_width`'s draw before it): (X, uv,
    valid, sigma2, idx)."""
    q = torch.nonzero(m.kf.valid)[:, 0].tolist()[-1]
    idx_q = m.kf.mp_idx[q]
    hit = (idx_q >= 0) & m.kf.fvalid[q]
    X = m.mp.pos[idx_q.clamp_min(0).long()].contiguous()
    sg2 = (1.44 ** m.kf.octave[q].to(torch.float32)).contiguous()
    return X, m.kf.xy[q].contiguous(), hit, sg2, sim3_solver.sample_indices(hit, 256, 6, gen)


def pnp_lost_frame(lp: dict, gen: torch.Generator) -> tuple:
    """`chip_smoke.check_loop_kernels`' PnP set: the loop orbit's frame
    marked LOST against its first relocalization candidate (K5's matches to
    the candidate's bound points) and a 256-row draw of 6 from `gen` (after
    the first closure's Sim3 draw of 3): (X, uv, valid, sigma2, idx)."""
    from .frontend import reloc
    from .place import database, vocab

    tracker, kept = lp["tracker"], lp["kept"]
    cam, cfg, lc_ = tracker.cam, tracker.cfg, tracker.loop_closer
    mt = loop_closing.sim3_matches(kept["m"], kept["kf_q"], kept["kf_c"], cfg)
    sim3_solver.sample_indices(mt.pair_ok, 256, 3, gen)
    fr = frame_mod.build_frame_stereo(*lp["imgs"][lp["frames"]], cam, cfg.orb, device="cuda")
    bow = vocab.transform(lc_.voc, fr.desc, fr.fvalid)
    rows, _ = database.detect_relocalization_candidates(lc_.db, tracker.map, bow, k=5)
    _, hit, X, sigma2 = reloc.reloc_matches(tracker.map, int(rows[0]), fr, cfg)
    return X, fr.xy.contiguous(), hit, sigma2, sim3_solver.sample_indices(hit, 256, 6, gen)


def degenerate_rows(idx: torch.Tensor, valid: torch.Tensor, rows=None) -> torch.Tensor:
    """`idx` with each of `rows` (every row when None) holding one valid
    match in all its slots: the r-th valid match in row r, cyclically (any
    match when none is valid)."""
    idx = idx.clone()
    pool = torch.nonzero(valid)[:, 0]
    if pool.numel() == 0:
        pool = torch.arange(valid.shape[0], device=valid.device)
    r = (torch.arange(idx.shape[0], device=idx.device) if rows is None
         else torch.tensor(rows, device=idx.device))
    idx[r] = pool[r % pool.numel()].to(idx.dtype)[:, None].expand(-1, idx.shape[1])
    return idx


def pnp_scene(cam, n: int, seed: int = 5, dev="cuda") -> tuple:
    """A seeded PnP match set of n points at `cam`: X 4-40 m in front of
    the camera, their projections under a known pose with 0.5 px noise, the
    first quarter's pixels reversed (outliers), 95 % valid, octave sigma^2:
    (X, uv, valid, sigma2)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n), rng.uniform(4, 40, n)],
                 -1).astype(np.float32)
    T = se3.exp(torch.tensor([0.1, -0.05, 0.3, 0.02, 0.05, -0.01])).numpy()
    p = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx, cam.fy * p[:, 1] / p[:, 2] + cam.cy], -1)
    uv = (uv + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    uv[: n // 4] = uv[: n // 4][::-1]
    valid = rng.random(n) < 0.95
    s2 = (1.44 ** rng.integers(0, 4, n)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (X, uv, valid, s2))


def pnp_edge_inputs(cam, dev="cuda") -> dict:
    """K10 PnP's edge cases, {name: (X, uv, valid, sigma2, idx)}: N = 1,
    N = 8192 (the kernel's capacity), N = 1000 (not a multiple of a CTA's
    width), no valid match, a draw with two degenerate rows (one match in
    all six slots) and an all-degenerate draw (counts tied)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, n in (("N1", 1), ("capacity", 8192), ("N1000", 1000)):
        X, uv, valid, s2 = pnp_scene(cam, n, dev=dev)
        if n == 1:
            valid[:] = True
        out[name] = (X, uv, valid, s2, sim3_solver.sample_indices(valid, 256, 6, gen))
    X, uv, valid, s2 = pnp_scene(cam, 2048, seed=6, dev=dev)
    none = torch.zeros_like(valid)
    out["none_valid"] = (X, uv, none, s2, sim3_solver.sample_indices(none, 256, 6, gen))
    idx = sim3_solver.sample_indices(valid, 256, 6, gen)
    out["degenerate_rows"] = (X, uv, valid, s2, degenerate_rows(idx, valid, (5, 131)))
    out["all_degenerate"] = (X, uv, valid, s2, degenerate_rows(idx, valid))
    return out


def two_view_edge_inputs(cs, dev="cuda") -> dict:
    """K12's edge cases, {name: (xy1, xy2, valid, sample)} from
    `chip_smoke.plane_scene`: N = 1, N = 4096 (the kernel's capacity),
    N = 1000 (not a multiple of a CTA's width), no valid match, a draw with
    two degenerate rows (one match in all eight slots) and an
    all-degenerate draw (scores tied)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for name, n, planar in (("N1", 1, True), ("capacity", 4096, True), ("N1000", 1000, False)):
        xy1, xy2, valid = cs.plane_scene(planar, n=n)
        if n == 1:
            valid[:] = True
        out[name] = (xy1, xy2, valid, sim3_solver.sample_indices(valid, 256, 8, gen))
    xy1, xy2, valid = cs.plane_scene(True)
    none = torch.zeros_like(valid)
    out["none_valid"] = (xy1, xy2, none, sim3_solver.sample_indices(none, 256, 8, gen))
    sample = sim3_solver.sample_indices(valid, 256, 8, gen)
    out["degenerate_rows"] = (xy1, xy2, valid, degenerate_rows(sample, valid, (9, 170)))
    out["all_degenerate"] = (xy1, xy2, valid, degenerate_rows(sample, valid))
    return out


def two_view_inputs(cs, mono: dict, gen: torch.Generator) -> dict:
    """`chip_smoke.check_sensor_kernels`' K12 inputs: the mono bootstrap's
    successful attempt (H) and `plane_scene(False)` (F), each with a
    256-row draw of 8 from `gen`, and the bootstrap's matches with every row
    of its draw degenerate (one match in all eight slots: tied scores):
    {name: (xy1, xy2, valid, sample)}."""
    xy1, xy2, valid = mono["kept"]["two_view"][-1]
    out = dict(bootstrap_H=(xy1, xy2, valid, initializer.sample_indices(valid, 256, 8, gen)))
    fx1, fx2, fvalid = cs.plane_scene(False)
    out["plane_scene_F"] = (fx1, fx2, fvalid, initializer.sample_indices(fvalid, 256, 8, gen))
    out["bootstrap_tie"] = (xy1, xy2, valid, degenerate_rows(out["bootstrap_H"][3], valid))
    return out


def recorded_buffers(call) -> list:
    """The tensors whose pointers one `call()` passed to its kernel
    launches, in the order it passed them (scratch buffers included)."""
    ptr, keep = kernels.ptr, []

    def hold(t):
        keep.append(t)
        return ptr(t)

    kernels.ptr = hold
    try:
        call()
    finally:
        kernels.ptr = ptr
    torch.cuda.synchronize()
    return keep


# K10's PnP C entry with N = 0, for its launch without the per-match work
# (`recorded_launches`' edit). K12's is left out: with N = 0 its
# degenerate systems take other paths.
NO_MATCHES = {"pnp_ransac": (4, 0)}
# The phases that each kernel's `%globaltimer` stamps close (workspace
# words 8.., a build with -DKERNEL_STAMPS), from the first CTA's start.
STAMPS = {"pnp": ("dlt", "staged", "counted", "ticket", "end"),
          "two_view": ("normalized", "hypotheses", "scored", "ticket", "refit_sums",
                       "refit_solved", "rescored", "candidates", "checked", "end")}


def stamped(calls: dict, reps: int = 5) -> dict:
    """Rebuilds the kernels with -DKERNEL_STAMPS and runs each of `calls`
    ({name: (call, workspace name)}) `reps` times: the median microseconds
    from the first CTA's start to each stamp of its kernel; the build
    without stamps is loaded again after."""
    flags = list(kernels.NVCC_FLAGS)
    kernels.NVCC_FLAGS.append("-DKERNEL_STAMPS")
    kernels._lib = None
    out = {}
    try:
        kernels.lib()
        for name, (call, ws) in calls.items():
            dev = torch.device("cuda", torch.cuda.current_device())
            work = kernels.workspace(ws, dev, kernels.stream(), kernels.STAMPED_WORDS)
            rows = []
            for _ in range(reps):
                work[8:].zero_()
                call()
                torch.cuda.synchronize()
                st = work[8:].cpu().tolist()
                rows.append([(v - st[0]) / 1e3 for v in st[1:len(STAMPS[ws]) + 1]])
            out[name] = {k: float(np.median([r[j] for r in rows]))
                         for j, k in enumerate(STAMPS[ws])}
    finally:
        kernels.NVCC_FLAGS[:] = flags
        kernels._lib = None
        kernels.lib()
    return out


def time_k10_call(cs, call, counter: str, outputs, models) -> dict:
    """One K10 PnP or K12 call: replayed graph, host-inclusive CUDA events,
    each launch alone and without its per-match work (`NO_MATCHES`),
    torch.profiler by kernel name, launches and output hashes (`outputs`
    and `models` map a result, and the call's recorded buffers, to tensors)."""
    out = call()
    torch.cuda.synchronize()
    bufs = recorded_buffers(call)
    return dict(graph_ms=cs.graph_ms(call), host_ms=cs.host_ms(call),
                launches_per_call=cs.launches_of(call, counter),
                launch_graph_ms={k: cs.graph_ms(f) for k, f in recorded_launches(call).items()},
                without_matches_graph_ms={k: cs.graph_ms(f) for k, f in
                                          recorded_launches(call, NO_MATCHES).items()},
                profiler=device_per_frame(call, 20, top=None),
                outputs_hash=digest(*outputs(out)), models_hash=[digest(b) for b in models(bufs)])


def time_k10_k12(cs, dump: Optional[str] = None) -> dict:
    """K10's PnP RANSAC on `chip_smoke.check_full_width`'s set and on the
    loop orbit's LOST frame, K12 on the mono bootstrap's successful attempt
    (H) and `plane_scene(False)` (F), each by `time_k10_call`; ptxas of
    their kernels; the mono bootstrap's attempts; their `%globaltimer`
    stamps (`stamped`). `dump` (an .npz
    path) keeps K12's hypothesis models and scores on the bootstrap's
    attempt, to compare trees value by value."""
    out = dict(ptxas={k: v for k, v in cs.ptxas_summary(kernels.BUILD_INFO.get("log", "")).items()
                      if k.startswith(("pnp", "two_view"))})

    calls = {}

    def time_pnp(name, cam, X, uv, valid, sigma2, idx):
        call = lambda: pnp.solve_pnp_ransac(cam, X, uv, valid, sigma2, idx=idx)  # noqa: E731
        # The scratch [H, 12] models (R row-major, t) among the recorded buffers.
        r = time_k10_call(cs, call, "pnp", lambda o: tuple(o),
                          lambda b: [x for x in b if tuple(x.shape) == (idx.shape[0], 12)])
        o = call()
        r.update(n_inliers=int(o.n_inliers), ok=bool(o.ok), matches=int(valid.sum()),
                 N=int(X.shape[0]))
        calls[name] = (call, "pnp")
        out[name] = r

    tp = cs.run_tracker_phase()
    fl = cs.run_flagship_with_loop_closer(tp)
    del tp
    tracker = fl["tracker"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    sim3_full_width(tracker.map, gen)
    time_pnp("pnp_full_width", tracker.cam, *pnp_full_width(tracker.map, gen))
    del fl, tracker
    lp = cs.run_loop_phase()
    gen = torch.Generator(device="cuda").manual_seed(7)
    time_pnp("pnp_lost_frame", lp["tracker"].cam, *pnp_lost_frame(lp, gen))
    out["loop_orbit"] = dict(pnp_launches=lp["launches"]["pnp"],
                             relocalizations=lp["relocalizations"], first_loop=lp["first_loop"])
    del lp
    mono = cs.run_sensor_phase("mono")
    out["mono"] = dict(init_frame=mono["init_frame"], attempts=mono["attempts"],
                       two_view_launches=mono["launches"]["two_view"], init_ms=mono["init_ms"],
                       keyframes=mono["keyframes"])
    gen = torch.Generator(device="cuda").manual_seed(3)
    for name, (xy1, xy2, valid, sample) in two_view_inputs(cs, mono, gen).items():
        call = lambda xy1=xy1, xy2=xy2, valid=valid, sample=sample: (  # noqa: E731
            initializer.initialize_two_view(cs.CAM, xy1, xy2, valid, sample=sample))
        out[f"two_view_{name}"] = time_k10_call(
            cs, call, "two_view", lambda o: tuple(o),
            lambda b: [x for x in b if tuple(x.shape) in ((2, 256, 18), (2, 256))])
        o = call()
        out[f"two_view_{name}"].update(ok=bool(o.ok), used_H=bool(o.used_H),
                                       n_good=int(o.n_good), matches=int(valid.sum()),
                                       N=int(xy1.shape[0]))
        calls[f"two_view_{name}"] = (call, "two_view")
        if dump and name == "bootstrap_H":
            b = recorded_buffers(call)
            np.savez(dump, **{f"b{i}": x.cpu().numpy() for i, x in enumerate(b)
                              if tuple(x.shape) in ((2, 256, 18), (2, 256))})
    # The edge cases, kernel alone: output hashes (to compare trees).
    edges = pnp_edge_inputs(cs.CAM)
    out["pnp_edges"] = {k: digest(*pnp.solve_pnp_ransac(cs.CAM, X, uv, v, s2, idx=idx))
                        for k, (X, uv, v, s2, idx) in edges.items()}
    out["two_view_edges"] = {k: digest(*initializer.initialize_two_view(cs.CAM, a, b, v, sample=s))
                             for k, (a, b, v, s) in two_view_edge_inputs(cs).items()}
    out["stamps_us"] = stamped(calls)
    return out


def time_k11_k5(cs, te, tp) -> dict:
    """K5 on frame 12, K11 on the ring graphs and the flagship map's graph,
    the tracker's device time a frame, the loop orbit's and the stereo e2e
    lap's closures and largest frame."""
    from . import profile_frame

    out = dict(k5=time_k5(cs, te, tp))
    graphs = {f"ring_live{L}": ring_graph(2048, live=L) for L in (512, 1024, 2048)}
    kp = cs.run_tracker_phase()
    out["tracker_schedule"] = {k: kp[k] for k in ("frame_ms_p50", "frame_ms_p90",
                                                  "frame_ms_max", "keyframes", "valid_points",
                                                  "ate_m")}
    graphs["flagship_map"] = flagship_graph(kp["tracker"].map)
    del kp
    out["k11"] = time_k11(cs, graphs)
    ring = graphs["ring_live2048"]
    out["k11"]["ring_live2048"]["plain_events_ms"] = events_ms(
        lambda: pose_graph.optimize_plain(ring, 20, 40), 2)
    out["tracker_device"] = device_per_frame(profile_frame.tracker_frames(10), 10)
    lp = cs.run_loop_phase()
    out["loop_orbit"] = dict(close_ms=lp["close_ms"], frame_ms_max=max(lp["frame_ms"]),
                             frame_ms_p50=lp["frame_ms_p50"], frame_ms_p90=lp["frame_ms_p90"],
                             loops=lp["loops"], pose_graph_launches=lp["launches"]["pose_graph"])
    del lp
    ep = cs.run_e2e_phase("stereo")
    out["e2e_stereo"] = dict(close_ms=ep["close_ms"], frame_ms_max=ep["frame_ms_max"],
                             frame_ms_p50=ep["frame_ms_p50"], frame_ms_p90=ep["frame_ms_p90"],
                             loops=ep["n_loops"], pose_graph_launches=ep["launches"]["pose_graph"])
    return out


def time_k6_k2(cs, te, tp) -> dict:
    """K6 on frame CHECK_FRAME's two calls and K2 on the entry pair."""
    cam, T_pred, pin1, Tcw0, pin2 = pose_args(te, tp["check_state"],
                                              *tp["imgs"][cs.CHECK_FRAME])
    first = lambda: pose_opt.optimize_pose(cam, T_pred, *pin1)  # noqa: E731
    second = lambda: pose_opt.optimize_pose(cam, Tcw0, *pin2)  # noqa: E731
    both = lambda: (first(), second())  # noqa: E731
    out = dict(k6=dict(observations=[int(pin1[0].shape[0]), int(pin2[0].shape[0])],
                       valid=[int(pin1[4].sum()), int(pin2[4].sum())],
                       frame_graph_ms=cs.graph_ms(both), first_graph_ms=cs.graph_ms(first),
                       second_graph_ms=cs.graph_ms(second), frame_events_ms=events_ms(both, 20)))
    dev = pin1[0].device
    _, entry_imgs = cs.entry("cuda")
    imgs = cs.orb.as_images(list(entry_imgs), dev)
    prm = cs.orb.params(cs.CFG, imgs.shape[1], imgs.shape[2], str(dev))
    pyr = pyramid.build_pyramid(imgs, prm)
    detect = lambda: fast.detect_pyramid(pyr, prm)  # noqa: E731
    k2 = {name: cs.graph_ms(fn) for name, fn in recorded_launches(detect).items()}
    k2.update(call_graph_ms=cs.graph_ms(detect), call_events_ms=events_ms(detect, 50),
              cells=[gy * gx for gy, gx in prm.grids])
    out["k2"] = k2
    k2.update(fast_pass_rates(pyr, prm, cs.CFG.min_th_fast))
    out["tracked_frame"] = {k: tp[k] for k in ("frame_ms_p50", "frame_ms_p90",
                                               "track_only_ms_p50", "track_only_ms_p90")}
    return out


def fast_pass_rates(pyr, prm, th: float) -> dict:
    """Over the interior pixels of every level of every image: the share
    whose FAST score is above 0, the share passing the 4-point test, and
    the share of 32-pixel row segments holding a pixel that passes it."""
    n = n_corner = n_pass = n_seg = n_seg_pass = 0
    b = fast.BORDER
    for lvl in range(prm.n_levels):
        for i in range(pyr.levels.shape[0]):
            img = pyr.level(lvl, i)
            h, w = img.shape
            inner = img[b:h - b, b:w - b]
            d = torch.stack([img[b + dy:h - b + dy, b + dx:w - b + dx] - inner
                             for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))])
            ok = ((d > th).sum(0) >= 2) | ((d < -th).sum(0) >= 2)
            n += ok.numel()
            n_pass += int(ok.sum())
            n_corner += int((fast.fast_score_map(img, th)[b:h - b, b:w - b] > 0).sum())
            seg = ok[:, :ok.shape[1] // 32 * 32].reshape(ok.shape[0], -1, 32).any(-1)
            n_seg += seg.numel()
            n_seg_pass += int(seg.sum())
    return dict(corner_share=n_corner / n, four_point_pass_share=n_pass / n,
                segments_with_a_pass_share=n_seg_pass / n_seg)


def time_k6_sweep(cs) -> dict:
    """K6 (`optimize_pose`, replayed graphs) on `chip_smoke.pose_scene` at
    1, 2048 and 8192 observations, 4 rounds of 10 and of 0 iterations."""
    out = {}
    for K in (1, 2048, 8192):
        T0, inputs = cs.pose_scene(3, K, 0.3, 0.1 if K > 1 else 0.0, 0.6,
                                   [0.2, -0.1, 0.15, 0.02, -0.01, 0.02], None,
                                   torch.device("cuda"))
        for it in (10, 0):
            out[f"K{K}_iters{it}_graph_ms"] = cs.graph_ms(
                lambda: pose_opt.optimize_pose(cs.CAM, T0, *inputs, n_rounds=4, n_iters=it))
    return out


def events_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean time of one fn() call, CUDA events around `reps` back-to-back
    calls after `warmup` (calls of milliseconds: launch gaps negligible)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def time_k7(launches: dict, whole, library, graph_ms) -> dict:
    out = {name: graph_ms(fn) for name, fn in launches.items()}
    out["sum_of_launches"] = sum(out.values())
    out["wrapper_call"] = graph_ms(whole)
    out["torch_topk"] = graph_ms(library)
    return out


def time_k8(cam, pb, n_iters: int, cg: int, huber: int, graph_ms, counter="ba_dense",
            reps: int = 5) -> dict:
    C, Fb = pb.obs_mp.shape
    P, K = pb.pm_src.shape
    res = ba_dense.optimize(cam, pb, n_iters, cg, huber, counter=counter)
    return dict(C=C, Fb=Fb, P=P, K=K, n_iters=n_iters, cg_iters=cg, huber_iters=huber,
                active=int(pb.obs_active.sum()), trace=res.trace.tolist(),
                optimize_events_ms=events_ms(
                    lambda: ba_dense.optimize(cam, pb, n_iters, cg, huber, counter=counter), reps),
                point_major_graph_ms=graph_ms(
                    lambda: ba_dense.build_point_major(pb.obs_mp, pb.obs_active, P, K, counter)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("chiprun_out", "kernel_times.json"))
    ap.add_argument("--parts", default="k10k12,k3k10,k1k4,k6k2,k6sweep,k11k5,k7k8",
                    help="k10k12: K10's PnP RANSAC at full width and on the loop orbit's "
                         "LOST frame, K12 on the mono bootstrap's attempt and a non-planar "
                         "scene; "
                         "k3k10: K3 on the entry pair, a Sim3 attempt at full width and on "
                         "the loop map, the tracker's device time and the loop orbit; "
                         "k1k4: K1 and K4 on the entry pair and the tracker's device time; "
                         "k6k2: K6 and K2 on the tracking path; k6sweep: K6 by observations "
                         "and iterations; k11k5: K5 on the tracking path, K11, the tracker's "
                         "device time and the loop closures; k7k8: K7, K8 and the tracker")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs  # the phases of the checkout's chip_smoke.py

    out = dict(nvidia_smi=cs.nvidia_smi_line(), device=torch.cuda.get_device_name(0))
    kernels.lib()
    dev = torch.device("cuda")
    if "k10k12" in parts:
        out.update(time_k10_k12(cs, os.path.splitext(args.out)[0] + "_k12.npz"))
    if "k3k10" in parts:
        out.update(time_k3_k10(cs))
    if "k1k4" in parts:
        out.update(time_k1_k4(cs))
    if not parts & {"k6k2", "k6sweep", "k11k5", "k7k8"}:
        return finish(out, args.out)
    te = cs.track_entry("cuda")
    tp = cs.run_tracking_path(te, dev)
    if "k6k2" in parts:
        out.update(time_k6_k2(cs, te, tp))
    if "k6sweep" in parts:
        out["k6_sweep"] = time_k6_sweep(cs)
    if "k11k5" in parts:
        out.update(time_k11_k5(cs, te, tp))
    if "k7k8" not in parts:
        return finish(out, args.out)
    wargs = window_args(te, tp["check_state"], *tp["imgs"][cs.CHECK_FRAME])
    m, L = wargs[1], wargs[-1].capacity.local_window_mps
    M = m.mp.capacity
    win = track_ops.local_map_window(*wargs)
    key = win.pmask.to(torch.int64) * (M + 1) + torch.arange(M, device=dev)
    window = lambda: track_ops.local_map_window(*wargs)  # noqa: E731
    out["k7_window"] = time_k7(recorded_launches(window), window, lambda: torch.topk(key, L),
                               cs.graph_ms)
    out["k7_window"]["n_pmask"] = int(win.pmask.sum())

    kp = cs.run_tracker_phase()
    out["tracker"] = {k: kp[k] for k in ("frame_ms_p50", "frame_ms_p90", "frame_ms_max",
                                         "keyframes", "valid_points", "ate_m")}
    tracker = kp["tracker"]
    mt, cfg = tracker.map, tracker.cfg
    q = cs.newest_keyframe(mt)
    W, Lm = cfg.mapping.local_ba_window, 4 * mt.kf.n_features
    r, o = covis.top_covisible_of(mt, q, W, self_weight=covis.SELF_WEIGHT_PINNED)
    pm = covis.local_map_mask(mt, r, o)
    keym = pm.to(torch.int64) * (M + 1) + torch.arange(M, device=dev)

    def mapping_call():
        rr, oo = covis.top_covisible_of(mt, q, W, self_weight=covis.SELF_WEIGHT_PINNED)
        covis.compact_indices(covis.local_map_mask(mt, rr, oo), Lm)

    out["k7_mapping"] = time_k7(recorded_launches(mapping_call), mapping_call,
                                lambda: torch.topk(keym, Lm), cs.graph_ms)
    out["k7_mapping"]["n_mask"] = int(pm.sum())
    n1 = max(cfg.mapping.local_ba_iters - 2, 1)
    out["k8_call_a"] = time_k8(tracker.cam, kp["kept"]["prob"], n1, cfg.mapping.local_ba_cg_iters,
                               3, cs.graph_ms)
    del kp, tracker, mt
    ep = cs.run_e2e_phase("stereo")
    ecfg = ep["ee"].cfg
    out["k8_gba_chunk"] = time_k8(ep["ee"].cam, ep["kept"]["prob"], 2, ecfg.loop.gba_cg_iters, 2,
                                  cs.graph_ms, counter="ba_dense_gba")
    del ep
    lp = cs.run_e2e_phase("stereo", laps=True)
    out["e2e_laps"] = {k: lp[k] for k in ("frame_ms_p50", "frame_ms_p90", "frame_ms_max",
                                          "n_loops", "gba_started", "gba_finished",
                                          "gba_chunk_ms", "keyframe_ate_m")}
    finish(out, args.out)


def finish(out: dict, path: str) -> None:
    text = json.dumps(out)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(text)
    print(text)


if __name__ == "__main__":
    main()
