"""Global bundle adjustment: the whole map's BA in a worker thread, chunked so
that it can be aborted (port of `corbslam_tpu/loop/gba.py`:
`build_global_problem_dense`, `merge_gba_result`, `GlobalBARunner` without a
device mesh).

The map becomes one dense-plane problem (`ba_dense.problem_from_map`: 512
observations a keyframe, the point-major table's K from one host read of the
most observations a point has) cut to the used rows, and K8 runs it in
chunks of 2 LM iterations with Huber on in every chunk (the reference keeps
its robust kernels for all iterations; one chunk's inlier re-classification
does not carry into the next chunk's active set). Between chunks the worker
looks at the abort flag (the reference's mbStopGBA). A finished result is
folded into the current map by `merge_gba_result`: snapshot rows take their
optimized poses and points, keyframes made during the run move by their
snapshot ancestor's correction along the spanning chain (pointer doubling),
points made during the run follow their reference keyframe.

Threads and streams. The port's map is updated in place, so the snapshot is
taken on the caller's thread and stream: a copy of the map
(`mapstate.clone`) and the problem built from it, then an event. On the card
the worker runs every chunk on a stream of its own that first waits on that
event; each chunk ends with that stream synchronized (what the reference's
`block_until_ready` does), so an abort takes effect between chunks, and the
worker keeps the snapshot referenced until then, so no tensor of the caller's
stream is freed while the worker's stream reads it. The result is published
with an event that `try_merge` makes the caller's current stream wait on.
A kernel launch goes through ctypes, which releases the GIL, so the worker
does not hold up the tracker's host thread.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Optional

import torch

from ..config import SlamConfig
from ..geometry import se3
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..optim import ba_dense

COUNTER = "ba_dense_gba"  # K8's launches of global BA
PM_K_MAX = 128


def point_major_k(m: ms.MapState) -> int:
    """The table's K: the most live observations of any point, as a power of
    two from 8 to 128 (one host read)."""
    idx = m.kf.mp_idx
    ok = (idx >= 0) & m.kf.fvalid & m.kf.valid[:, None]
    M = m.mp.capacity
    keys = torch.where(ok, idx, torch.full_like(idx, M)).reshape(-1).long()
    max_obs = int(torch.bincount(keys, minlength=M + 1)[:M].max())
    pm_k = 8
    while pm_k < max_obs and pm_k < PM_K_MAX:
        pm_k *= 2
    if max_obs > PM_K_MAX:
        print(f"[gba] pm_k capped at {PM_K_MAX} but max obs/point is {max_obs}; the "
              "observations past the even-stride sample are dropped from the table",
              file=sys.stderr)
    return pm_k


def build_global_problem_dense(m: ms.MapState, cfg: SlamConfig, n_kf_hint: Optional[int] = None,
                               n_mp_hint: Optional[int] = None) -> ba_dense.BADense:
    """The map as one BADense (the dense path; row 0 is the gauge). With the
    hints (host cursors) it is cut to the used rows, rounded up to a multiple
    of 256 cameras / 8192 points and at most the map's capacity. Tcw and X are
    views of the map's tensors."""
    p = ba_dense.problem_from_map(m, cfg.orb.scale_factor, cfg.loop.gba_obs_per_kf,
                                  pm_k=point_major_k(m), counter=COUNTER)
    if n_kf_hint is not None:
        Cr = ba_dense.round_up(n_kf_hint, 256, m.kf.capacity)
        Pr = ba_dense.round_up(n_mp_hint or m.mp.capacity, 8192, m.mp.capacity)
        p = ba_dense.slice_problem(p, Cr, Pr)
    return p


def merge_gba_result(m: ms.MapState, Tcw_opt: torch.Tensor, X_opt: torch.Tensor, n_kf_snap: int,
                     n_mp_snap: int) -> ms.MapState:
    """A finished GBA result [N, 4, 4] / [M, 3] folded into the current map
    (LoopClosing.cc:685-755): rows < n_kf_snap take the optimized pose, later
    rows move by the right-delta T_old^-1 T_opt of their snapshot ancestor
    along the spanning chain (12 rounds of pointer doubling: chains up to
    4096 rows; a row without one keeps its pose); points < n_mp_snap take the
    optimized position, later points follow their reference keyframe.
    Returns a new MapState whose pose and position tables are new tensors."""
    N, dev = m.kf.capacity, m.kf.Tcw.device
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    in_snap = rows < n_kf_snap
    T_old = m.kf.Tcw
    D = se3.compose(se3.inverse(T_old), Tcw_opt)
    parent = covis.spanning_parents(m)
    anc = torch.where(in_snap | (parent < 0), rows, parent)
    for _ in range(12):
        a = anc.clamp_min(0).long()
        step = anc[a]
        done = in_snap[a] | (step == anc)
        anc = torch.where(done, anc, step)
    a = anc.clamp_min(0).long()
    eye = torch.eye(4, dtype=T_old.dtype, device=dev).expand(N, 4, 4)
    D_row = torch.where(in_snap[a][:, None, None], D[a], eye)
    T_prop = se3.compose(T_old, D_row)
    writable = m.kf.valid & ~m.kf.fixed
    T_new = se3.orthonormalize_fast(torch.where(in_snap[:, None, None], Tcw_opt, T_prop))
    T_new = torch.where(writable[:, None, None], T_new, T_old)
    M = m.mp.capacity
    ref = m.mp.ref_kf.clamp_min(0).long()
    p_cam = se3.transform(T_old[ref], m.mp.pos)
    p_prop = se3.transform(se3.inverse(T_new[ref]), p_cam)
    snap_mp = torch.arange(M, device=dev) < n_mp_snap
    p_out = torch.where(snap_mp[:, None], X_opt, p_prop)
    move = m.mp.valid & ~m.mp.fixed
    pos = torch.where(move[:, None], p_out, m.mp.pos)
    return m._replace(kf=m.kf._replace(Tcw=T_new), mp=m.mp._replace(pos=pos))


class GlobalBARunner:
    """Background GBA with cancellation (the reference's mbStopGBA protocol).

    launch(map)  - snapshot the map, start (or, synchronous, run) the worker
    abort()      - cancel between LM chunks (a new loop closure invalidates
                   the running GBA, LoopClosing.cc:413-428)
    try_merge(m) - if a run finished, fold its result into the current map
    """

    def __init__(self, cam, cfg: SlamConfig, n_iters: Optional[int] = None, chunk: int = 2,
                 synchronous: bool = False):
        self.cam = cam
        self.cfg = cfg
        self.n_iters = n_iters if n_iters is not None else cfg.loop.global_ba_iters
        self.chunk = chunk
        self.synchronous = synchronous
        self._abort = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._result = None  # (Tcw, X, n_kf_snap, n_mp_snap, event or None)
        self._error: Optional[BaseException] = None
        self._stream = None
        self.runs_started = 0
        self.runs_aborted = 0
        self.runs_finished = 0

    # ------------------------------------------------------------------
    def launch(self, m: ms.MapState):
        self.abort()
        self._abort.clear()
        self.runs_started += 1
        n_kf, n_mp = int(m.n_kf), int(m.n_mp)
        snap_m = ms.clone(m)
        prob = build_global_problem_dense(snap_m, self.cfg, n_kf_hint=n_kf, n_mp_hint=n_mp)
        ready = None
        if prob.X.is_cuda:
            ready = torch.cuda.Event()
            ready.record()
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=prob.X.device)
        snap = (prob, n_kf, n_mp, snap_m.kf.Tcw, snap_m.mp.pos, ready)
        if self.synchronous:
            self._run(snap)
            self._raise()
        else:
            self._thread = threading.Thread(target=self._run, args=(snap,), daemon=True)
            self._thread.start()

    def abort(self):
        if self._thread is not None and self._thread.is_alive():
            self._abort.set()
            self._thread.join()
            self.runs_aborted += 1
        self._thread = None
        with self._lock:
            self._result = None
        self._raise()

    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        self._raise()

    def _raise(self):
        """Re-raise, on the caller's thread, a failure of the worker."""
        err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("global BA worker failed") from err

    # ------------------------------------------------------------------
    def _chunk(self, prob: ba_dense.BADense, k: int) -> ba_dense.BADenseResult:
        """One chunk of k LM iterations, Huber on throughout."""
        return ba_dense.optimize(self.cam, prob, n_iters=k, cg_iters=self.cfg.loop.gba_cg_iters,
                                 huber_iters=k, counter=COUNTER)

    def _run(self, snap):
        try:
            self._run_chunks(snap)
        except BaseException as e:  # handed to the caller's thread by _raise
            self._error = e

    def _run_chunks(self, snap):
        prob, n_kf_snap, n_mp_snap, Tcw_full, X_full, ready = snap
        stream = self._stream if ready is not None else None
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            if stream is not None:
                stream.wait_event(ready)
            done = 0
            while done < self.n_iters:
                if self._abort.is_set():
                    return
                k = min(self.chunk, self.n_iters - done)
                res = self._chunk(prob, k)
                if stream is not None:
                    stream.synchronize()
                prob = prob._replace(Tcw=res.Tcw, X=res.X)
                done += k
            # The optimized slice back into the snapshot's capacity-shaped
            # tables (rows past the slice keep their pre-BA values; the merge
            # reads only rows under the snapshot cursors).
            Tcw_full[:prob.Tcw.shape[0]] = prob.Tcw
            X_full[:prob.X.shape[0]] = prob.X
            finished = None
            if stream is not None:
                finished = torch.cuda.Event()
                finished.record(stream)
                stream.synchronize()  # an abort may drop the snapshot at once
        with self._lock:
            self._result = (Tcw_full, X_full, n_kf_snap, n_mp_snap, finished)
        self.runs_finished += 1

    def try_merge(self, m: ms.MapState) -> ms.MapState:
        self._raise()
        with self._lock:
            result, self._result = self._result, None
        if result is None:
            return m
        Tcw, X, n_kf_snap, n_mp_snap, finished = result
        if finished is not None:
            torch.cuda.current_stream().wait_event(finished)
        return merge_gba_result(m, Tcw, X, n_kf_snap, n_mp_snap)
