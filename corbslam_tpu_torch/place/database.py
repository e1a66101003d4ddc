"""Keyframe database: BoW retrieval for loop detection and relocalization
(port of `corbslam_tpu/place/database.py`: `BowDatabase`,
`detect_loop_candidates`, `detect_relocalization_candidates`,
`detect_map_fusion_candidates`, `detect_map_fusion_pairs`).

The database is a dense [N, W] f32 BoW matrix aligned with the keyframe rows
(256 MB at 2048 x 32768 on the card); rows are written in place where the
reference returns a new matrix, and the methods return the same object.
Scores come from K9's `l1_scores`, over every row: a live keyframe whose
loop stage is still queued is scored against what its row holds (zeros, or
a stale row left by `reorder`), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..mapping.local_mapping import last_wins
from ..mapstate import covisibility as covis
from ..mapstate.mapstate import MapState
from . import vocab as vocab_mod


class BowDatabase(NamedTuple):
    bow: torch.Tensor    # [N, W] f32 L1-normalized tf-idf
    valid: torch.Tensor  # [N]

    @staticmethod
    def empty(n_kf: int, n_words: int, device="cpu") -> "BowDatabase":
        return BowDatabase(torch.zeros(n_kf, n_words, dtype=torch.float32, device=device),
                           torch.zeros(n_kf, dtype=torch.bool, device=device))

    def add(self, row: int, v: Optional[torch.Tensor] = None) -> "BowDatabase":
        """Set row `row` to v (when v is None the caller already wrote it)."""
        if v is not None:
            self.bow[row] = v
        self.valid[row] = True
        return self

    def add_batch(self, rows: torch.Tensor, vs: torch.Tensor,
                  ok: Optional[torch.Tensor] = None) -> "BowDatabase":
        """Insert a row batch; `ok=False` lanes are dropped and a row named
        twice keeps the last lane's vector, as the reference's in-order
        scatter with mode="drop" does."""
        N = self.bow.shape[0]
        if ok is None:
            ok = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
        tgt = torch.where(ok & (rows >= 0) & (rows < N), rows, torch.full_like(rows, N))
        src = last_wins(tgt, N + 1)
        keep = tgt < N
        self.bow[tgt[keep].long()] = vs[src[keep]]
        self.valid[tgt[keep].long()] = True
        return self

    def remove(self, kill: torch.Tensor) -> "BowDatabase":
        self.valid.logical_and_(~kill)
        return self

    def reorder(self, order: torch.Tensor, n_valid) -> "BowDatabase":
        """Follow a map compaction (`mapstate.compact`'s kf_order)."""
        keep = torch.arange(order.shape[0], device=order.device) < n_valid
        o = order.long()
        return BowDatabase(self.bow[o], self.valid[o] & keep)


def detect_loop_candidates(db: BowDatabase, m: MapState, query_row: int, query_bow: torch.Tensor,
                           k: int = 8, min_covis_weight: int = 15, min_row_gap: int = 12):
    """DetectLoopCandidates (KeyFrameDatabase.cc:73): every keyframe but the
    query's connected ones (covisible over the candidate window, or of the
    same client within min_row_gap rows), above the worst score among those
    neighbours; each of the top raw scores accumulates its covisibility
    group, and candidates under 0.75 x the best group are cut. Returns
    (rows [k] i32, ok [k])."""
    N = m.kf.capacity
    dev = query_bow.device
    scores = vocab_mod.l1_scores(query_bow, db.bow)
    cand_q, w_q = covis.candidate_covis_weights(m, query_row)
    neighbor = covis.scatter_mask(cand_q, w_q >= min_covis_weight, N)
    rows = torch.arange(N, dtype=torch.int32, device=dev)
    neighbor |= (m.kf.client == m.kf.client[query_row]) & ((rows - query_row).abs() < min_row_gap)
    neighbor &= m.kf.valid
    neighbor_or_self = neighbor.clone()
    neighbor_or_self[query_row] = True
    inf = torch.full_like(scores, float("inf"))
    min_score = torch.where(neighbor, scores, inf).min()
    min_score = torch.where(torch.isinf(min_score), torch.zeros_like(min_score), min_score)
    eligible = db.valid & m.kf.valid & ~neighbor_or_self & (scores >= min_score)
    C0 = max(k, 16)
    v0, r0 = covis.topk_stable(torch.where(eligible, scores, -inf), C0)
    r0 = r0.to(torch.int32)
    grp, gok = covis.covis_groups_rows(m, r0, n_group=10)
    g = grp.long()
    others = gok & eligible[g] & (grp != r0[:, None])
    acc = torch.where(others, scores[g], torch.zeros_like(scores[g])).sum(dim=1)
    fin = torch.isfinite(v0)
    acc = acc + torch.where(fin, v0, torch.zeros_like(v0))
    acc = torch.where(fin, acc, -inf[:C0])
    keepv = torch.where(acc >= 0.75 * acc.max(), v0, -inf[:C0])
    vals, ri = covis.topk_stable(keepv, k)
    return r0[ri], torch.isfinite(vals)


def detect_relocalization_candidates(db: BowDatabase, m: MapState, query_bow: torch.Tensor,
                                     k: int = 8):
    """DetectRelocalizationCandidates (KeyFrameDatabase.cc:297): the top-k
    scores of the live rows, cut at 0.75 x the best."""
    scores = vocab_mod.l1_scores(query_bow, db.bow)
    key = torch.where(db.valid & m.kf.valid, scores, torch.full_like(scores, float("-inf")))
    vals, rows = covis.topk_stable(key, k)
    return rows.to(torch.int32), torch.isfinite(vals) & (vals >= 0.75 * vals[0])


def detect_map_fusion_candidates(db: BowDatabase, m: MapState, query_bow: torch.Tensor,
                                 k: int = 8):
    """Server-side inter-map overlap candidates (DetectMapFusionCandidatesFromDB,
    KeyFrameDatabase.cc:189): a relocalization-style query against another
    client's map."""
    return detect_relocalization_candidates(db, m, query_bow, k)


FUSION_PAIRS = 16  # (query, row) pairs returned by detect_map_fusion_pairs


def detect_map_fusion_pairs(db: BowDatabase, db_kf_valid: torch.Tensor, bows: torch.Tensor,
                            q_ok: torch.Tensor):
    """Every query of a sub-map block (bows [Q, W], q_ok [Q]) scored against
    the whole database in one K9 launch; the 16 best (query, row) pairs of the
    flattened [Q N] scores, best first and the lower flat index first on
    ties (`lax.top_k`). Returns (q_idx [16], rows [16], scores [16], ok [16])."""
    scores = vocab_mod.l1_scores_batch(bows, db.bow)
    eligible = (db.valid & db_kf_valid)[None, :] & q_ok[:, None]
    flat = torch.where(eligible, scores, torch.full_like(scores, float("-inf"))).reshape(-1)
    vals, idx = covis.topk_stable(flat, FUSION_PAIRS)
    N = db.bow.shape[0]
    return idx // N, idx % N, vals, torch.isfinite(vals)
