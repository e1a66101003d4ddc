"""Relocalization of a LOST frame against the keyframe database (port of
`corbslam_tpu/frontend/reloc.py`: `try_relocalize_against`, `relocalize`).

Tracking::Relocalization (Tracking.cc:1368): BoW candidates (K9), then per
candidate descriptor matching against its bound points (K5), PnP RANSAC
(K10) and the motion-only LM with re-classification (K6). The host walks
the short candidate list and reads one flag per candidate. The RANSAC
sample comes from the caller's `torch.Generator` (or `sample` [256, 6]).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SlamConfig
from ..mapstate import mapstate as ms
from ..matching import matcher
from ..optim import pose_opt
from ..place import database as db_mod
from ..place import vocab as vocab_mod
from ..solvers import pnp as pnp_mod


class RelocResult(NamedTuple):
    Tcw: torch.Tensor
    mp_idx: torch.Tensor   # [F] map-point rows of the frame's features
    n_inliers: torch.Tensor
    ok: torch.Tensor


def reloc_matches(m: ms.MapState, cand_row: int, frame, cfg: SlamConfig):
    """The PnP's correspondences: the frame's features matched by descriptor
    to the candidate's bound points (K5). Returns (rows [F] map-point row or
    NO_MP, hit [F], X [F, 3], sigma2 [F])."""
    mp_c = m.kf.mp_idx[cand_row]
    res = matcher.search_by_descriptor(frame.desc, frame.fvalid, m.kf.desc[cand_row],
                                       m.kf.fvalid[cand_row] & (mp_c >= 0),
                                       max_dist=cfg.matcher.th_low, ratio=0.75)
    hit = res.idx >= 0
    rows = torch.where(hit, mp_c[res.idx.clamp_min(0).long()], torch.full_like(res.idx, ms.NO_MP))
    hit &= rows >= 0
    X = m.mp.pos[rows.clamp_min(0).long()].contiguous()
    sigma2 = (cfg.orb.scale_factor ** 2) ** frame.octave.to(torch.float32)
    return rows, hit, X, sigma2.contiguous()


def try_relocalize_against(cam, m: ms.MapState, cand_row: int, frame, cfg: SlamConfig,
                           generator: Optional[torch.Generator] = None,
                           sample: Optional[torch.Tensor] = None) -> RelocResult:
    """Verify one candidate keyframe: match, PnP RANSAC (256 hypotheses),
    then the pose LM over the consensus; ok needs the PnP gate and >= 30 LM
    inliers."""
    rows, hit, X, sigma2 = reloc_matches(m, cand_row, frame, cfg)
    pnp = pnp_mod.solve_pnp_ransac(cam, X, frame.xy.contiguous(), hit, sigma2,
                                   generator=generator, n_hyp=256,
                                   min_inliers=cfg.tracking.min_matches_reloc, idx=sample)
    uvr = torch.cat([frame.xy, frame.uright[:, None]], dim=-1).contiguous()
    opt = pose_opt.optimize_pose(cam, pnp.Tcw, X, uvr, (1.0 / sigma2).contiguous(),
                                 (frame.uright > 0).contiguous(), pnp.inliers)
    mp_idx = torch.where(opt.inliers, rows, torch.full_like(rows, ms.NO_MP))
    n = opt.inliers.sum(dtype=torch.int32)
    return RelocResult(opt.Tcw, mp_idx, n, pnp.ok & (n >= 30))


def relocalize(cam, m: ms.MapState, db: db_mod.BowDatabase, voc: vocab_mod.Vocabulary, frame,
               cfg: SlamConfig, generator: Optional[torch.Generator] = None,
               k: int = 5) -> Optional[RelocResult]:
    """BoW candidates of the frame, verified in rank order; the first that
    passes, or None."""
    bow = vocab_mod.transform(voc, frame.desc, frame.fvalid)
    rows, ok = db_mod.detect_relocalization_candidates(db, m, bow, k=k)
    rows_l, ok_l = torch.stack([rows, ok.to(torch.int32)]).tolist()
    for r, o in zip(rows_l, ok_l):
        if not o:
            continue
        res = try_relocalize_against(cam, m, r, frame, cfg, generator=generator)
        if bool(res.ok):
            return res
    return None
