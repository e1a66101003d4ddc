"""Bag-of-binary-words vocabulary (port of `corbslam_tpu/place/vocab.py`:
`Vocabulary`, `load` / `load_any` / `default_artifact_path` /
`load_default`, `_assign`, `_assign_tree`, `transform`, `transform_sparse`,
`densify_bow`, `l1_scores`, `l1_scores_batch`).

The port keeps every centre PACKED, LSB-first per byte as descriptors are
(`ops.descriptors.unpack_bits`), so the Hamming distance of a descriptor to
a word is a popcount of their XOR. The reference's artifact stores the
centres MSB-first (`np.packbits`, unpacked with `np.unpackbits`); `load`
unpacks them that way and repacks them LSB-first, so bit position i of a
word meets bit position i of a descriptor as in the reference.

On a CUDA tensor the assignment, the tf-idf histogram (dense and sparse) and
the L1 scores run on kernel K9 (`csrc/vocab.cu`); on a CPU tensor their
plain versions below. Training stays with the reference for now.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import kernels
from ..ops import descriptors as D

TREE_TOP_G = 2        # groups descended per descriptor (the reference's top_g)
PAD_DIST = 1 << 20    # distance of a padded child slot (-1)


class Vocabulary(NamedTuple):
    words: torch.Tensor                # [W, 32] u8 word centres, LSB-first
    idf: torch.Tensor                  # [W] f32
    groups: Optional[torch.Tensor] = None     # [G, 32] u8 group centres (2-level tree)
    child_idx: Optional[torch.Tensor] = None  # [G, Cmax] i32 word ids, -1 padded

    @property
    def n_words(self) -> int:
        return self.words.shape[0]


def pack_lsb(bits: np.ndarray) -> np.ndarray:
    """[..., 256] 0/1 -> [..., 32] u8, bit i of byte k = position 8 k + i."""
    return np.packbits(np.asarray(bits, np.uint8), axis=-1, bitorder="little")


def from_bits(word_bits, idf, group_bits=None, child_idx=None, device="cpu") -> Vocabulary:
    """A Vocabulary on `device` from unpacked 0/1 centres [W, 256] (and the
    tree's [G, 256] / [G, Cmax]), as the reference holds them."""
    dev = torch.device(device)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)  # noqa: E731
    return Vocabulary(
        t(pack_lsb(word_bits), np.uint8), t(idf, np.float32),
        None if group_bits is None else t(pack_lsb(group_bits), np.uint8),
        None if child_idx is None else t(child_idx, np.int32))


def load(path: str, device="cpu") -> Vocabulary:
    """The reference's artifact format (centres packed MSB-first)."""
    z = np.load(path)
    bits = np.unpackbits(z["word_bits_packed"], axis=1)[:, :256]
    if "group_bits_packed" in z:
        gb = np.unpackbits(z["group_bits_packed"], axis=1)[:, :256]
        return from_bits(bits, z["idf"], gb, z["child_idx"], device)
    return from_bits(bits, z["idf"], device=device)


def load_any(path: str, device="cpu") -> Vocabulary:
    """The packed artifact or a raw word_bits / idf npz."""
    z = np.load(path)
    if "word_bits_packed" in z:
        return load(path, device)
    return from_bits(z["word_bits"], z["idf"], device=device)


def default_artifact_path() -> str:
    """The shipped vocabulary, assets/vocab32k.npz at the checkout's root."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "vocab32k.npz")


def load_default(device="cpu") -> Optional[Vocabulary]:
    p = default_artifact_path()
    return load_any(p, device) if os.path.exists(p) else None


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _assign(desc: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Nearest word [F] by Hamming distance, first minimum on ties."""
    return torch.argmin(D.hamming_matrix(desc, words), dim=1).to(torch.int32)


def _assign_tree(desc: torch.Tensor, voc: Vocabulary, top_g: int = TREE_TOP_G) -> torch.Tensor:
    """Two-level descent: the top_g nearest groups (lower index first on
    ties), then their child blocks in that order; a later group replaces the
    best only when strictly nearer; first minimum inside a group."""
    dg = D.hamming_matrix(desc, voc.groups)
    k = min(top_g, voc.groups.shape[0])
    gsel = torch.sort(dg, dim=1, stable=True)[1][:, :k]
    F = desc.shape[0]
    best_d = torch.full((F,), PAD_DIST, dtype=torch.int32, device=desc.device)
    best_w = torch.zeros(F, dtype=torch.int32, device=desc.device)
    for g in gsel.T:
        kids = voc.child_idx[g]                                        # [F, Cmax]
        d = D.popcount_desc(desc[:, None, :] ^ voc.words[kids.clamp_min(0).long()])
        d = torch.where(kids >= 0, d, torch.full_like(d, PAD_DIST))
        j = torch.argmin(d, dim=1, keepdim=True)
        dmin = torch.gather(d, 1, j)[:, 0]
        wmin = torch.gather(kids, 1, j)[:, 0]
        upd = dmin < best_d
        best_d = torch.where(upd, dmin, best_d)
        best_w = torch.where(upd, wmin, best_w)
    return best_w


def assign_plain(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    return _assign_tree(desc, voc) if voc.child_idx is not None else _assign(desc, voc.words)


def histogram_plain(voc: Vocabulary, word: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """L1-normalized tf-idf histogram [W] of the valid rows' words."""
    hist = torch.zeros(voc.n_words, dtype=torch.float32, device=word.device).index_add_(
        0, word.long(), valid.to(torch.float32))
    v = hist * voc.idf
    return v / v.abs().sum().clamp_min(1e-9)


def sparse_plain(voc: Vocabulary, word: torch.Tensor, valid: torch.Tensor):
    """(ids [F], weights [F]) in sorted-word order, -1 after a run's first."""
    W, F = voc.n_words, word.shape[0]
    w = torch.where(valid, word, torch.full_like(word, W))
    sw = torch.sort(w)[0]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=w.device), sw[1:] != sw[:-1]])
    counts = torch.zeros(W + 1, dtype=torch.float32, device=w.device).index_add_(
        0, sw.long(), torch.ones(F, dtype=torch.float32, device=w.device))
    ids = torch.where(first & (sw < W), sw, torch.full_like(sw, -1))
    hit = ids >= 0
    zero = torch.zeros(F, dtype=torch.float32, device=w.device)
    vals = torch.where(hit, counts[sw.clamp(0, W).long()], zero)
    vals = vals * torch.where(hit, voc.idf[ids.clamp_min(0).long()], zero)
    return ids, vals / vals.abs().sum().clamp_min(1e-9)


def l1_scores_plain(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[Q, W] x [N, W] -> [Q, N]: sum_i min(q_i, d_i) over every row."""
    return torch.stack([torch.minimum(q[None, :], db).sum(dim=1) for q in queries])


# ---------------------------------------------------------------------------
# Wrappers (K9 on the card)
# ---------------------------------------------------------------------------

def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check_voc(voc: Vocabulary, dev) -> None:
    W = voc.n_words
    kernels.check(voc.words, "voc.words", torch.uint8, (W, 32), dev)
    kernels.check(voc.idf, "voc.idf", torch.float32, (W,), dev)
    if voc.child_idx is not None:
        G = voc.groups.shape[0]
        kernels.check(voc.groups, "voc.groups", torch.uint8, (G, 32), dev)
        kernels.check(voc.child_idx, "voc.child_idx", torch.int32, (G, voc.child_idx.shape[1]),
                      dev)


def assign(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """Word id [F] i32 of each packed descriptor [F, 32]."""
    if not _on_cuda(desc):
        return assign_plain(voc, desc)
    dev, F = desc.device, desc.shape[0]
    _check_voc(voc, dev)
    kernels.check(desc, "desc", torch.uint8, (F, 32), dev)
    out = torch.empty(F, dtype=torch.int32, device=dev)
    p = kernels.ptr
    tree = voc.child_idx is not None
    G, C = (voc.groups.shape[0], voc.child_idx.shape[1]) if tree else (0, 0)
    kernels.launch("vocab", "vocab_assign", p(desc), F, p(voc.words), voc.n_words,
                   p(voc.groups) if tree else None, G, p(voc.child_idx) if tree else None, C,
                   min(TREE_TOP_G, G), p(out))
    return out


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Descriptors [F, 32] -> L1-normalized tf-idf BoW vector [W] f32, written
    into `out` (e.g. a database row) when given."""
    word = assign(voc, desc)
    if not word.is_cuda:
        v = histogram_plain(voc, word, valid)
        return v if out is None else out.copy_(v)
    dev, F, W = desc.device, desc.shape[0], voc.n_words
    kernels.check(valid, "valid", torch.bool, (F,), dev)
    if out is None:
        out = torch.empty(W, dtype=torch.float32, device=dev)
    kernels.check(out, "out", torch.float32, (W,), dev)
    p = kernels.ptr
    kernels.launch("vocab", "vocab_hist", p(word), p(valid), F, p(voc.idf), W, p(out))
    return out


def transform_sparse(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """BoW in sparse wire form: (word ids [F] i32, weights [F] f32), -1 padded."""
    word = assign(voc, desc)
    if not word.is_cuda:
        return sparse_plain(voc, word, valid)
    dev, F = desc.device, desc.shape[0]
    if F > 2048:
        raise ValueError(f"transform_sparse: {F} features > 2048 (the kernel's shared memory)")
    kernels.check(valid, "valid", torch.bool, (F,), dev)
    ids = torch.empty(F, dtype=torch.int32, device=dev)
    vals = torch.empty(F, dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("vocab", "vocab_sparse", p(word), p(valid), F, p(voc.idf), voc.n_words,
                   p(ids), p(vals))
    return ids, vals


def densify_bow(n_words: int, ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inverse of transform_sparse: scatter (ids, weights) into [W]."""
    v = torch.zeros(n_words, dtype=torch.float32, device=ids.device)
    return v.index_add_(0, ids.clamp_min(0).long(),
                        torch.where(ids >= 0, vals, torch.zeros_like(vals)))


def l1_scores_batch(queries: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """[Q, W] x [N, W] -> [Q, N] DBoW2 L1 similarities, every row scored."""
    if not _on_cuda(db):
        return l1_scores_plain(queries, db)
    dev = db.device
    N, W = db.shape
    Q = queries.shape[0]
    kernels.check(db, "db", torch.float32, (N, W), dev)
    kernels.check(queries, "queries", torch.float32, (Q, W), dev)
    out = torch.empty(Q, N, dtype=torch.float32, device=dev)
    p = kernels.ptr
    kernels.launch("vocab", "vocab_l1_scores", p(queries), Q, p(db), N, W, p(out))
    return out


def l1_scores(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """One query [W] against a database [N, W] -> [N]."""
    return l1_scores_batch(query[None, :].contiguous(), db)[0]
