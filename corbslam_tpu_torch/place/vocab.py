"""Bag-of-binary-words vocabulary (port of `corbslam_tpu/place/vocab.py`:
`Vocabulary`, `load` / `load_any` / `save` / `default_artifact_path` /
`load_default`, `_assign`, `_assign_tree`, `transform`, `transform_sparse`,
`transform_batch`, `transform_many`, `densify_bow`, `l1_scores`,
`l1_scores_batch`, and the training:
`_kmajority` as `kmajority`, `train`, `train_chunked`, `train_hierarchical`,
`build_tree`).

The port keeps every centre PACKED, LSB-first per byte as descriptors are
(`ops.descriptors.unpack_bits`), so the Hamming distance of a descriptor to
a word is a popcount of their XOR. The reference's artifact stores the
centres MSB-first (`np.packbits`, unpacked with `np.unpackbits`); `load`
unpacks them that way and repacks them LSB-first, so bit position i of a
word meets bit position i of a descriptor as in the reference.

On a CUDA tensor the assignment, the tf-idf histogram (dense and sparse),
the batched transform of a block of keyframes (one launch) and the L1
scores run on kernel K9 (`csrc/vocab.cu`); on a CPU tensor their plain
versions below.

Training is binary k-majority: each iteration assigns every descriptor to
its nearest centre (first minimum), tallies per centre the descriptors and
the 1-bits of each of the 256 positions (integer sums, times a row weight),
and sets a centre bit where 2 ones > count (a tie gives 0); a centre with no
descriptor keeps its bits. The idf comes from the last iteration's counts,
taken against the centres before the last update. On a CUDA tensor
`kmajority` runs the whole loop on the card with kernel K14
(`csrc/kmajority.cu`: one cooperative launch a call, the assignment a
tensor-core product), with no host sync; on a CPU tensor `kmajority_plain`, which walks the corpus in chunks so that no
[N, W] distance matrix is ever whole. Trained centres are packed LSB-first
like loaded ones, and `save` writes the reference's format (MSB-first), so
the reference's `load` reads a vocabulary trained here.

The initial centres are drawn from a `torch.Generator` seeded with `seed`
(`randperm` when the corpus has at least W rows, else `randint` with
replacement, as the reference's `replace=n < W`); the reference draws with
`jax.random.choice`, so parity tests pass its index array as `init_idx`.
Level 2 of `train_hierarchical` draws with `np.random.default_rng(seed + 7)`
exactly as the reference does.
"""

from __future__ import annotations

import os
from functools import partial
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
    # The tree's child blocks group by group for the batched transform's
    # staging (`with_tree_layout`: the loaders and builders fill them; a
    # tree made by hand, or given new words, needs it again).
    child_words: Optional[torch.Tensor] = None  # [G, Cp, 32] u8
    child_keys: Optional[torch.Tensor] = None   # [G, Cp] i32

    @property
    def n_words(self) -> int:
        return self.words.shape[0]


def pack_lsb(bits: np.ndarray) -> np.ndarray:
    """[..., 256] 0/1 -> [..., 32] u8, bit i of byte k = position 8 k + i."""
    return np.packbits(np.asarray(bits, np.uint8), axis=-1, bitorder="little")


def from_bits(word_bits, idf, group_bits=None, child_idx=None, device="cuda") -> Vocabulary:
    """A Vocabulary on `device` from unpacked 0/1 centres [W, 256] (and the
    tree's [G, 256] / [G, Cmax]), as the reference holds them. Like the
    entry points, the loaders default to the card and raise without one;
    pass device="cpu" for the plain path."""
    dev = kernels.resolve_device(device)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)  # noqa: E731
    return with_tree_layout(Vocabulary(
        t(pack_lsb(word_bits), np.uint8), t(idf, np.float32),
        None if group_bits is None else t(pack_lsb(group_bits), np.uint8),
        None if child_idx is None else t(child_idx, np.int32)))


def load(path: str, device="cuda") -> Vocabulary:
    """The reference's artifact format (centres packed MSB-first)."""
    z = np.load(path)
    bits = np.unpackbits(z["word_bits_packed"], axis=1)[:, :256]
    if "group_bits_packed" in z:
        gb = np.unpackbits(z["group_bits_packed"], axis=1)[:, :256]
        return from_bits(bits, z["idf"], gb, z["child_idx"], device)
    return from_bits(bits, z["idf"], device=device)


def load_any(path: str, device="cuda") -> Vocabulary:
    """The packed artifact or a raw word_bits / idf npz."""
    z = np.load(path)
    if "word_bits_packed" in z:
        return load(path, device)
    return from_bits(z["word_bits"], z["idf"], device=device)


def default_artifact_path() -> str:
    """The shipped vocabulary, assets/vocab32k.npz at the checkout's root."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "vocab32k.npz")


def load_default(device="cuda") -> Optional[Vocabulary]:
    p = default_artifact_path()
    return load_any(p, device) if os.path.exists(p) else None


def save(voc: Vocabulary, path: str) -> None:
    """The reference's artifact format: centres packed MSB-first
    (`np.packbits` of the 0/1 bits), idf, and the tree when there is one."""
    def msb(packed):
        return np.packbits(D.unpack_bits(packed).cpu().numpy().astype(np.uint8), axis=1)

    extra = {}
    if voc.groups is not None:
        extra = dict(group_bits_packed=msb(voc.groups),
                     child_idx=voc.child_idx.cpu().numpy().astype(np.int32))
    np.savez_compressed(path, word_bits_packed=msb(voc.words),
                        idf=voc.idf.cpu().numpy().astype(np.float32), **extra)


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


def assign(voc: Vocabulary, desc: torch.Tensor, counter: str = "vocab") -> torch.Tensor:
    """Word id [F] i32 of each packed descriptor [F, 32]; a launch counts as
    `counter`."""
    if not _on_cuda(desc):
        return assign_plain(voc, desc)
    dev, F = desc.device, desc.shape[0]
    _check_voc(voc, dev)
    kernels.check(desc, "desc", torch.uint8, (F, 32), dev)
    out = torch.empty(F, dtype=torch.int32, device=dev)
    p = kernels.ptr
    tree = voc.child_idx is not None
    G, C = (voc.groups.shape[0], voc.child_idx.shape[1]) if tree else (0, 0)
    kernels.launch(counter, "vocab_assign", p(desc), F, p(voc.words), voc.n_words,
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
    kernels.launch("vocab", "vocab_hist", p(word), p(valid), 1, F, p(voc.idf), W, p(out))
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


# The batched launch (`vocab_transform_batch`): a CTA a (keyframe row, chunk
# of descriptors); its limits are its shared memory's.
TB_THREADS = 256        # the CTA, whose block_sum order the plain version repeats
TB_CHUNK_MAX = 1024     # descriptors a CTA, at most
TB_TARGET_CTAS = 264    # the chunk aims at two CTAs on each of the H100's 132 SMs
TB_MAX_F, TB_MAX_G, TB_MAX_C, TB_MAX_W = 4096, 4096, 256, 65536
TB_TICKETS = 24         # workspace words before the row tickets (stamps at 8..)


def batch_chunk(B: int, F: int) -> int:
    """Descriptors a CTA of the batched launch: enough chunks a row to give
    about TB_TARGET_CTAS CTAs, a multiple of 16 (a tensor-core tile)."""
    per_row = max(1, -(-TB_TARGET_CTAS // max(B, 1)))
    chunk = -(-max(F, 1) // per_row)
    return min(TB_CHUNK_MAX, max(16, -(-chunk // 16) * 16))


def check_batch_capacity(voc: Vocabulary, B: int, F: int) -> None:
    """Raise ValueError for a block the batched launch cannot take."""
    W = voc.n_words
    if F > TB_MAX_F or B > 65535 or W > TB_MAX_W:
        raise ValueError(f"transform_batch: B {B} / F {F} / W {W} beyond the kernel's "
                         f"65535 / {TB_MAX_F} / {TB_MAX_W}")
    if voc.child_idx is not None:
        G, C = voc.child_idx.shape
        if G > TB_MAX_G or not 1 <= C <= TB_MAX_C:
            raise ValueError(f"transform_batch: a tree of {G} groups x {C} children is beyond "
                             f"the kernel's {TB_MAX_G} x 1..{TB_MAX_C}")


def tree_layout(voc: Vocabulary):
    """The tree's child blocks laid out group by group for the batched
    launch's staging: words [G, Cp, 32] u8, slot j of group g holding word
    child_idx[g, j] (zeros where padded), and keys [G, Cp] i32, (popc + 256)
    << 16 | j for a child, 0xFFFF << 16 | j for a padded one (-1), -1 (all
    ones) past C; Cp is C rounded up to 8 (a tensor-core tile's columns)."""
    G, C = voc.child_idx.shape
    Cp = -(-C // 8) * 8
    kid = torch.full((G, Cp), -2, dtype=torch.int64, device=voc.words.device)
    kid[:, :C] = voc.child_idx.long()
    real = kid >= 0
    words = torch.where(real[..., None], voc.words[kid.clamp_min(0)],
                        torch.zeros((), dtype=torch.uint8, device=kid.device)).contiguous()
    j = torch.arange(Cp, dtype=torch.int64, device=kid.device).expand(G, Cp)
    keys = torch.where(real, ((D.popcount_desc(words).long() + 256) << 16) | j,
                       torch.where(kid == -2, torch.full_like(j, 0xFFFFFFFF), (0xFFFF << 16) | j))
    keys = keys.where(keys < (1 << 31), keys - (1 << 32)).to(torch.int32).contiguous()
    return words, keys


def with_tree_layout(voc: Vocabulary) -> Vocabulary:
    """`voc` with its `tree_layout` in child_words / child_keys (a flat
    vocabulary as it is)."""
    if voc.child_idx is None:
        return voc._replace(child_words=None, child_keys=None)
    gw, gk = tree_layout(voc)
    return voc._replace(child_words=gw, child_keys=gk)


def cta_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of x [n] in the order of the batched kernel's block_sum: thread i
    of 256 adds x[i], x[i + 256], ... in turn from 0, each warp halves its
    32 partials to one, and the 8 warp sums are halved to one."""
    T = TB_THREADS
    n = max(-(-x.numel() // T), 1)
    acc = x.new_zeros(T)
    for r in torch.cat([x, x.new_zeros(n * T - x.numel())]).view(n, T):
        acc = acc + r
    acc = acc.view(T // 32, 32)
    st = 16
    while st:
        acc = acc[:, :st] + acc[:, st:2 * st]
        st //= 2
    acc = acc[:, 0]
    st = T // 64
    while st:
        acc = acc[:st] + acc[st:2 * st]
        st //= 2
    return acc[0]


def batch_words_plain(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The batched launch's word ids [B, F]: each descriptor's word, -1 for
    an invalid feature."""
    B, F = desc.shape[0], desc.shape[1]
    word = assign_plain(voc, desc.reshape(B * F, 32)).view(B, F)
    return torch.where(valid, word, torch.full_like(word, -1))


def transform_batch_plain(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Plain version of `transform_batch`: one assignment of the B x F
    descriptors; then each row's valid words sorted and counted, the L1
    norm of the nonzeros summed in the kernel's order (`cta_sum` over the
    runs in word order) and the nonzeros divided by it."""
    out = torch.zeros(desc.shape[0], voc.n_words, dtype=torch.float32, device=desc.device)
    for row, w in zip(out, batch_words_plain(voc, desc, valid)):
        ids, counts = torch.unique(w[w >= 0], sorted=True, return_counts=True)
        v = counts.to(torch.float32) * voc.idf[ids.long()]
        row[ids.long()] = v / cta_sum(v.abs()).clamp_min(1e-9)
    return out


def transform_batch_words(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """`transform_batch` with its word ids: (BoW [B, W], words [B, F], -1 for
    an invalid feature). On the card one launch (`vocab_transform_batch`,
    counted as "vocab_batch") of a CTA a (row, `batch_chunk` descriptors),
    a tree's child blocks staged from its child_words / child_keys. Raises
    ValueError for a block the kernel cannot take (`check_batch_capacity`)
    and for a tree without that layout."""
    if not _on_cuda(desc):
        return transform_batch_plain(voc, desc, valid), batch_words_plain(voc, desc, valid)
    dev, W = desc.device, voc.n_words
    B, F = desc.shape[0], desc.shape[1]
    _check_voc(voc, dev)
    kernels.check(desc, "desc", torch.uint8, (B, F, 32), dev)
    kernels.check(valid, "valid", torch.bool, (B, F), dev)
    check_batch_capacity(voc, B, F)
    tree = voc.child_idx is not None
    G, C = (voc.groups.shape[0], voc.child_idx.shape[1]) if tree else (0, 0)
    gw, gk = voc.child_words, voc.child_keys
    if tree:
        if gw is None or gk is None:
            raise ValueError("transform_batch: a tree Vocabulary without its child_words / "
                             "child_keys (vocab.with_tree_layout makes them)")
        Cp = -(-C // 8) * 8
        kernels.check(gw, "voc.child_words", torch.uint8, (G, Cp, 32), dev)
        kernels.check(gk, "voc.child_keys", torch.int32, (G, Cp), dev)
    out = torch.empty(B, W, dtype=torch.float32, device=dev)
    words = torch.empty(B, F, dtype=torch.int32, device=dev)
    work = kernels.workspace("vocab_batch", dev, kernels.stream(), TB_TICKETS + B)
    p = kernels.ptr
    opt = lambda t: None if t is None else p(t)  # noqa: E731
    kernels.launch("vocab_batch", "vocab_transform_batch", p(desc), p(valid), B, F,
                   p(voc.words), W, opt(voc.groups), G, opt(voc.child_idx), C, opt(gw), opt(gk),
                   min(TREE_TOP_G, G), p(voc.idf), batch_chunk(B, F), p(words), p(out),
                   p(work))
    return out, words


def transform_batch(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Descriptors [B, F, 32] of B keyframes -> their BoW vectors [B, W] (the
    reference's vmap of `transform`). On the card one K9 launch a call,
    counted as "vocab_batch" (`transform_batch_words`)."""
    return transform_batch_words(voc, desc, valid)[0]


def transform_many(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, F, 32] -> [B, W]: the reference bounds its memory here with a
    sequential map over the rows; on the card the batched path never holds a
    [B, F, W] tensor, so this is `transform_batch`."""
    return transform_batch(voc, desc, valid)


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


# ---------------------------------------------------------------------------
# Training: binary k-majority (K14 on the card)
# ---------------------------------------------------------------------------

TRAIN_CHUNK = 65536  # descriptors per step of the plain version


def _block_assign(desc: torch.Tensor, words: torch.Tensor, grp: torch.Tensor, B: int):
    """Nearest of the B words of block grp[f] (global id), first minimum."""
    W = words.shape[0]
    blocks = words.view(W // B, B, 32)[grp.long()]                      # [n, B, 32]
    d = D.popcount_desc(desc[:, None, :] ^ blocks)
    return (grp * B + torch.argmin(d, dim=1).to(torch.int32)).to(torch.int32)


def assign_flat_plain(desc: torch.Tensor, words: torch.Tensor, chunk: int = TRAIN_CHUNK):
    """Nearest centre [N] i32 of every descriptor, chunked over N."""
    return torch.cat([_assign(desc[s:s + chunk], words)
                      for s in range(0, desc.shape[0], chunk)]) if desc.shape[0] else \
        torch.zeros(0, dtype=torch.int32, device=desc.device)


def kmajority_plain(desc: torch.Tensor, init: torch.Tensor, n_iters: int,
                    weight: Optional[torch.Tensor] = None, group: Optional[torch.Tensor] = None,
                    block: int = 0, chunk: int = TRAIN_CHUNK):
    """Plain version of K14: (centres [W, 32] u8 packed LSB-first, counts [W]
    i32 of the last iteration). `weight` [N] i32 scales each row's vote;
    with `group` [N] i32 a descriptor's argmin runs over block
    [g B, (g + 1) B) of its group g only (level 2 of train_hierarchical)."""
    dev = desc.device
    W = init.shape[0]
    words = init.clone()
    counts = torch.zeros(W, dtype=torch.int64, device=dev)
    for _ in range(n_iters):
        ones = torch.zeros(W, 256, dtype=torch.int64, device=dev)
        counts = torch.zeros(W, dtype=torch.int64, device=dev)
        for s in range(0, desc.shape[0], chunk):
            dc = desc[s:s + chunk]
            a = (_assign(dc, words) if group is None
                 else _block_assign(dc, words, group[s:s + chunk], block)).long()
            w = (torch.ones(dc.shape[0], dtype=torch.int64, device=dev) if weight is None
                 else weight[s:s + chunk].to(torch.int64))
            ones.index_add_(0, a, D.unpack_bits(dc).to(torch.int64) * w[:, None])
            counts.index_add_(0, a, w)
        maj = 2 * ones > counts[:, None]
        bits = torch.where((counts > 0)[:, None], maj, D.unpack_bits(words).bool())
        words = D.pack_bits(bits)
    return words, counts.to(torch.int32)


def idf_plain(counts: torch.Tensor) -> torch.Tensor:
    """log(max(sum counts, 1) / max(count, 1)) in f32."""
    n_total = counts.to(torch.int64).sum().clamp_min(1).to(torch.float32)
    return torch.log(n_total / counts.to(torch.float32).clamp_min(1.0))


KM_MAX_WORDS = 1 << 16  # centres of one K14 call, at most (MAX_W in csrc/kmajority.cu)


def check_capacity(n_words: int, device) -> None:
    """Raises when K14 cannot take `n_words` centres on `device` (the plain
    version takes any number): the trainers call it before they touch the
    corpus."""
    if torch.device(device).type == "cuda" and n_words > KM_MAX_WORDS:
        raise ValueError(f"{n_words} centres: K14 takes at most {KM_MAX_WORDS}")


def _check_train(desc, init, weight, group, block, dev):
    N, W = desc.shape[0], init.shape[0]
    check_capacity(W, dev)
    kernels.check(desc, "desc", torch.uint8, (N, 32), dev)
    kernels.check(init, "init", torch.uint8, (W, 32), dev)
    if weight is not None:
        kernels.check(weight, "weight", torch.int32, (N,), dev)
    if group is not None:
        kernels.check(group, "group", torch.int32, (N,), dev)
        if block <= 0 or W % block:
            raise ValueError(f"kmajority: block {block} does not divide {W} centres")


def km_scratch_ints(N: int, W: int, G: int = 0) -> int:
    """Ints of K14's scratch for N descriptors, W centres and G blocks (0:
    flat), as `km_scratch` in csrc/kmajority.cu lays it out: the partial
    sums of the centres of several tally items (257 ints a slot, N / 16 + 1
    slots), the tally items (4 ints each, N / 32 + W + 1 of them),
    per-centre and per-descriptor words, the scan's segment totals (3 ints
    for each of at most 4096 CTAs), and level 2's grouping."""
    n = (N // 16 + 1) * 257 + (N // 32 + W + 1) * 4 + 5 * W + 4 * N + 2 + 3 * 4096
    if G:
        n += G + 2 * (G + 1) + 2 * N + (N // 16 + G + 1)
    return n


def _km_train(desc, words, counts, n_iters, weight=None, group=None, block=0, assign_out=None):
    """One `km_train` launch (K14): n_iters iterations on `words` in place,
    the last counts into `counts`, the final assignment into `assign_out`."""
    dev, N, W = desc.device, desc.shape[0], words.shape[0]
    G = W // block if group is not None else 0
    scratch = torch.empty(km_scratch_ints(N, W, G), dtype=torch.int32, device=dev)
    stamps = kernels.workspace("kmajority", dev, kernels.stream(), kernels.STAMPED_WORDS)
    p = kernels.ptr
    opt = lambda t: None if t is None else p(t)  # noqa: E731
    kernels.launch("kmajority", "km_train", p(desc), opt(weight), opt(group), N, W,
                   block if group is not None else 0, n_iters, p(words), opt(counts),
                   opt(assign_out), p(scratch), scratch.numel(), p(stamps))


def kmajority(desc: torch.Tensor, init: torch.Tensor, n_iters: int,
              weight: Optional[torch.Tensor] = None, group: Optional[torch.Tensor] = None,
              block: int = 0):
    """Binary k-majority from the centres `init` [W, 32] (K14 on CUDA tensors,
    `kmajority_plain` on CPU tensors): (centres, last iteration's counts).
    On the card one launch a call (`km_train`, cooperative; W <= 65536);
    `group` [N] must hold block ids in [0, W / block)."""
    if not _on_cuda(desc):
        return kmajority_plain(desc, init, n_iters, weight, group, block)
    _check_train(desc, init, weight, group, block, desc.device)
    return _kmajority_cuda(desc, init, n_iters, weight, group, block)


def _kmajority_cuda(desc, init, n_iters, weight=None, group=None, block=0):
    words = init.clone()
    counts = (torch.empty if n_iters > 0 else torch.zeros)(init.shape[0], dtype=torch.int32,
                                                           device=desc.device)
    _km_train(desc, words, counts, n_iters, weight, group, block)
    return words, counts


def idf_of(counts: torch.Tensor) -> torch.Tensor:
    """The idf of a training's last counts (K14's `km_idf` on the card)."""
    if not _on_cuda(counts):
        return idf_plain(counts)
    W = counts.shape[0]
    kernels.check(counts, "counts", torch.int32, (W,), counts.device)
    idf = torch.empty(W, dtype=torch.float32, device=counts.device)
    kernels.launch("kmajority", "km_idf", kernels.ptr(counts), W, kernels.ptr(idf))
    return idf


def assign_flat(desc: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Nearest centre of every descriptor during training (K14's assignment
    on the card, one `km_train` launch with no iteration, counted as
    "kmajority")."""
    if not _on_cuda(desc):
        return assign_flat_plain(desc, words)
    dev, N, W = desc.device, desc.shape[0], words.shape[0]
    kernels.check(desc, "desc", torch.uint8, (N, 32), dev)
    kernels.check(words, "words", torch.uint8, (W, 32), dev)
    return _assign_flat_cuda(desc, words)


def _assign_flat_cuda(desc, words):
    out = torch.empty(desc.shape[0], dtype=torch.int32, device=desc.device)
    _km_train(desc, words, None, 0, assign_out=out)
    return out


def _draw(n: int, k: int, seed: int, device, init_idx) -> torch.Tensor:
    """k initial rows of n: `init_idx` when given, else the generator's draw
    (without replacement when n >= k)."""
    if isinstance(init_idx, torch.Tensor):
        return init_idx.to(device=device, dtype=torch.int64)
    if init_idx is not None:
        return torch.as_tensor(np.asarray(init_idx), dtype=torch.int64).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if n >= k:
        return torch.randperm(n, generator=gen, device=device)[:k]
    return torch.randint(0, n, (k,), generator=gen, device=device)


def _trainer(desc: torch.Tensor, chunk: int = TRAIN_CHUNK):
    """(k-majority, idf, flat assignment): K14 for a CUDA corpus, else the
    plain versions walking `chunk` rows at a time."""
    if not _on_cuda(desc):
        return (partial(kmajority_plain, chunk=chunk), idf_plain,
                partial(assign_flat_plain, chunk=chunk))
    return kmajority, idf_of, assign_flat


def train(descriptors: torch.Tensor, n_words: int = 4096, n_iters: int = 10, seed: int = 0,
          init_idx=None, chunk: int = TRAIN_CHUNK) -> Vocabulary:
    """A flat W-word vocabulary from packed descriptors [N, 32] u8, on their
    device (TemplatedVocabulary::create). The plain version walks `chunk`
    rows at a time; the card makes one pass over the corpus."""
    check_capacity(n_words, descriptors.device)
    desc = descriptors.contiguous()
    km, idf_fn, _ = _trainer(desc, chunk)
    idx = _draw(desc.shape[0], n_words, seed, desc.device, init_idx)
    words, counts = km(desc, desc[idx].contiguous(), n_iters)
    return Vocabulary(words, idf_fn(counts))


def train_chunked(descriptors: torch.Tensor, n_words: int = 32768, n_iters: int = 8,
                  seed: int = 0, chunk: int = 65536, init_idx=None) -> Vocabulary:
    """The reference's `train` blocked over N (padding rows weigh 0 there
    and are absent here): the same fixed point, `train` at this chunk."""
    return train(descriptors, n_words, n_iters, seed, init_idx, chunk)


def level2_init(desc: torch.Tensor, groups: torch.Tensor, grp: np.ndarray, B: int,
                seed: int) -> torch.Tensor:
    """[G B, 32] initial words of level 2: per group g, B of its members drawn
    by `np.random.default_rng(seed + 7)` as the reference draws them (with
    replacement when it has fewer than B), or its centre B times when it has
    none."""
    G = groups.shape[0]
    rng = np.random.default_rng(seed + 7)
    order = np.argsort(grp, kind="stable")
    bounds = np.searchsorted(grp[order], np.arange(G + 1))
    init = groups.repeat_interleave(B, dim=0).clone()
    for g in range(G):
        members = order[bounds[g]:bounds[g + 1]].astype(np.int64)
        if len(members):
            pick = rng.choice(members, B, replace=len(members) < B)
            init[g * B:(g + 1) * B] = desc[torch.from_numpy(pick).to(desc.device)]
    return init


def train_hierarchical(descriptors: torch.Tensor, n_groups: int = 1024,
                       words_per_group: int = 32, n_iters: int = 8, seed: int = 0,
                       chunk: int = 16384, init_idx=None) -> Vocabulary:
    """A 2-level vocabulary (DBoW2's HKmeansStep at branch factors G x B):
    level 1 trains G group centres over the corpus, level 2 B words inside
    each group's partition, each descriptor's argmin over its own group
    block; child block g is words [g B, (g + 1) B). `init_idx` are level 1's
    initial rows; the one host read is the level-1 grouping."""
    G, B = n_groups, words_per_group
    check_capacity(G * B, descriptors.device)
    desc = descriptors.contiguous()
    km, idf_fn, assign_fn = _trainer(desc, chunk)
    dev = desc.device
    idx = _draw(desc.shape[0], G, seed, dev, init_idx)
    gb, _ = km(desc, desc[idx].contiguous(), n_iters)
    grp = assign_fn(desc, gb)
    init = level2_init(desc, gb, grp.cpu().numpy(), B, seed)
    words, counts = km(desc, init, n_iters, group=grp, block=B)
    child = torch.arange(G * B, dtype=torch.int32, device=dev).reshape(G, B)
    return with_tree_layout(Vocabulary(words, idf_fn(counts), gb, child))


def build_tree(voc: Vocabulary, n_groups: int = 1024, n_iters: int = 8, seed: int = 0,
               dup: int = 4, init_idx=None) -> Vocabulary:
    """A 2-level descent tree over a flat vocabulary: k-majority of the word
    centres into G groups (initial rows drawn with seed + 101), then each
    word stored in the buckets of its `dup` nearest groups, rank by rank,
    capacity max(8, ceil(2 dup W / G)) a bucket (the reference's placement,
    its numpy argsort included)."""
    W = voc.n_words
    G = min(n_groups, W)
    dup = min(dup, G)
    words = voc.words.contiguous()
    km = _trainer(words)[0]
    idx = _draw(W, G, seed + 101, words.device, init_idx)
    gb, _ = km(words, words[idx].contiguous(), n_iters)
    d = torch.cat([D.hamming_matrix(words[s:s + 4096], gb) for s in range(0, W, 4096)])
    order = np.argsort(d.cpu().numpy(), axis=1)
    cmax = max(8, int(np.ceil(2 * dup * W / G)))
    buckets: list = [[] for _ in range(G)]
    placed = [set() for _ in range(W)]
    for r in range(dup):
        for wi in range(W):
            for gi in order[wi, r:]:
                if gi in placed[wi]:
                    continue
                if len(buckets[gi]) < cmax:
                    buckets[gi].append(wi)
                    placed[wi].add(gi)
                    break
    child = np.full((G, cmax), -1, np.int32)
    for gi, b in enumerate(buckets):
        child[gi, : len(b)] = b
    return with_tree_layout(voc._replace(groups=gb,
                                         child_idx=torch.from_numpy(child).to(words.device)))
