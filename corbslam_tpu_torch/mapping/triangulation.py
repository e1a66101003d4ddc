"""New landmarks by inter-keyframe triangulation (port of
`corbslam_tpu/mapping/triangulation.py`: `triangulate_midpoint`,
`create_new_points`), mono's only source of landmarks
(LocalMapping::CreateNewMapPoints, LocalMapping.cc:190).

For each of the keyframe's top 8 covisible neighbours (weight >= 15) and
each of its unbound features: the best unbound feature of the neighbour in
the epipolar band, away from the epipole (Hamming <= th_low, mutual), the
midpoint of the two rays, and the reference's gates (cheirality in both
views, parallax cos < 0.9998, reprojection chi2 5.991 sigma^2 in both views,
the scale-consistency band, baseline / median depth > 0.01). Each feature
then takes the neighbour with the least summed reprojection error (the first
on ties; none when every neighbour failed) and the new points are allocated
and bound on both sides. A padded neighbour row runs the same program and
is masked out, as in the reference.

The per-neighbour set-up (poses, F12, epipole, the baseline test) and the
map writes are PyTorch. On a CUDA map the search is kernel K5 in its band
mode (`matcher.band_search`, one launch for all neighbours) and the
triangulation, gates and the choice of neighbour are kernel K13
(`csrc/triangulate.cu`); on a CPU map `candidates_plain` runs the plain
versions of both. They evaluate the gates with the same f32 operations in
the same order. The map is written in place.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from .. import kernels
from ..config import OrbConfig, SlamConfig
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapstate import covisibility as covis
from ..mapstate import mapstate as ms
from ..matching import matcher

N_NEIGHBORS = 8
MIN_COVIS_WEIGHT = 15  # GetBestCovisibilityKeyFrames' threshold


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def triangulate_midpoint(o1, d1, o2, d2):
    """Midpoint of the closest segment between the rays o + s d (d need not
    be unit): (X [..., 3], s1, s2)."""
    r = o2 - o1
    a, b, c = _dot3(d1, d1), _dot3(d1, d2), _dot3(d2, d2)
    e, f = _dot3(d1, r), _dot3(d2, r)
    den = a * c - b * b
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    s1 = (c * e - b * f) / den
    s2 = (b * e - a * f) / den
    return 0.5 * ((o1 + s1[..., None] * d1) + (o2 + s2[..., None] * d2)), s1, s2


@lru_cache(maxsize=16)
def _scales(cfg: OrbConfig, device: str) -> torch.Tensor:
    return torch.tensor(cfg.scales(), dtype=torch.float32, device=device)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian of a 1-D tensor: the two middle finite values averaged
    (torch.nanmedian takes the lower one), NaN when there is none; no host
    sync."""
    n = (~torch.isnan(x)).sum()
    s = torch.sort(x).values  # NaN sorts last
    lo, hi = s[((n - 1) // 2).clamp_min(0)], s[(n // 2).clamp_max(x.shape[0] - 1)]
    return torch.where(n > 0, 0.5 * lo + 0.5 * hi, torch.full_like(lo, float("nan")))


def _rays_world(cam, R, xy):
    """R^T backproject(xy, 1): unit-depth rays of pixels xy [..., 2] in the
    world frame, R [..., 3, 3] broadcast against them."""
    x = matcher.div(xy[..., 0] - cam.cx, cam.fx)
    y = matcher.div(xy[..., 1] - cam.cy, cam.fy)
    return torch.stack([R[..., 0, i] * x + R[..., 1, i] * y + R[..., 2, i] for i in range(3)], -1)


def _transform(R, t, X):
    return torch.stack([R[..., i, 0] * X[..., 0] + R[..., i, 1] * X[..., 1]
                        + R[..., i, 2] * X[..., 2] + t[..., i] for i in range(3)], -1)


class Setup(NamedTuple):
    """The new keyframe (row q) and its K neighbour rows."""

    q: int
    nb_rows: torch.Tensor   # [K] i32
    nb_use: torch.Tensor    # [K] bool: a covisible neighbour with a significant baseline
    R1: torch.Tensor        # [3, 3]
    t1: torch.Tensor        # [3]
    o1: torch.Tensor        # [3] camera centre
    R2: torch.Tensor        # [K, 3, 3]
    t2: torch.Tensor        # [K, 3]
    o2: torch.Tensor        # [K, 3]
    F12: torch.Tensor       # [K, 3, 3]
    epipole: torch.Tensor   # [K, 2] cam1's centre in each neighbour's image
    unbound1: torch.Tensor  # [F]


def setup(cam, m: ms.MapState, q: int, cfg: SlamConfig, n_neighbors: int = N_NEIGHBORS) -> Setup:
    nb_rows, nb_ok = covis.top_covisible_of(m, q, n_neighbors, min_weight=MIN_COVIS_WEIGHT)
    T1 = m.kf.Tcw[q]
    R1, t1 = se3.rotation(T1), se3.translation(T1)
    o1 = -(R1.T @ t1)
    # Median scene depth of the keyframe (LocalMapping.cc:236, the baseline test).
    z = se3.transform(T1, m.mp.pos)[:, 2]
    med = nanmedian(torch.where(covis.point_mask_of_kf(m, q), z, torch.full_like(z, float("nan"))))
    med = torch.where(torch.isfinite(med), med, torch.ones_like(med))
    T2 = m.kf.Tcw[nb_rows.long()]
    R2, t2 = se3.rotation(T2), se3.translation(T2)
    o2 = (-torch.einsum("kji,kj->ki", R2, t2)).contiguous()
    base_ok = cam_mod.norm3(o2 - o1) / med.clamp_min(1e-6) > 0.01
    F12 = matcher.fundamental_from_poses(cam, T1, cam, T2)
    e2 = cam_mod.project(cam, se3.transform(T2, o1))
    unbound1 = m.kf.fvalid[q] & (m.kf.mp_idx[q] < 0)
    return Setup(q, nb_rows, nb_ok & base_ok, R1, t1, o1, R2, t2, o2, F12.contiguous(),
                 e2.contiguous(), unbound1)


class Candidates(NamedTuple):
    """Per new-keyframe feature: the chosen neighbour slot and its point."""

    create: torch.Tensor  # [F] bool
    k: torch.Tensor       # [F] i32 neighbour slot (0 when none)
    f2: torch.Tensor      # [F] i32 matched feature of that neighbour
    X: torch.Tensor       # [F, 3] world point
    dist1: torch.Tensor   # [F] distance from the keyframe's centre


class Neighbours(NamedTuple):
    """The K neighbours' features, gathered by row: [K, F, ...]."""

    desc: torch.Tensor
    unbound: torch.Tensor
    xy: torch.Tensor
    octave: torch.Tensor


def neighbours(m: ms.MapState, st: Setup) -> Neighbours:
    nb = st.nb_rows.long()
    return Neighbours(m.kf.desc[nb], m.kf.fvalid[nb] & (m.kf.mp_idx[nb] < 0), m.kf.xy[nb],
                      m.kf.octave[nb])


def search(m: ms.MapState, st: Setup, nbf: Neighbours, cfg: SlamConfig,
           plain: bool = False) -> matcher.MatchResult:
    """search_for_triangulation of the keyframe's unbound features in each
    neighbour (fields [K, F]): K5's band mode, one launch for all neighbours,
    on a CUDA map (`plain`: its plain version on any device). A neighbour
    that is padding or fails the baseline test searches no feature."""
    fn = matcher.band_search_plain if plain else matcher.band_search
    q = st.q
    return fn(m.kf.desc[q], st.unbound1[None] & st.nb_use[:, None], m.kf.xy[q], nbf.desc,
              nbf.unbound, nbf.xy, nbf.octave, st.F12, st.epipole,
              _scales(cfg.orb, str(m.kf.xy.device)), cfg.matcher.th_low, 1.0, True)


def points_plain(cam, m: ms.MapState, st: Setup, nbf: Neighbours, match: torch.Tensor,
                 cfg: SlamConfig) -> Candidates:
    """Plain version of K13: from the accepted matches `match` [K, F] (-1:
    none), the rays, midpoints and gates over [K, F] and the per-feature
    argmin."""
    q, F, K = st.q, m.kf.n_features, st.nb_rows.shape[0]
    scales = _scales(cfg.orb, str(m.kf.xy.device))
    sigma2 = scales * scales
    has = match >= 0
    f2 = match.clamp_min(0).long()
    xy1, oct1 = m.kf.xy[q], m.kf.octave[q].long()
    xy2 = torch.gather(nbf.xy, 1, f2[..., None].expand(K, F, 2))
    oct2 = torch.gather(nbf.octave, 1, f2).long()
    d1w = _rays_world(cam, st.R1, xy1).expand(K, F, 3)
    d2w = _rays_world(cam, st.R2[:, None], xy2)
    o1, o2 = st.o1.expand(K, F, 3), st.o2[:, None, :].expand(K, F, 3)
    X, _, _ = triangulate_midpoint(o1, d1w, o2, d2w)
    p1c = _transform(st.R1, st.t1, X)
    p2c = _transform(st.R2[:, None], st.t2[:, None], X)
    cheir = (p1c[..., 2] > 0) & (p2c[..., 2] > 0)
    cospar = _dot3(d1w, d2w) / (cam_mod.norm3(d1w) * cam_mod.norm3(d2w)).clamp_min(1e-9)
    e1v = cam_mod.project(cam, p1c) - xy1
    e2v = cam_mod.project(cam, p2c) - xy2
    e1 = e1v[..., 0] * e1v[..., 0] + e1v[..., 1] * e1v[..., 1]
    e2 = e2v[..., 0] * e2v[..., 0] + e2v[..., 1] * e2v[..., 1]
    chi_ok = (e1 < 5.991 * sigma2[oct1]) & (e2 < 5.991 * sigma2[oct2])
    dist1, dist2 = cam_mod.norm3(X - o1), cam_mod.norm3(X - o2)
    ratio_d = dist1 / dist2.clamp_min(1e-9)
    ratio_o = scales[oct2] / scales[oct1]
    sf = cfg.orb.scale_factor
    sc_ok = (ratio_d < ratio_o * 1.5 * sf) & (ratio_d * 1.5 * sf > ratio_o)
    ok = has & cheir & (cospar < 0.9998) & chi_ok & sc_ok
    err = torch.where(ok, e1 + e2, torch.full_like(e1, float("inf")))
    best = torch.argmin(err, dim=0)                          # the first minimum
    fi = torch.arange(F, device=best.device)
    return Candidates(torch.isfinite(err[best, fi]), best.to(torch.int32),
                      f2[best, fi].to(torch.int32), X[best, fi], dist1[best, fi])


def _points_cuda(cam, m: ms.MapState, st: Setup, nbf: Neighbours, match: torch.Tensor,
                 cfg: SlamConfig) -> Candidates:
    F, K, N = m.kf.n_features, st.nb_rows.shape[0], m.kf.capacity
    dev = m.kf.xy.device
    chk = kernels.check
    for name, t, dt, shape in (("match", match, torch.int32, (K, F)),
                               ("kf.xy", m.kf.xy, torch.float32, (N, F, 2)),
                               ("kf.octave", m.kf.octave, torch.int32, (N, F)),
                               ("kf.Tcw", m.kf.Tcw, torch.float32, (N, 4, 4)),
                               ("neighbour xy", nbf.xy, torch.float32, (K, F, 2)),
                               ("neighbour octave", nbf.octave, torch.int32, (K, F)),
                               ("nb_rows", st.nb_rows, torch.int32, (K,)),
                               ("o1", st.o1, torch.float32, (3,)),
                               ("o2", st.o2, torch.float32, (K, 3))):
        chk(t, name, dt, shape, dev)
    if not 0 <= st.q < N:
        raise ValueError(f"triangulate: keyframe row {st.q} outside 0..{N - 1}")
    # One buffer of F x 25 bytes: X [F, 3] and dist1 [F] f32, k and f2 [F]
    # i32, create [F] bool (the kernel reads the keyframe's row q of the map
    # itself, and each neighbour's pose by its row).
    out = torch.empty(F * 25, dtype=torch.uint8, device=dev)
    p = kernels.ptr
    kernels.launch("triangulate", "tri_points", p(m.kf.xy), p(m.kf.octave), p(nbf.xy),
                   p(nbf.octave), F, K, p(match), p(m.kf.Tcw), p(st.nb_rows), int(st.q),
                   p(st.o1), p(st.o2), p(_scales(cfg.orb, str(dev))), float(cam.fx),
                   float(cam.fy), float(cam.cx), float(cam.cy), float(cfg.orb.scale_factor),
                   p(out))
    X, dist1, k, f2, create = out.split_with_sizes((12 * F, 4 * F, 4 * F, 4 * F, F))
    return Candidates(create.view(torch.bool), k.view(torch.int32), f2.view(torch.int32),
                      X.view(torch.float32).view(F, 3), dist1.view(torch.float32))


def points(cam, m: ms.MapState, st: Setup, nbf: Neighbours, match: torch.Tensor,
           cfg: SlamConfig) -> Candidates:
    """Triangulation, gates and the neighbour choice of the matches `match`
    [K, F]: K13 on CUDA tensors, the plain version on CPU tensors."""
    if match.is_cuda:
        return _points_cuda(cam, m, st, nbf, match, cfg)
    if match.device.type == "cpu":
        return points_plain(cam, m, st, nbf, match, cfg)
    raise ValueError(f"unsupported device {match.device}")


def candidates_plain(cam, m: ms.MapState, st: Setup, cfg: SlamConfig) -> Candidates:
    """The plain versions of the search and of K13 on any device."""
    nbf = neighbours(m, st)
    return points_plain(cam, m, st, nbf, search(m, st, nbf, cfg, plain=True).idx, cfg)


def candidates(cam, m: ms.MapState, st: Setup, cfg: SlamConfig) -> Candidates:
    """Search, triangulation, gates and the neighbour choice: K5's band mode
    and K13 on a CUDA map, the plain versions on a CPU map."""
    nbf = neighbours(m, st)
    return points(cam, m, st, nbf, search(m, st, nbf, cfg).idx, cfg)


def write_points(m: ms.MapState, st: Setup, c: Candidates, cfg: SlamConfig) -> ms.MapState:
    """Allocate the created points (MapPoint ctor: scale band and normal from
    the keyframe) and bind them on both keyframes (AddObservation,
    LocalMapping.cc:362-365), in place."""
    q = st.q
    F = m.kf.n_features
    dev = c.X.device
    scales = _scales(cfg.orb, str(dev))
    max_dist = c.dist1 * scales[m.kf.octave[q].long()]
    min_dist = matcher.div(max_dist, cfg.orb.scale_factor ** (cfg.orb.n_levels - 1))
    normal = c.X - st.o1
    normal = normal / cam_mod.norm3(normal).clamp_min(1e-9)[:, None]
    m, rows = ms.add_map_points(m, c.X, m.kf.desc[q], normal, min_dist, max_dist, ref_kf=q,
                                create=c.create, client=m.kf.client[q])
    m.kf.mp_idx[q] = torch.where(c.create, rows, m.kf.mp_idx[q])
    # Neighbour side: where two features bind one neighbour slot, the larger
    # row wins (the reference's .at[].max); a bound slot keeps its point.
    nb_of_f = st.nb_rows[c.k.long()]
    flat = (torch.where(c.create, nb_of_f, torch.full_like(nb_of_f, q)).long() * F
            + torch.where(c.create, c.f2, torch.zeros_like(c.f2)).long())
    table = m.kf.mp_idx.view(-1)
    cur = table[flat]
    table.scatter_reduce_(0, flat, torch.where(c.create & (cur < 0), rows, cur), "amax")
    return m


def create_new_points(cam, m: ms.MapState, kf_row: int, cfg: SlamConfig,
                      n_neighbors: int = N_NEIGHBORS) -> ms.MapState:
    """Triangulate new landmarks between keyframe row `kf_row` and its top
    covisible neighbours; updates the map in place and returns it."""
    st = setup(cam, m, int(kf_row), cfg, n_neighbors)
    return write_points(m, st, candidates(cam, m, st, cfg), cfg)
