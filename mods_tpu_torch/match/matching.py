"""Descriptor matching: exact kNN + FGINN ratio test + duplicate filter.

Counterpart of the JAX package's match/matching.py (reference
matching.cpp:356-460 MatchFlannFGINN and 2615-2679 duplicate filtering).
Neighbor lists are exact, with ties in lower-index-first order as
lax.top_k and the CPU approx_min_k give them.
"""
from __future__ import annotations

import torch

from ..config import MatchPars
from ..types import Features, Tentatives

_BIG = 1e12
_ROWS = 4096        # query rows per distance block


def distance_matrix_sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N,D]x[M,D] -> [N,M] squared L2 as |a|^2+|b|^2-2ab, float32 with
    TF32 off.  For integer-valued descriptors (SIFT family, entries
    0..255) every product and partial sum is an integer below 2^24, so the
    distances are exact."""
    aa = (a * a).sum(dim=1, keepdim=True)
    bb = (b * b).sum(dim=1, keepdim=True)
    return torch.clamp(aa + bb.T - 2.0 * (a @ b.T), min=0.0)


def _knn(desc1, desc2, valid2, k: int, int_exact: bool):
    """Exact k nearest neighbors of each query row, ascending distance,
    equal distances lower index first; invalid columns have distance 1e12.

    int_exact: the distances are integers < 2^23 (128 * 255^2), so the
    order is one topk over the int64 key (d << bits) | column, with
    invalid columns keyed as 2^23; otherwise a stable sort."""
    N, M = desc1.shape[0], desc2.shape[0]
    bits = max(1, (M - 1).bit_length())
    dists, idx = [], []
    for s in range(0, N, _ROWS):
        d = distance_matrix_sq(desc1[s:s + _ROWS], desc2)
        if int_exact:
            key = torch.where(valid2[None, :], d.to(torch.int64), 1 << 23)
            key = (key << bits) | torch.arange(M, device=d.device)[None, :]
            kk = torch.topk(key, k, dim=1, largest=False, sorted=True).values
            dk = kk >> bits
            dists.append(torch.where(dk >= (1 << 23), _BIG, dk.to(torch.float32)))
            idx.append(kk & ((1 << bits) - 1))
        else:
            d = torch.where(valid2[None, :], d, _BIG)
            ds, ix = torch.sort(d, dim=1, stable=True)
            dists.append(ds[:, :k])
            idx.append(ix[:, :k])
    return torch.cat(dists), torch.cat(idx)


def _fginn_from_knn(dists, idx, valid1, valid2, xy2r, ratio_th, contrad_dist):
    """FGINN accept/break walk over per-query neighbor lists
    (matching.cpp:434-456 semantics)."""
    k = dists.shape[1]
    d0 = dists[:, 0]
    i0 = idx[:, 0]
    p0 = xy2r[i0]                               # [N1, 2]
    pj = xy2r[idx]                              # [N1, k, 2]
    spat = ((pj - p0[:, None, :]) ** 2).sum(dim=-1)
    contra = spat > contrad_dist * contrad_dist
    ratio_ok = d0[:, None] / dists <= ratio_th * ratio_th
    jj = torch.arange(k, device=dists.device)
    valid_j = (jj >= 1)[None, :]
    contra_j = contra & valid_j
    jc = torch.where(contra_j, jj[None, :], k).amin(dim=1)
    eligible = valid_j & (jj[None, :] <= jc[:, None]) & ratio_ok
    jacc = torch.where(eligible, jj[None, :], k).amin(dim=1)
    accept = (jacc < k) & valid1 & (valid2.sum() > 0)
    jacc_c = torch.clamp(jacc, 0, k - 1)
    d2 = torch.gather(dists, 1, jacc_c[:, None])[:, 0]
    return accept, i0, d0, d2


def _fginn_core(desc1, valid1, desc2, valid2, xy2r, ratio_th, contrad_dist,
                nn: int, int_exact: bool = False):
    """Per-query (accept, idx0, d1, d2) under FGINN semantics."""
    k = min(nn, desc2.shape[0])
    dists, idx = _knn(desc1, desc2, valid2, k, int_exact)
    f32 = dict(dtype=torch.float32, device=dists.device)
    return _fginn_from_knn(dists, idx, valid1, valid2, xy2r,
                           torch.tensor(ratio_th, **f32),
                           torch.tensor(contrad_dist, **f32))


def match_fginn(f1: Features, f2: Features, par: MatchPars,
                ratio_th: float, int_exact: bool = False) -> Tentatives:
    """Tentative correspondences list1 -> list2 (queries are image 1)."""
    accept, i0, d1, d2 = _fginn_core(
        f1.desc, f1.valid, f2.desc, f2.valid, f2.reproj.xy, ratio_th,
        par.contradDist, par.knn, int_exact)
    r = f2.reproj
    q = f1.reproj
    return Tentatives(
        xy1=q.xy, xy2=r.xy[i0], A1=q.A, A2=r.A[i0], s1=q.s, s2=r.s[i0],
        d1=d1, d2=d2,
        ratio=torch.sqrt(torch.clamp(d1, min=0.0) / torch.clamp(d2, min=1e-30)),
        valid=accept)


def duplicate_filter(t: Tentatives, r: float, mode: str = "bestFGINN",
                     cap: int = None) -> Tentatives:
    """Greedy near-duplicate suppression (matching.cpp:2615-2679): sort by
    quality (stable); an earlier correspondence suppresses later ones
    whose BOTH endpoints lie within r pixels.  `cap` truncates to the
    best `cap` rows after the sort."""
    m = t.m
    if mode == "bestFGINN":
        key = t.ratio
    elif mode == "bestDistance":
        key = t.d1
    elif mode == "biggerRegion":
        key = -t.s1
    else:
        key = torch.arange(m, dtype=torch.float32, device=t.xy1.device)
    key = torch.where(t.valid, key, float("inf"))
    order = torch.sort(key, stable=True).indices
    if cap is not None and cap < m:
        order = order[:cap]
        m = cap
    ts = t.map(lambda x: x[order])
    d1 = ((ts.xy1[:, None, :] - ts.xy1[None, :, :]) ** 2).sum(-1)
    d2 = ((ts.xy2[:, None, :] - ts.xy2[None, :, :]) ** 2).sum(-1)
    ar = torch.arange(m, device=d1.device)
    close_lt = (d1 <= r * r) & (d2 <= r * r) & (ar[:, None] < ar[None, :])
    # keep[i] iff no kept earlier j is close to i: a Jacobi fixpoint that
    # equals the sequential greedy scan
    keep = ts.valid
    while True:
        suppressed = (close_lt & keep[:, None]).any(dim=0)
        new = ts.valid & ~suppressed
        if bool((new == keep).all()):
            break
        keep = new
    return Tentatives(ts.xy1, ts.xy2, ts.A1, ts.A2, ts.s1, ts.s2,
                      ts.d1, ts.d2, ts.ratio, keep)
