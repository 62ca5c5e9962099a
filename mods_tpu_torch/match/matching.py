"""Descriptor matching: exact kNN + FGINN ratio test + duplicate filter.

Counterpart of the JAX package's match/matching.py (reference
matching.cpp:356-460 MatchFlannFGINN, 574-633 MatchFLANNDistance and
2615-2679 duplicate filtering).  Neighbor lists are exact, with ties in
lower-index-first order as lax.top_k gives them.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..config import MatchPars
from ..types import Features, Tentatives

_BIG = 1e12
_ROWS = 4096        # query rows per distance block: _knn holds _ROWS x M


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

    The order is one topk over an int64 key (d << bits) | column.  With
    int_exact the distances are integers < 2^23 (128 * 255^2), keyed as
    they are, invalid columns as 2^23; otherwise the key holds the float32
    bit pattern of d + 0.0 (non-negative, -0.0 made +0.0), which orders as
    the floats do, invalid columns at 1e12's.  A topk keeps the block's
    memory at the distances and their keys, where a full-row sort of the
    distances needs tens of GB at 65,536 columns."""
    N, M = desc1.shape[0], desc2.shape[0]
    bits = max(1, (M - 1).bit_length())
    cols = torch.arange(M, device=desc1.device)[None, :]
    dists, idx = [], []
    for s in range(0, N, _ROWS):
        d = distance_matrix_sq(desc1[s:s + _ROWS], desc2)
        if int_exact:
            key = torch.where(valid2[None, :], d.to(torch.int64), 1 << 23)
        else:
            d.add_(0.0).masked_fill_(~valid2[None, :], _BIG)
            key = d.view(torch.int32).to(torch.int64)
        del d
        key.bitwise_left_shift_(bits).bitwise_or_(cols)
        kk = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        dk = kk >> bits
        if int_exact:
            dists.append(torch.where(dk >= (1 << 23), _BIG, dk.to(torch.float32)))
        else:
            dists.append(dk.to(torch.int32).view(torch.float32))
        idx.append(kk & ((1 << bits) - 1))
    return torch.cat(dists), torch.cat(idx)


def knn_streaming(desc1, desc2, valid2, k: int, block: int = 8192,
                  int_exact: bool = False):
    """Exact kNN over column blocks of `block` database rows, merged into a
    running top-k: the counterpart of the JAX package's knn_streaming.
    match_fginn does not take it (`_knn` is bounded by its row blocks and
    is the faster route on the card: tools/knn_routes.py).  The same neighbours
    in the same order as `_knn` (ascending distance, equal distances lower
    index first; invalid columns at 1e12, lowest index first): with
    int_exact every candidate carries the int64 key (d << bits) | column,
    otherwise the running list (lower columns) precedes the block's in a
    stable sort.  Returns (dists [N, k], idx [N, k])."""
    N, M = desc1.shape[0], desc2.shape[0]
    bits = max(1, (M - 1).bit_length())
    best = best_d = None
    for off in range(0, M, block):
        d = distance_matrix_sq(desc1, desc2[off:off + block])
        v = valid2[off:off + block]
        cols = torch.arange(off, off + d.shape[1], device=d.device)
        kk = min(k, d.shape[1])
        if int_exact:
            key = torch.where(v[None, :], d.to(torch.int64), 1 << 23)
            key = (key << bits) | cols[None, :]
            cand = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
            if best is not None:
                cand = torch.cat([best, cand], 1)
                cand = torch.topk(cand, min(k, cand.shape[1]), dim=1,
                                  largest=False, sorted=True).values
            best = cand
        else:
            d = torch.where(v[None, :], d, _BIG)
            ds, ix = torch.sort(d, dim=1, stable=True)
            cd, ci = ds[:, :kk], cols[ix[:, :kk]]
            if best is not None:
                cd, ci = torch.cat([best_d, cd], 1), torch.cat([best, ci], 1)
                cd, o = torch.sort(cd, dim=1, stable=True)
                cd, ci = cd[:, :k], torch.gather(ci, 1, o[:, :k])
            best_d, best = cd, ci
        del d
    if not int_exact:
        return best_d, best
    dk = best >> bits
    return (torch.where(dk >= (1 << 23), _BIG, dk.to(torch.float32)),
            best & ((1 << bits) - 1))


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


def _tentatives(f1: Features, f2: Features, accept, i0, d1, d2,
                ratio=None) -> Tentatives:
    r = f2.reproj
    q = f1.reproj
    if ratio is None:
        ratio = torch.sqrt(torch.clamp(d1, min=0.0) / torch.clamp(d2, min=1e-30))
    return Tentatives(xy1=q.xy, xy2=r.xy[i0], A1=q.A, A2=r.A[i0], s1=q.s,
                      s2=r.s[i0], d1=d1, d2=d2, ratio=ratio, valid=accept)


def match_fginn(f1: Features, f2: Features, par: MatchPars,
                ratio_th: float, int_exact: bool = False) -> Tentatives:
    """Tentative correspondences list1 -> list2 (queries are image 1)."""
    return _tentatives(f1, f2, *_fginn_core(
        f1.desc, f1.valid, f2.desc, f2.valid, f2.reproj.xy, ratio_th,
        par.contradDist, par.knn, int_exact))


def match_distance_threshold(f1: Features, f2: Features, par: MatchPars,
                             max_dist: float) -> Tentatives:
    """Absolute-distance matcher (reference MatchFLANNDistance,
    matching.cpp:574-633): the nearest neighbour (lowest index among equal
    distances) is accepted when its squared L2 distance is at most
    max_dist^2."""
    d0, i0 = [], []
    for s in range(0, f1.n, _ROWS):
        d = distance_matrix_sq(f1.desc[s:s + _ROWS], f2.desc)
        d = torch.where(f2.valid[None, :], d, _BIG)
        d0.append(d.amin(dim=1))
        i0.append(torch.argmin(d, dim=1))
    d0, i0 = torch.cat(d0), torch.cat(i0)
    accept = f1.valid & (d0 <= max_dist * max_dist) & (f2.valid.sum() > 0)
    return _tentatives(f1, f2, accept, i0, d0, d0, ratio=torch.ones_like(d0))


def concat_tentatives(parts: Sequence[Tentatives]) -> Tentatives:
    return Tentatives(*[torch.cat([getattr(p, f) for p in parts])
                        for f in ("xy1", "xy2", "A1", "A2", "s1", "s2", "d1",
                                  "d2", "ratio", "valid")])


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
