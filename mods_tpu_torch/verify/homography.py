"""Batched LO-RANSAC homography verification.

Counterpart of the JAX package's verify/homography.py (reference
degensac/exp_ranH.c and matching.cpp:637-806): one batch of 4-point
hypotheses scored together, LSQ-before-LO, a batch of random inlier
subsets each refined by the shrinking-threshold iterative LSQ, a final
LSQ; `loransac_h` adds the adaptive host loop of doubling sweeps and the
H-LAF check.  Every random draw is injectable, so that a test can hand in
the JAX package's uniforms; without them they come from a
torch.Generator.  `ransac_h_2el` samples two affine correspondences a
hypothesis and hands its best model to the same LO core.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..config import RANSACPars
from ..types import MatchResult, Tentatives

K_SIGMA = 3.0       # matching.cpp:171 k_sigma, the LAF check's point radius
TC = 4.0
MWM = 2.0           # C macro (9/4) under integer division
ILSQ_ITERS = 4
MIN_POINTS = 8      # matching.cpp MIN_POINTS gate
MAX_SWEEP = 65536   # largest hypothesis batch of the adaptive loop


# --------------------------------------------------------------------------- #
# geometry primitives
# --------------------------------------------------------------------------- #
def normalize_transform(xy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted Hartley normalization T (3x3): zero-mean, mean dist sqrt(2)."""
    wsum = torch.clamp(w.sum(), min=1e-9)
    mean = (xy * w[:, None]).sum(0) / wsum
    d = torch.sqrt(((xy - mean) ** 2).sum(-1) + 1e-12)
    scale = math.sqrt(2.0) / torch.clamp((d * w).sum() / wsum, min=1e-9)
    z = torch.zeros_like(scale)
    o = torch.ones_like(scale)
    return torch.stack([torch.stack([scale, z, -scale * mean[0]]),
                        torch.stack([z, scale, -scale * mean[1]]),
                        torch.stack([z, z, o])])


def apply_h(H: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Project points through H (perspective divide): H [3,3] against any
    points [..., 2], or H [B,3,3] against points [M,2] -> [B,M,2]."""
    def h(i, j):
        return H[..., i, j, None]
    x = xy[..., 0] * h(0, 0) + xy[..., 1] * h(0, 1) + h(0, 2)
    y = xy[..., 0] * h(1, 0) + xy[..., 1] * h(1, 1) + h(1, 2)
    w = xy[..., 0] * h(2, 0) + xy[..., 1] * h(2, 1) + h(2, 2)
    w = torch.where(w.abs() < 1e-12, 1e-12, w)
    return torch.stack([x / w, y / w], -1)


def dlt_rows(xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """[...,2] pairs -> [..., 2, 9] DLT rows for x2 ~ H x1."""
    x, y = xy1[..., 0], xy1[..., 1]
    u, v = xy2[..., 0], xy2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    return torch.stack([r1, r2], -2)


def h_from_rows(A: torch.Tensor) -> torch.Tensor:
    """Smallest right singular vector of [..., R, 9] -> [..., 3, 3]."""
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    h = V[..., :, 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def sampson_h_sq(H: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson error for x2 ~ H x1; H [..., 3, 3] against points
    [M, 2] gives [..., M]."""
    def h(i, j):
        return H[..., i, j, None]
    x, y = xy1[..., 0], xy1[..., 1]
    u, v = xy2[..., 0], xy2[..., 1]
    w = h(2, 0) * x + h(2, 1) * y + h(2, 2)
    px = h(0, 0) * x + h(0, 1) * y + h(0, 2)
    py = h(1, 0) * x + h(1, 1) * y + h(1, 2)
    r1 = u * w - px
    r2 = v * w - py
    j11 = u * h(2, 0) - h(0, 0)
    j12 = u * h(2, 1) - h(0, 1)
    j21 = v * h(2, 0) - h(1, 0)
    j22 = v * h(2, 1) - h(1, 1)
    a = j11 * j11 + j12 * j12 + w * w
    b = j11 * j21 + j12 * j22
    c = j21 * j21 + j22 * j22 + w * w
    det = a * c - b * b
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    e = (r1 * (c * r1 - b * r2) + r2 * (a * r2 - b * r1)) / det
    return e.abs()


def symm_transfer_sq(H: torch.Tensor, Hi: torch.Tensor, xy1, xy2,
                     reduce: str = "sum") -> torch.Tensor:
    """Symmetric transfer error (Htools.c HDsSym / HDsSymMax)."""
    fwd = ((apply_h(H, xy1) - xy2) ** 2).sum(-1)
    bwd = ((apply_h(Hi, xy2) - xy1) ** 2).sum(-1)
    return torch.maximum(fwd, bwd) if reduce == "max" else fwd + bwd


def naive_h_check(t, H, error: float) -> torch.Tensor:
    """Count of correspondences whose forward and backward transfer
    errors are both <= error px (matching.cpp:1014-1043 NaiveHCheck)."""
    H = torch.as_tensor(H, dtype=torch.float32, device=t.xy1.device)
    Hi = torch.linalg.inv(H)
    d1 = ((apply_h(H, t.xy1) - t.xy2) ** 2).sum(-1)
    d2 = ((apply_h(Hi, t.xy2) - t.xy1) ** 2).sum(-1)
    return (t.valid & (d1 <= error * error) & (d2 <= error * error)).sum()


def h_error_sq(H: torch.Tensor, xy1, xy2, error_type: str) -> torch.Tensor:
    """Sampson error, or the symmetric transfer error ("SymmMax" takes
    the larger direction, any other type the sum)."""
    if error_type == "Sampson":
        return sampson_h_sq(H, xy1, xy2)
    return symm_transfer_sq(H, torch.linalg.inv(H), xy1, xy2,
                            "max" if error_type == "SymmMax" else "sum")


def trunc_quad(d: torch.Tensor, th) -> torch.Tensor:
    """rtools.c truncQuad: 1 - d/(2.25*th) for d < 2.25*th else 0."""
    lim = th * 9.0 / 4.0
    return torch.where(d >= lim, 0.0, 1.0 - d / lim)


def msac_score(d: torch.Tensor, valid: torch.Tensor, th):
    J = torch.where(valid, trunc_quad(d, th), 0.0).sum(-1)
    I = (valid & (d <= th)).sum(-1)
    return I, J


def _oriented_ok(p: torch.Tensor, q: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """Oriented constraint on 4-point samples: homogeneous scale signs
    consistent and triangle orientations preserved."""
    w = p[..., 0] * H[..., 2, 0, None] + p[..., 1] * H[..., 2, 1, None] + H[..., 2, 2, None]
    sign_ok = (w > 0).all(-1) | (w < 0).all(-1)

    def tri_sign(xy, i, j, k):
        a = xy[..., j, :] - xy[..., i, :]
        b = xy[..., k, :] - xy[..., i, :]
        return torch.sign(a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])
    triples = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    rel = (torch.stack([tri_sign(p, *t) for t in triples], -1)
           * torch.stack([tri_sign(q, *t) for t in triples], -1))
    return sign_ok & ((rel >= 0).all(-1) | (rel <= 0).all(-1))


# --------------------------------------------------------------------------- #
# LO-RANSAC
# --------------------------------------------------------------------------- #
def _weighted_lsq_h(xy1n, xy2n, w) -> torch.Tensor:
    """LSQ DLT over weighted correspondences in normalized coords;
    w [..., M] gives H [..., 3, 3]."""
    A = dlt_rows(xy1n, xy2n) * w[..., :, None, None]     # [..., M, 2, 9]
    return h_from_rows(A.reshape(w.shape[:-1] + (-1, 9)))


def _iter_lsq(xy1n, xy2n, valid, H0, th_n, steps: int):
    """exp_iterH: iterative LSQ with the threshold shrinking TC*th -> th,
    over H0 [..., 3, 3]; thresholds in normalized squared units."""
    lead = H0.shape[:-2]
    H, bestH = H0, H0
    bestI = torch.zeros(lead, dtype=torch.int64, device=H0.device)
    bestJ = torch.full(lead, -1.0, device=H0.device)
    for it in range(steps + 1):
        ths = TC * th_n - (TC - 1.0) * th_n * float(it) / steps
        d = sampson_h_sq(H, xy1n, xy2n)
        I, J = msac_score(d, valid, th_n)
        better = J > bestJ
        bestH = torch.where(better[..., None, None], H, bestH)
        bestI = torch.where(better, I, bestI)
        bestJ = torch.where(better, J, bestJ)
        H = _weighted_lsq_h(xy1n, xy2n, (valid & (d <= ths * MWM)).to(torch.float32))
    d = sampson_h_sq(H, xy1n, xy2n)
    I, J = msac_score(d, valid, th_n)
    better = J > bestJ
    return (torch.where(better[..., None, None], H, bestH),
            torch.where(better, I, bestI), torch.where(better, J, bestJ))


def _normalize_pair(xy1, xy2, valid, th):
    """Hartley-normalize both sides once; returns transforms, normalized
    points and the threshold in normalized units."""
    T1 = normalize_transform(xy1, valid.to(torch.float32))
    T2 = normalize_transform(xy2, valid.to(torch.float32))
    xy1n = apply_h(T1, xy1)
    xy2n = apply_h(T2, xy2)
    s2 = T2[0, 0]
    return T1, T2, xy1n, xy2n, th * s2 * s2


def _top_idx(u: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of each row, in descending order,
    equal values lower index first (as lax.approx_max_k on the CPU)."""
    return torch.sort(u, dim=1, descending=True, stable=True).indices[:, :k]


def _sweep_h(xy1n, xy2n, valid, th_n, u: torch.Tensor):
    """One batch of minimal 4-point hypotheses from the uniforms u
    [batch, M], scored; returns the best (H normalized frame, I, J)."""
    batch = u.shape[0]
    u = torch.where(valid[None, :], u, -1.0)
    sidx = _top_idx(u, 4)                       # distinct uniform 4-subsets
    p = xy1n[sidx]                              # [B,4,2]
    q = xy2n[sidx]
    A = dlt_rows(p, q).reshape(batch, 8, 9)
    # pin h33 = 1 and solve the 8x8 systems; singular samples give NaN
    h8, info = torch.linalg.solve_ex(A[:, :, :8], -A[:, :, 8:9])
    h8 = torch.where((info != 0)[:, None], float("nan"), h8[..., 0])
    Hb = torch.cat([h8, torch.ones((batch, 1), device=h8.device)],
                   -1).reshape(batch, 3, 3)
    # h33 ~ 0 fallback: an eigh-nullspace sub-batch
    n_eig = max(batch // 16, 8)
    H_eig = h_from_rows(A[:n_eig])
    head = Hb[:n_eig]
    pin_ok = (torch.isfinite(head).all(dim=(1, 2))
              & (head.abs().amax(dim=(1, 2)) < 1e4))
    Hb = torch.cat([torch.where(pin_ok[:, None, None], head, H_eig),
                    Hb[n_eig:]])
    ok = _oriented_ok(p, q, Hb) & torch.isfinite(Hb).all(dim=(1, 2))
    db = sampson_h_sq(Hb, xy1n, xy2n)           # [B,M]
    Ib, Jb = msac_score(db, valid[None, :], th_n)
    Jb = torch.where(ok, Jb, -1.0)
    best = torch.argmax(Jb)
    return Hb[best], Ib[best], Jb[best]


def _uniform(shape, u, generator, device):
    if u is not None:
        return u.to(device=device, dtype=torch.float32)
    gdev = generator.device if generator is not None else device
    return torch.rand(shape, generator=generator, device=gdev).to(device)


def _drawer(draws, generator, device):
    """u(name, shape): the uniforms draws(name, shape) on `device`, or,
    without `draws`, fresh ones from `generator`."""
    return lambda name, shape: _uniform(
        shape, None if draws is None else draws(name, shape), generator, device)


def _ransac_h_core(xy1, xy2, valid, th, batch: int, lo_batch: int,
                   u_sweep: torch.Tensor = None, u_lo: torch.Tensor = None,
                   generator: torch.Generator = None,
                   H_init: torch.Tensor = None, J_init: torch.Tensor = None):
    """Fixed-budget batched LO-RANSAC-H.  u_sweep [batch, M] and u_lo
    [lo_batch, M] are the uniforms of the hypothesis sweep and of the LO
    subsets (drawn from `generator` when absent).  (H_init, J_init), a
    model in the normalized frame from an adaptive loop, replaces the
    sweep's best when its score is higher.
    Returns (H in pixels normalized by H[2,2], inlier mask, I, J)."""
    M = xy1.shape[0]
    dev = xy1.device
    u_sweep = _uniform((batch, M), u_sweep, generator, dev)
    u_lo = _uniform((lo_batch, M), u_lo, generator, dev)
    th = torch.as_tensor(th, dtype=torch.float32, device=dev)
    T1, T2, xy1n, xy2n, th_n = _normalize_pair(xy1, xy2, valid, th)

    # stage 1: B minimal samples
    H_best, I_best, J_best = _sweep_h(xy1n, xy2n, valid, th_n, u_sweep)
    if H_init is not None:
        better = J_init > J_best
        H_best = torch.where(better, H_init, H_best)
        J_best = torch.where(better, J_init, J_best)

    # stage 2: LSQ-before-LO (exp_ranH.c case 4)
    d_best = sampson_h_sq(H_best, xy1n, xy2n)
    w0 = (valid & (d_best <= TC * th_n * MWM)).to(torch.float32)
    H_lsq = _weighted_lsq_h(xy1n, xy2n, w0)
    H_lsq, I_lsq, J_lsq = _iter_lsq(xy1n, xy2n, valid, H_lsq, th_n, ILSQ_ITERS)

    # stage 3: random inlier subsets (exp_inHrani)
    d_lsq = sampson_h_sq(H_lsq, xy1n, xy2n)
    inl = valid & (d_lsq <= th_n)
    ssiz = torch.clamp(inl.sum() // 2, 4, 12)
    us = torch.where(inl[None, :], u_lo, -1.0)
    k16 = min(16, M)
    rank16 = _top_idx(us, k16)                  # top-16 covers ssiz <= 14
    take16 = (torch.arange(k16, device=dev) < ssiz).to(torch.float32)
    sub_w = torch.zeros((lo_batch, M), device=dev).scatter(
        1, rank16, take16.expand(lo_batch, k16).contiguous())
    sub_w = sub_w * inl.to(torch.float32)
    Hl = _weighted_lsq_h(xy1n, xy2n, sub_w)
    Hl, Il, Jl = _iter_lsq(xy1n, xy2n, valid, Hl, th_n, ILSQ_ITERS)

    # pick the global best
    cand_H = torch.cat([H_best[None], H_lsq[None], Hl], 0)
    cand_J = torch.cat([J_best[None], J_lsq[None], Jl], 0)
    Hg = cand_H[torch.argmax(cand_J)]

    # final LSQ on inliers at th (exp_ranH.c __FINAL_LSQ__)
    d_g = sampson_h_sq(Hg, xy1n, xy2n)
    H_fin = _weighted_lsq_h(xy1n, xy2n, (valid & (d_g <= th_n)).to(torch.float32))
    d_fin = sampson_h_sq(H_fin, xy1n, xy2n)
    I_fin, J_fin = msac_score(d_fin, valid, th_n)
    use_fin = J_fin >= cand_J.max()
    H_out = torch.where(use_fin, H_fin, Hg)
    d_out = torch.where(use_fin, d_fin, d_g)
    inliers = valid & (d_out <= th_n)
    I_out, J_out = msac_score(d_out, valid, th_n)

    # denormalize: x2 = T2^-1 Hn T1 x1
    H_px = torch.linalg.inv(T2) @ H_out @ T1
    h22 = H_px[2, 2]
    H_px = H_px / torch.where(h22.abs() < 1e-12, 1.0, h22)
    return H_px, inliers, I_out, J_out


def nsamples_required(ninl: int, m: int, sample_size: int,
                      conf: float) -> float:
    """rtools.c `nsamples` (used at exp_ranH.c:425): samples needed so that
    with confidence `conf` one is all-inlier at the inlier ratio ninl/m."""
    if m <= 0 or ninl <= 0:
        return float("inf")
    q = (ninl / m) ** sample_size
    if q >= 1.0 - 1e-12:
        return 1.0
    if q < 1e-12:
        return float("inf")
    return math.log(max(1.0 - conf, 1e-12)) / math.log(1.0 - q)


def _sweep_h_px(xy1, xy2, valid, th, u: torch.Tensor):
    """One standalone hypothesis sweep of the adaptive loop on pixel
    coordinates: (H normalized frame, I, J) of the best of u's samples."""
    _, _, xy1n, xy2n, th_n = _normalize_pair(xy1, xy2, valid, th)
    return _sweep_h(xy1n, xy2n, valid, th_n, u)


def _laf_points(xy, A, s) -> torch.Tensor:
    """The LAF checks' 3 points of each region [M, 3, 2]: the centre and
    the tips of its two axes at K_SIGMA * s."""
    k = K_SIGMA * s[:, None]
    return torch.stack([xy, xy + k * torch.stack([A[:, 0, 1], A[:, 1, 1]], -1),
                        xy + k * torch.stack([A[:, 0, 0], A[:, 1, 0]], -1)], 1)


def _laf_check_h(t: Tentatives, H: torch.Tensor, thresh: float) -> torch.Tensor:
    """H_LAF_check (matching.cpp:250-308): 3 LAF points a side, the larger
    transfer direction per point; drops a correspondence when
    sqrt(e0+e1+e2) > thresh.  A singular H keeps none (its inverse is
    NaN, as jnp.linalg.inv's non-finite result keeps none)."""
    Hi, info = torch.linalg.inv_ex(H)
    Hi = torch.where(info != 0, float("nan"), Hi)
    err = symm_transfer_sq(H, Hi, _laf_points(t.xy1, t.A1, t.s1),
                           _laf_points(t.xy2, t.A2, t.s2), reduce="max")   # [M, 3]
    return t.valid & (torch.sqrt(err.sum(-1)) <= thresh)


Draws = Callable[[str, Tuple[int, int]], torch.Tensor]


def loransac_h(t: Tentatives, pars: RANSACPars, draws: Optional[Draws] = None,
               generator: Optional[torch.Generator] = None) -> MatchResult:
    """Verification of LORANSACFiltering (matching.cpp:637-806, useF
    false): one batched core; while the rtools `nsamples` bound at the
    inlier ratio found is not met (and under max_samples), sweeps of
    doubling size (up to MAX_SWEEP hypotheses, one at a time); a second
    core seeded with the best sweep model; then the H-LAF check.

    draws(name, shape) -> uniforms [shape] in [0, 1): "u_sweep" and "u_lo"
    for the first core, f"sweep{i}" for the i-th adaptive sweep, "u_sweep2"
    and "u_lo2" for the second core.  Without `draws` every uniform comes
    from `generator`."""
    M = t.m
    u = _drawer(draws, generator, t.xy1.device)
    th = pars.err_threshold ** 2
    bh = pars.batch_hypotheses
    core = lambda tag, **kw: _ransac_h_core(
        t.xy1, t.xy2, t.valid, th, bh, pars.lo_batch,
        u_sweep=u("u_sweep" + tag, (bh, M)), u_lo=u("u_lo" + tag, (pars.lo_batch, M)),
        **kw)
    H, inl, I, J = core("")
    m = int(t.valid.sum())
    best_i = int(I)
    total = batch = bh
    H0 = J0 = None
    i = 0
    while m > 0:
        if total >= min(nsamples_required(best_i, m, 4, pars.confidence),
                        pars.max_samples):
            break
        batch = min(batch * 2, MAX_SWEEP)
        Hc, Ic, Jc = _sweep_h_px(t.xy1, t.xy2, t.valid, th, u(f"sweep{i}", (batch, M)))
        i += 1
        total += batch
        if J0 is None or float(Jc) > float(J0):
            H0, J0 = Hc, Jc
            best_i = max(best_i, int(Ic))
    if H0 is not None:
        H2, inl2, I2, J2 = core("2", H_init=H0, J_init=J0)
        if float(J2) > float(J):
            H, inl, I, J = H2, inl2, I2, J2
    keep = inl
    if pars.HLAFCoef > 0:
        keep = _laf_check_h(t.with_valid(inl), H,
                            3.0 * pars.HLAFCoef * pars.err_threshold)
        # reference: if fewer than MIN_POINTS survive the check, none do
        keep = keep & (keep.sum() >= MIN_POINTS)
    t_inl = t.with_valid(keep)
    return MatchResult(tentatives=t_inl, H=H, n_inliers=t_inl.count(),
                       score=J.to(torch.float32))


def hmatrix_filter(t: Tentatives, H_gt: np.ndarray, pars: RANSACPars) -> Tentatives:
    """Ground-truth-H verification (matching.cpp:917-1013
    HMatrixFiltering): the larger transfer error of each correspondence
    at most err_threshold^2."""
    H = torch.as_tensor(np.asarray(H_gt, np.float32), device=t.xy1.device)
    err = symm_transfer_sq(H, torch.linalg.inv(H), t.xy1, t.xy2, reduce="max")
    return t.with_valid(t.valid & (err <= pars.err_threshold ** 2))


# --------------------------------------------------------------------------- #
# RANSAC-H from two ellipse (affine-frame) correspondences
# --------------------------------------------------------------------------- #
def _affine_rows(xy1, xy2, M) -> torch.Tensor:
    """4 linear constraints per affine correspondence: the Jacobian of H
    at x1 equals the relative affine M up to the projective denominator,
      H[i,j] - x2_i*H[2,j] - M[i,j]*(h3 . x1~) = 0  (i,j in {0,1}).
    Returns [..., 4, 9] rows in h-vector order (row-major H); the standard
    2-AC linearization of the reference's A2toRH (ranH2el.c:233-280)."""
    x, y = xy1[..., 0], xy1[..., 1]
    u, v = xy2[..., 0], xy2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    m00, m01 = M[..., 0, 0], M[..., 0, 1]
    m10, m11 = M[..., 1, 0], M[..., 1, 1]
    r00 = torch.stack([o, z, z, z, z, z, -u - m00 * x, -m00 * y, -m00], -1)
    r01 = torch.stack([z, o, z, z, z, z, -m01 * x, -u - m01 * y, -m01], -1)
    r10 = torch.stack([z, z, z, o, z, z, -v - m10 * x, -m10 * y, -m10], -1)
    r11 = torch.stack([z, z, z, z, o, z, -m11 * x, -v - m11 * y, -m11], -1)
    return torch.stack([r00, r01, r10, r11], -2)


def _ransac_h2el_core(xy1, xy2, M_rel, valid, th, u_2el: torch.Tensor,
                      u_sweep: torch.Tensor, u_lo: torch.Tensor):
    """Minimal 2-AC hypothesis sweep from the uniforms u_2el [batch, M],
    then the LO core with a sweep of 8 (u_sweep [8, M], u_lo [lo_batch,
    M]), seeded with the best 2-AC model as H_init."""
    th = torch.as_tensor(th, dtype=torch.float32, device=xy1.device)
    T1, T2, xy1n, xy2n, th_n = _normalize_pair(xy1, xy2, valid, th)
    # the similarity normalizations rescale the local affines uniformly
    Mn = M_rel * (T2[0, 0] / T1[0, 0])
    batch = u_2el.shape[0]
    sidx = _top_idx(torch.where(valid[None, :], u_2el, -1.0), 2)    # [B,2]
    p, q = xy1n[sidx], xy2n[sidx]
    A = torch.cat([dlt_rows(p, q).reshape(batch, 4, 9),
                   _affine_rows(p, q, Mn[sidx]).reshape(batch, 8, 9)], 1)
    Hb = h_from_rows(A)                                             # [B,3,3]
    # the oriented test indexes points 0..3 and the JAX package clamps
    # them to the sample's two: its triangles are degenerate (always
    # pass), the homogeneous-sign test sees points 0, 1, 1, 1
    four = torch.tensor([0, 1, 1, 1], device=xy1.device)
    ok = _oriented_ok(p[:, four], q[:, four], Hb) & torch.isfinite(Hb).all(dim=(1, 2))
    _, Jb = msac_score(sampson_h_sq(Hb, xy1n, xy2n), valid[None, :], th_n)
    Jb = torch.where(ok, Jb, -1.0)
    best = torch.argmax(Jb)
    return _ransac_h_core(xy1, xy2, valid, th, 8, u_lo.shape[0], u_sweep=u_sweep,
                          u_lo=u_lo, H_init=Hb[best], J_init=Jb[best])


def ransac_h_2el(t: Tentatives, pars: RANSACPars, draws: Optional[Draws] = None,
                 generator: Optional[torch.Generator] = None) -> MatchResult:
    """RANSAC-H from two ellipse/affine-frame correspondences (reference
    degensac/ranH2el.c ransacH2el; a library verifier, as in the
    reference not on the main path).  Each tentative's LAF pair gives the
    local affine M = (s2 A2)(s1 A1)^-1, so a minimal sample is 2
    correspondences.

    draws(name, shape) -> uniforms in [0, 1): "u_2el" [batch_hypotheses,
    M] for the 2-AC sweep, "u_sweep" [8, M] and "u_lo" [lo_batch, M] for
    the LO core; without `draws` they come from `generator`."""
    M = t.m
    u = _drawer(draws, generator, t.xy1.device)
    A1f = t.A1 * t.s1[:, None, None]
    A2f = t.A2 * t.s2[:, None, None]
    det = A1f[:, 0, 0] * A1f[:, 1, 1] - A1f[:, 0, 1] * A1f[:, 1, 0]
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    inv1 = torch.stack([torch.stack([A1f[:, 1, 1], -A1f[:, 0, 1]], -1),
                        torch.stack([-A1f[:, 1, 0], A1f[:, 0, 0]], -1)], -2) \
        / det[:, None, None]
    M_rel = A2f @ inv1
    H, inl, _, J = _ransac_h2el_core(
        t.xy1, t.xy2, M_rel, t.valid, pars.err_threshold ** 2,
        u("u_2el", (pars.batch_hypotheses, M)), u("u_sweep", (8, M)),
        u("u_lo", (pars.lo_batch, M)))
    t_out = t.with_valid(inl)
    return MatchResult(tentatives=t_out, H=H, n_inliers=t_out.count(), score=J)
