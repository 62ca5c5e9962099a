"""Batched 7-point fundamental-matrix RANSAC (DEGENSAC).

Counterpart of the JAX package's verify/fundamental.py (reference
degensac/exp_ranF.c exp_ransacFcustom, matching.cpp:714-727, 807-820):
  - 7-point samples -> 2-dim nullspace by Gauss-Jordan elimination ->
    the cubic det(F1 + a F2) = 0 -> up to 3 F's (exp_ranF.c:892-921);
  - the oriented epipolar constraint (Ftools.c:82 all_ori_valid);
  - Sampson scoring (Ftools.c FDs) with the MSAC truncated quadratic;
  - optional symmetric-epipolar cross-check (exp_ranF.c:936-948);
  - LO: weighted 8-point LSQ on inlier subsets with the shrinking
    threshold, rank 2 by SVD;
  - the H-degeneracy pass (exp_ranF.c:959-1003): checksample on the
    winning sample, a dominant-plane 4-point sweep, innerH and the
    plane-and-parallax recovery rFtH, branchless and batched;
  - `loransac_f`: the adaptive host loop of doubling sweeps and the F-LAF
    check (matching.cpp:192-249).
Every uniform is injectable (`draws`), so that a test can hand in the JAX
package's; without them they come from a torch.Generator.  Scalar
decisions inside a core stay on the device (`torch.where` on 0-d
tensors); only the adaptive loop reads numbers back.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import RANSACPars
from ..types import MatchResult, Tentatives
from .homography import (ILSQ_ITERS, MAX_SWEEP, MIN_POINTS, MWM, TC, Draws,
                         _drawer, _laf_points, _normalize_pair, _sweep_h, _top_idx,
                         _weighted_lsq_h, apply_h, msac_score, normalize_transform,
                         nsamples_required)

H_BATCH = 512       # the degeneracy pass's dominant-plane 4-point sweep
PP_BATCH = 256      # its plane-and-parallax epipole pairs

# checksample index triples (DegUtils.c:43)
_DEGEN_TRIPLES = np.array([[0, 1, 2], [3, 4, 5], [0, 1, 6],
                           [3, 4, 6], [2, 5, 6]])


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _homog(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], -1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _inv_nan(M: torch.Tensor) -> torch.Tensor:
    """Inverse, NaN where M is singular (jnp.linalg.inv's non-finite
    result; torch.linalg.inv raises)."""
    Mi, info = torch.linalg.inv_ex(M)
    return torch.where((info != 0)[..., None, None], float("nan"), Mi)


def _epipole2(F: torch.Tensor) -> torch.Tensor:
    """Epipole in image 2: null vector of F^T.  Its sign is LAPACK's or
    cuSOLVER's; every use below is sign-free or flips H's sign only."""
    return torch.linalg.svd(F.transpose(-1, -2)).Vh[..., 2, :]


def _h_transfer_sq(H: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """Squared symmetric transfer error of H [..., 3, 3] on points [M, 2]
    -> [..., M] (DegUtils dHDs)."""
    eye = torch.eye(3, device=H.device)
    Hi = _inv_nan(H + 1e-12 * eye)
    return (((apply_h(H, xy1) - xy2) ** 2).sum(-1)
            + ((apply_h(Hi, xy2) - xy1) ** 2).sum(-1))


def _hdetect(F: torch.Tensor, xy1s: torch.Tensor, xy2s: torch.Tensor) -> torch.Tensor:
    """Homography from F + 3 point correspondences [..., 3, 2] (DegUtils.c
    Hdetect, Hartley & Zisserman 'Scene planes and homographies' p.318):
    H = A - e' b^T with A = [e']x F and b solved from the 3 points."""
    e2 = _epipole2(F)
    A = _skew(e2) @ F
    x1 = _homog(xy1s)                                  # [...,3,3]
    x2 = _homog(xy2s)
    Ax = x1 @ A.T                                      # A x1
    c1 = _cross(x2, Ax)                                # x2 x (A x1)
    c2 = _cross(x2, e2)                                # x2 x e'
    b = (c1 * c2).sum(-1) / torch.clamp((c2 * c2).sum(-1), min=1e-30)
    bv, info = torch.linalg.solve_ex(x1 + 1e-12 * torch.eye(3, device=F.device),
                                     b[..., None])
    bv = torch.where((info != 0)[..., None], float("nan"), bv[..., 0])
    return A - e2[:, None] * bv[..., None, :]


def _degeneracy_pass(F_in, sample_p_in, sample_q_in, xy1_in, xy2_in, valid,
                     th_in, u_h: torch.Tensor, u_pp: torch.Tensor):
    """DEGENSAC H-degeneracy handling (exp_ranF.c:959-1003), batched and
    branchless: checksample on the winning 7-sample plus a direct
    dominant-plane sweep, H local-opt over all correspondences (innerH),
    plane-and-parallax F recovery (rFtH).  u_h [H_BATCH, M] are the
    uniforms of the plane sweep, u_pp [PP_BATCH, M] those of the epipole
    pairs.  Returns (F_pp, J_pp, degenerate) in the input frame; the
    caller adopts F_pp when degenerate and better.

    The reference runs checksample on every sample that improves the
    running best; the plane sweep over all tentatives gives the batched
    program that coverage.  All DLT fits run in Hartley-normalized
    coordinates, mirroring the reference's normu inside u2h/u2f."""
    dev = xy1_in.device
    vf = valid.to(torch.float32)
    Ta = normalize_transform(xy1_in, vf)
    Tb = normalize_transform(xy2_in, vf)
    xy1n = apply_h(Ta, xy1_in)
    xy2n = apply_h(Tb, xy2_in)
    sample_p = apply_h(Ta, sample_p_in)
    sample_q = apply_h(Tb, sample_q_in)
    # F in the normalized frame: x2n^T F_n x1n = 0 with x_n = T x
    F_best = _inv_nan(Tb).T @ F_in @ _inv_nan(Ta)
    th_n = th_in * Tb[0, 0] * Tb[0, 0]
    # --- checksample (DegUtils.c:42-81): 5 triples -> H, refit on the 5
    # sample points closest to H, degenerate if >4 of 7 agree
    tri = torch.as_tensor(_DEGEN_TRIPLES, device=dev)
    Hs = _hdetect(F_best, sample_p[tri], sample_q[tri])          # [5,3,3]
    d7 = _h_transfer_sq(Hs, sample_p, sample_q)                  # [5,7]
    rank = torch.sort(d7, dim=1, stable=True).indices[:, :5]
    w5 = torch.zeros((5, 7), device=dev).scatter(1, rank, 1.0)
    T7 = normalize_transform(sample_p, torch.ones(7, device=dev))
    T7b = normalize_transform(sample_q, torch.ones(7, device=dev))
    Hs_fit = _weighted_lsq_h(apply_h(T7, sample_p), apply_h(T7b, sample_q), w5)
    Hs_fit = _inv_nan(T7b) @ Hs_fit @ T7
    d7f = _h_transfer_sq(Hs_fit, sample_p, sample_q)
    inl7 = (d7f < 3.0 * th_n * 2.0).sum(1)            # dHDs is a 2-sided sum
    hi = torch.argmax(inl7)
    sample_degen = inl7[hi] > 4
    H_cs = Hs_fit[hi]

    # --- dominant-plane sweep: best 4-point H over all tentatives
    H_sw, _, _ = _sweep_h(xy1n, xy2n, valid, th_n, u_h)

    # --- innerH (DegUtils.c:693): iterative weighted LSQ on H inliers, run
    # from both candidates at once; keep the one with the larger consensus
    H2 = torch.stack([H_cs, H_sw])
    for _ in range(4):
        d = _h_transfer_sq(H2, xy1n, xy2n)
        H2 = _weighted_lsq_h(xy1n, xy2n,
                             (valid & (d <= 16.0 * th_n * 2.0)).to(torch.float32))
    d_h2 = _h_transfer_sq(H2, xy1n, xy2n)                        # [2,M]
    h_inl2 = valid & (d_h2 <= 3.0 * th_n * 2.0)
    # prefer the checksample candidate on ties (reference entry path);
    # non-finite innerH output (degenerate LSQ) must never win
    finite = torch.isfinite(H2).all(dim=(1, 2))
    na = torch.where(sample_degen & finite[0], h_inl2[0].sum(), -1)
    nb = torch.where(finite[1], h_inl2[1].sum(), -1)
    use = (na < nb).long()
    H_opt, h_inl, d_h = H2[use], h_inl2[use], d_h2[use]
    degenerate = h_inl.sum() > 6                      # exp_ranF.c: innerH I > 6

    # --- rFtH (DegUtils.c:253): for off-plane points the lines
    # x2 x (H x1) meet in the epipole; sample pairs, F = [e2]x H
    off = valid & (d_h > 100.0 * th_n * 2.0)
    lines = _cross(_homog(xy2n), _homog(xy1n) @ H_opt.T)       # [M,3]
    pidx = _top_idx(torch.where(off[None, :], u_pp, -1.0), 2)
    e2c = _cross(lines[pidx[:, 0]], lines[pidx[:, 1]])         # [B,3]
    e2c = e2c / torch.clamp(torch.linalg.norm(e2c, dim=-1, keepdim=True), min=1e-30)
    F_pp = _skew(e2c) @ H_opt                                  # [B,3,3]
    _, J_pp = msac_score(sampson_f_sq(F_pp, xy1n, xy2n), valid[None, :], th_n)
    # rFtH needs >= 4 off-plane points and >= 6 plane inliers
    # (DegUtils.c:342) -- otherwise it contributes nothing
    ok = (off.sum() >= 4) & (h_inl.sum() >= 6)
    J_pp = torch.where(ok, J_pp, -1.0)
    bi = torch.argmax(J_pp)
    F_out = Tb.T @ F_pp[bi] @ Ta                 # back to the input frame
    nrm = torch.linalg.norm(F_out)
    return F_out / torch.where(nrm < 1e-12, 1.0, nrm), J_pp[bi], degenerate


def f_rows(xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """[...,2] -> [...,9] epipolar constraint rows x2^T F x1 = 0."""
    x, y = xy1[..., 0], xy1[..., 1]
    u, v = xy2[..., 0], xy2[..., 1]
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], -1)


def _lines(F: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor):
    """The epipolar residual and lines of F [..., 3, 3] on points
    [..., 2] (F [3,3] against any points; F [B,3,3] against [M,2] gives
    [B,M]): (x2^T F x1, F x1, F^T x2)."""
    def f(i, j):
        return F[..., i, j, None]
    x, y = xy1[..., 0], xy1[..., 1]
    u, v = xy2[..., 0], xy2[..., 1]
    l1 = f(0, 0) * x + f(0, 1) * y + f(0, 2)       # (F p1)_x
    l2 = f(1, 0) * x + f(1, 1) * y + f(1, 2)
    l3 = f(2, 0) * x + f(2, 1) * y + f(2, 2)
    m1 = f(0, 0) * u + f(1, 0) * v + f(2, 0)       # (F^T p2)_x
    m2 = f(0, 1) * u + f(1, 1) * v + f(2, 1)
    return u * l1 + v * l2 + l3, (l1, l2), (m1, m2)


def sampson_f_sq(F: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson epipolar error (Ftools.c FDs)."""
    num, (l1, l2), (m1, m2) = _lines(F, xy1, xy2)
    den = l1 * l1 + l2 * l2 + m1 * m1 + m2 * m2
    den = torch.where(den < 1e-20, 1e-20, den)
    return num * num / den


def symm_epi_sq(F: torch.Tensor, xy1, xy2) -> torch.Tensor:
    """Symmetric epipolar distance (max of the two point-line dists)."""
    num, (l1, l2), (m1, m2) = _lines(F, xy1, xy2)
    d2 = num * num / torch.clamp(l1 * l1 + l2 * l2, min=1e-20)
    d1 = num * num / torch.clamp(m1 * m1 + m2 * m2, min=1e-20)
    return torch.maximum(d1, d2)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no cbrt): sign(x) |x|^(1/3)."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _cubic_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d (up to 3, NaN-padded),
    via the trigonometric/Cardano method, batched."""
    a = torch.where(a.abs() < 1e-20, 1e-20, a)
    p = (3 * a * c - b * b) / (3 * a * a)
    q = (2 * b ** 3 - 9 * a * b * c + 27 * a * a * d) / (27 * a ** 3)
    shift = -b / (3 * a)
    disc = (q / 2) ** 2 + (p / 3) ** 3
    # three-real-root branch (disc <= 0)
    pc = torch.clamp(p, max=-1e-20)
    m = 2 * torch.sqrt(-pc / 3)
    arg = torch.clamp(3 * q / (pc * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3
    k = torch.arange(3, device=a.device)
    roots3 = (m[..., None] * torch.cos(theta[..., None] - 2 * math.pi * k / 3)
              + shift[..., None])
    # single-root branch (disc > 0)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root1 = _cbrt(-q / 2 + sq) + _cbrt(-q / 2 - sq) + shift
    nan = torch.full_like(root1, float("nan"))
    single = torch.stack([root1, nan, nan], -1)
    return torch.where((disc <= 0)[..., None], roots3, single)


def _nullspace2_elim(A: torch.Tensor):
    """2-dim nullspace of batched [..., 7, 9] systems by Gauss-Jordan
    elimination with partial row pivoting, 7 unrolled steps (the first of
    equal pivots, as jnp.argmax).  Solutions are the reference's
    nullspace(A) semantics (exp_ranF.c:907): basis vectors with the free
    variables (x8, x9) set to (1, 0) and (0, 1).  Near-singular systems
    give large or non-finite entries that the caller's nan_to_num and
    zero-norm rejection discard, matching the reference's
    `nullsize != 2 -> continue`."""
    batch_shape = A.shape[:-2]
    M = A.reshape((-1, 7, 9))
    B = M.shape[0]
    dev = A.device
    rows = torch.arange(7, device=dev)
    for k in range(7):
        col = torch.where(rows[None, :] >= k, M[:, :, k].abs(), -1.0)  # rows < k fixed
        p = torch.argmax(col, dim=1)                                    # [B]
        # swap rows k and p (identity when p == k)
        perm = rows.expand(B, 7)
        perm = torch.where(rows[None, :] == p[:, None], k, perm)
        perm = torch.where(rows[None, :] == k, p[:, None], perm)
        M = torch.gather(M, 1, perm[:, :, None].expand(B, 7, 9))
        piv = M[:, k, k]
        safe = torch.where(piv.abs() < 1e-20,
                           torch.where(piv < 0, -1e-20, 1e-20), piv)
        row_k = M[:, k, :] / safe[:, None]
        elim = M - M[:, :, k, None] * row_k[:, None, :]
        M = torch.where((rows == k)[None, :, None], row_k[:, None, :], elim)
    # reduced form: x_j = -M[:, j, 7or8] for pivot columns, free var = 1
    one = torch.ones((B, 1), device=dev)
    zero = torch.zeros((B, 1), device=dev)
    f1 = torch.cat([-M[:, :, 7], one, zero], dim=1)
    f2 = torch.cat([-M[:, :, 8], zero, one], dim=1)
    # normalize for numeric headroom in the cubic
    f1 = f1 / torch.clamp(torch.linalg.norm(f1, dim=1, keepdim=True), min=1e-20)
    f2 = f2 / torch.clamp(torch.linalg.norm(f2, dim=1, keepdim=True), min=1e-20)
    return (f1.reshape(batch_shape + (3, 3)), f2.reshape(batch_shape + (3, 3)))


def _det3(a: torch.Tensor) -> torch.Tensor:
    """3x3 determinants by six products, in the order of jnp.linalg.det's
    3x3 case, so that the CPU and the card give the CPU reference's bits
    (an LU, as torch.linalg.det takes, pivots another way)."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2] +
            a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0] +
            a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1] -
            a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0] -
            a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1] -
            a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _fs_from_sample(xy1s: torch.Tensor, xy2s: torch.Tensor) -> torch.Tensor:
    """7-pt minimal solver: [...,7,2]x2 -> [...,3,3,3] (3 candidate F's,
    invalid ones NaN)."""
    F1, F2 = _nullspace2_elim(f_rows(xy1s, xy2s))
    # det(F1 + a F2) = c3 a^3 + c2 a^2 + c1 a + c0 via 4-point interpolation
    d0 = _det3(F1)                                # a=0
    d1 = _det3(F1 + F2)                           # a=1
    dm1 = _det3(F1 - F2)                          # a=-1
    d2 = _det3(F1 + 2 * F2)                       # a=2
    c0 = d0
    c2 = (d1 + dm1) / 2 - d0
    c3 = (d2 - 2 * d1 + d0 - 2 * c2) / 6
    c1 = d1 - d0 - c2 - c3
    roots = _cubic_roots(c3, c2, c1, c0)          # [...,3]
    return F1[..., None, :, :] + roots[..., :, None, None] * F2[..., None, :, :]


def _epipole2_cross(F: torch.Tensor) -> torch.Tensor:
    """Epipole in image 2 (null vector of F^T) without SVD: the largest of
    the three pairwise cross products of F's columns."""
    c0, c1, c2 = F[..., :, 0], F[..., :, 1], F[..., :, 2]
    e01 = _cross(c0, c1)
    e02 = _cross(c0, c2)
    e12 = _cross(c1, c2)
    n01 = (e01 * e01).sum(-1, keepdim=True)
    n02 = (e02 * e02).sum(-1, keepdim=True)
    n12 = (e12 * e12).sum(-1, keepdim=True)
    e = torch.where(n01 >= torch.maximum(n02, n12), e01,
                    torch.where(n02 >= n12, e02, e12))
    return e / torch.clamp(torch.linalg.norm(e, dim=-1, keepdim=True), min=1e-30)


def _oriented_f_ok(F: torch.Tensor, xy1s: torch.Tensor, xy2s: torch.Tensor) -> torch.Tensor:
    """Oriented epipolar constraint (Ftools.c:82 all_ori_valid): the
    epipolar line orientations e x p2 ~ F p1 must have consistent sign
    across the sample."""
    e = _epipole2_cross(F)
    p2h = _homog(xy2s)
    l = torch.einsum("...ij,...nj->...ni", F, _homog(xy1s))     # F p1
    sign = torch.sign((l * _cross(e[..., None, :], p2h)).sum(-1))
    return (sign >= 0).all(-1) | (sign <= 0).all(-1)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
    return (U * S[..., None, :]) @ Vh


def _weighted_lsq_f(xy1, xy2, w) -> torch.Tensor:
    """8-point LSQ over weights w [..., M] -> rank-2 F [..., 3, 3]."""
    A = f_rows(xy1, xy2) * w[..., None]
    _, V = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return _rank2(V[..., :, 0].reshape(V.shape[:-2] + (3, 3)))


def _iter_lsq_f(xy1n, xy2n, valid, F0, th_n, steps: int):
    """Iterative LSQ with the threshold shrinking TC*th -> th over F0
    [..., 3, 3]; returns the best (F, J) seen."""
    lead = F0.shape[:-2]
    F, bestF = F0, F0
    bestJ = torch.full(lead, -1.0, device=F0.device)
    for it in range(steps + 1):
        ths = TC * th_n - (TC - 1.0) * th_n * float(it) / steps
        d = sampson_f_sq(F, xy1n, xy2n)
        _, J = msac_score(d, valid, th_n)
        better = J > bestJ
        bestF = torch.where(better[..., None, None], F, bestF)
        bestJ = torch.where(better, J, bestJ)
        F = _weighted_lsq_f(xy1n, xy2n, (valid & (d <= ths * MWM)).to(torch.float32))
    _, J = msac_score(sampson_f_sq(F, xy1n, xy2n), valid, th_n)
    better = J > bestJ
    return torch.where(better[..., None, None], F, bestF), torch.where(better, J, bestJ)


def _sweep_f(xy1n, xy2n, valid, th_n, u: torch.Tensor, do_symm_check: bool):
    """One batch of 7-point hypotheses (up to 3 F's each) from the
    uniforms u [batch, M], scored; returns (F_best, I, J, sample_p,
    sample_q) in the normalized frame."""
    batch = u.shape[0]
    sidx = _top_idx(torch.where(valid[None, :], u, -1.0), 7)  # distinct 7-subsets
    p = xy1n[sidx]
    q = xy2n[sidx]
    Fs = torch.nan_to_num(_fs_from_sample(p, q), nan=0.0)     # [B,3,3,3]
    Fs_flat = Fs.reshape(batch * 3, 3, 3)
    ok_or = _oriented_f_ok(Fs_flat, p.repeat_interleave(3, 0),
                           q.repeat_interleave(3, 0))
    # NaN cubic roots were zeroed above; an (all-zero) F has zero Sampson
    # error everywhere and must not win
    ok_or = ok_or & (torch.linalg.norm(Fs_flat.reshape(-1, 9), dim=1) > 1e-8)
    I, J = msac_score(sampson_f_sq(Fs_flat, xy1n, xy2n), valid[None, :], th_n)
    if do_symm_check:
        ds = symm_epi_sq(Fs_flat, xy1n, xy2n)
        Is = (valid[None, :] & (ds <= th_n)).sum(-1)
        ok_or = ok_or & (Is.to(torch.float32) >= 0.6 * I.to(torch.float32))
    J = torch.where(ok_or, J, -1.0)
    best = torch.argmax(J)
    return Fs_flat[best], I[best], J[best], p[best // 3], q[best // 3]


def _sweep_f_px(xy1, xy2, valid, th, u: torch.Tensor, do_symm_check: bool):
    """One standalone hypothesis sweep of the adaptive loop on pixel
    coordinates: (F normalized frame, I, J, sample_p, sample_q)."""
    th = torch.as_tensor(th, dtype=torch.float32, device=xy1.device)
    _, _, xy1n, xy2n, th_n = _normalize_pair(xy1, xy2, valid, th)
    return _sweep_f(xy1n, xy2n, valid, th_n, u, do_symm_check)


def _ransac_f_core(xy1, xy2, valid, th, u_sweep, u_lo, do_symm_check: bool,
                   u_degen_h=None, u_degen_pp=None, init=None):
    """Fixed-budget batched LO-RANSAC-F: one sweep (u_sweep [batch, M]),
    the degeneracy pass when its uniforms are given (u_degen_h [H_BATCH, M],
    u_degen_pp [PP_BATCH, M]), LSQ-before-LO and the LO subsets (u_lo
    [lo_batch, M]), a final LSQ.  init (optional): (F, J, sample_p,
    sample_q) from the adaptive loop's sweeps, adopted when better than
    this core's own sweep (the normalized frames agree).
    Returns (F in pixels, unit norm; inlier mask; I; J)."""
    M = xy1.shape[0]
    dev = xy1.device
    th = torch.as_tensor(th, dtype=torch.float32, device=dev)
    T1, T2, xy1n, xy2n, th_n = _normalize_pair(xy1, xy2, valid, th)

    F_best, _, J_best, p7, q7 = _sweep_f(xy1n, xy2n, valid, th_n, u_sweep,
                                         do_symm_check)
    if init is not None:
        F_i, J_i, p_i, q_i = init
        better = J_i > J_best
        F_best = torch.where(better, F_i, F_best)
        J_best = torch.where(better, J_i, J_best)
        p7 = torch.where(better, p_i, p7)
        q7 = torch.where(better, q_i, q7)

    adopt = torch.zeros((), dtype=torch.bool, device=dev)
    if u_degen_h is not None:
        # DEGENSAC: if the winning sample is H-degenerate, recover F by
        # plane-and-parallax and adopt it when it scores better
        # (exp_ranF.c:959-1003)
        F_pp, J_pp, is_degen = _degeneracy_pass(
            F_best, p7, q7, xy1n, xy2n, valid, th_n, u_degen_h, u_degen_pp)
        adopt = is_degen & (J_pp > J_best)
        F_best = torch.where(adopt, F_pp, F_best)
        J_best = torch.where(adopt, J_pp, J_best)

    # LO: LSQ on generous inliers + subset batch
    d_best = sampson_f_sq(F_best, xy1n, xy2n)
    w0 = (valid & (d_best <= TC * th_n * MWM)).to(torch.float32)
    F_lsq, J_lsq = _iter_lsq_f(xy1n, xy2n, valid, _weighted_lsq_f(xy1n, xy2n, w0),
                               th_n, ILSQ_ITERS)

    inl = valid & (sampson_f_sq(F_lsq, xy1n, xy2n) <= th_n)
    ssiz = torch.clamp(inl.sum() // 2, 8, 14)
    lo_batch = u_lo.shape[0]
    k16 = min(16, M)
    rank16 = _top_idx(torch.where(inl[None, :], u_lo, -1.0), k16)  # covers ssiz <= 14
    take16 = (torch.arange(k16, device=dev) < ssiz).to(torch.float32)
    sub_w = torch.zeros((lo_batch, M), device=dev).scatter(
        1, rank16, take16.expand(lo_batch, k16).contiguous())
    sub_w = sub_w * inl.to(torch.float32)
    Fl, Jl = _iter_lsq_f(xy1n, xy2n, valid, _weighted_lsq_f(xy1n, xy2n, sub_w),
                         th_n, ILSQ_ITERS)

    cand_F = torch.cat([F_best[None], F_lsq[None], Fl], 0)
    cand_J = torch.cat([J_best[None], J_lsq[None], Jl], 0)
    Fg = cand_F[torch.argmax(cand_J)]

    d_g = sampson_f_sq(Fg, xy1n, xy2n)
    F_fin = _weighted_lsq_f(xy1n, xy2n, (valid & (d_g <= th_n)).to(torch.float32))
    d_fin = sampson_f_sq(F_fin, xy1n, xy2n)
    _, J_fin = msac_score(d_fin, valid, th_n)
    use_fin = J_fin >= cand_J.max()
    F_out = torch.where(use_fin, F_fin, Fg)
    d_out = torch.where(use_fin, d_fin, d_g)
    # H-degenerate scene: the reference suppresses all LSQ local
    # optimization once the degenerate path fired (exp_ranF.c:1031/1080
    # gate on degen_cnt) -- an 8-point fit on coplanar inliers has a 3-dim
    # null space.  Keep the plane-and-parallax F instead.
    F_out = torch.where(adopt, F_best, F_out)
    d_out = torch.where(adopt, sampson_f_sq(F_best, xy1n, xy2n), d_out)
    inliers = valid & (d_out <= th_n)
    I_out, J_out = msac_score(d_out, valid, th_n)

    F_px = T2.T @ F_out @ T1                   # denormalize
    nrm = torch.linalg.norm(F_px)
    return F_px / torch.where(nrm < 1e-12, 1.0, nrm), inliers, I_out, J_out


def _laf_check_f(t: Tentatives, F: torch.Tensor, thresh) -> torch.Tensor:
    """F_LAF_check (matching.cpp:192-249): Sampson error on the 3 LAF
    points (the radius K_SIGMA = 3.0 of matching.cpp:171, not the
    measurement region's 3*sqrt(3)), drop when sqrt(e0)+sqrt(e1)+sqrt(e2)
    > thresh."""
    err = sampson_f_sq(F, _laf_points(t.xy1, t.A1, t.s1),
                       _laf_points(t.xy2, t.A2, t.s2))                  # [M,3]
    return t.valid & (torch.sqrt(err).sum(-1) <= thresh)


def _laf_tail(t: Tentatives, inl: torch.Tensor, F: torch.Tensor, laf_th: float):
    """The F-LAF check on the inliers, then the MIN_POINTS gate: if fewer
    than MIN_POINTS survive, none do."""
    keep = _laf_check_f(t.with_valid(inl), F, laf_th)
    return keep & (keep.sum() >= MIN_POINTS)


def loransac_f(t: Tentatives, pars: RANSACPars, draws: Optional[Draws] = None,
               generator: Optional[torch.Generator] = None) -> MatchResult:
    """LORANSACFiltering with useF (matching.cpp:714-727, 807-820): one
    batched core (with the degeneracy pass when doDegeneracyCheck); while
    the rtools `nsamples` bound for 7-point samples at the inlier ratio
    found is not met (and under max_samples), sweeps of doubling size (up
    to MAX_SWEEP hypotheses); a second core seeded with the best sweep
    model; then the F-LAF check.  MatchResult.H holds F (unit norm).

    draws(name, shape) -> uniforms in [0, 1): "u_sweep" [batch_hypotheses,
    M], "u_lo" [lo_batch, M], "u_degen_h" [H_BATCH, M] and "u_degen_pp"
    [PP_BATCH, M] for the first core, f"sweep{i}" for the i-th adaptive
    sweep, the same four names with the suffix "2" for the second core.
    Without `draws` every uniform comes from `generator`."""
    M = t.m
    u = _drawer(draws, generator, t.xy1.device)
    th = pars.err_threshold ** 2
    bh = pars.batch_hypotheses
    symm = bool(pars.doSymmCheck)

    def core(tag, init=None):
        u_sweep, u_lo = u("u_sweep" + tag, (bh, M)), u("u_lo" + tag, (pars.lo_batch, M))
        degen = {}
        if pars.doDegeneracyCheck:
            degen = dict(u_degen_h=u("u_degen_h" + tag, (H_BATCH, M)),
                         u_degen_pp=u("u_degen_pp" + tag, (PP_BATCH, M)))
        return _ransac_f_core(t.xy1, t.xy2, t.valid, th, u_sweep, u_lo, symm,
                              init=init, **degen)

    F, inl, I, J = core("")
    m = int(t.valid.sum())
    best_i = int(I)
    total = batch = bh
    init = None
    i = 0
    while m > 0:
        if total >= min(nsamples_required(best_i, m, 7, pars.confidence),
                        pars.max_samples):
            break
        batch = min(batch * 2, MAX_SWEEP)
        Fc, Ic, Jc, pc, qc = _sweep_f_px(t.xy1, t.xy2, t.valid, th,
                                         u(f"sweep{i}", (batch, M)), symm)
        i += 1
        total += batch
        if init is None or float(Jc) > float(init[1]):
            init = (Fc, Jc, pc, qc)
            best_i = max(best_i, int(Ic))
    if init is not None:
        F2, inl2, I2, J2 = core("2", init)
        if float(J2) > float(J):
            F, inl, I, J = F2, inl2, I2, J2
    keep = inl
    if pars.LAFCoef > 0:
        keep = _laf_tail(t, inl, F, pars.LAFCoef * pars.err_threshold)
    t_out = t.with_valid(keep)
    return MatchResult(tentatives=t_out, H=F, n_inliers=t_out.count(),
                       score=J.to(torch.float32))
