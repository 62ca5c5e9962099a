"""ORSA, a-contrario epipolar verification, batched.

Counterpart of the JAX package's verify/orsa.py (reference orsa.cpp,
Moisan-Stival ORSA, called from ORSAFiltering, matching.cpp:825-915).
The reference's sequential sampler and its mode-2 "optimization" phase
(orsa.cpp:523-612) are two fixed-size hypothesis batches: every candidate
F scores all correspondences at once, the NFA curve is a vectorized
reduction over the sorted errors, and the combinatorial tables
(orsa.cpp:143-166) are lgamma expressions.

Semantics kept from the reference:
  - coordinates centred at the image midpoint and scaled by 1/sqrt(w*h)
    (orsa.cpp:494-502);
  - error = the symmetric epipolar sum r^2 (a+b)/(ab) (orsa.cpp:238-263);
  - NFA(i) = log10(3(n-7)) + logalpha*(i-6) + logC(n,i+1) + logC(i+1,7)
    with logalpha = logalpha0 + 0.5 log10(e_i) (orsa.cpp:559-567);
  - the gate log10(NFA) < -2, then the F-LAF check (matching.cpp:884-900).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..config import RANSACPars
from ..types import MatchResult, Tentatives
from .fundamental import _fs_from_sample, _laf_tail, _lines
from .homography import Draws, _drawer, _top_idx

LN10 = math.log(10.0)
MIN_BATCH = 4096    # hypotheses a phase at least (the reference: 10000 in all)


def symm_epi_sum_sq(F: torch.Tensor, xy1, xy2) -> torch.Tensor:
    """Symmetric epipolar distance, SUM of the two squared point-line
    distances (orsa.cpp matcherrorn: e = r^2 (a+b)/(a b)); F [..., 3, 3]
    against points [M, 2] gives [..., M]."""
    r, (l1, l2), (m1, m2) = _lines(F, xy1, xy2)
    a = l1 * l1 + l2 * l2                             # F p1, the line in img2
    b = m1 * m1 + m2 * m2                             # F^T p2, in img1
    return r * r * (a + b) / torch.clamp(a * b, min=1e-30)


def _log10_comb(n, k):
    """log10 C(n, k), elementwise."""
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0)) / LN10


def nfa_curve(es: torch.Tensor, n, logalpha0) -> torch.Tensor:
    """Per-position NFA over sorted squared errors [..., M] (orsa.cpp:559-567):
      NFA(i) = loge0 + logalpha(e_i)*(i-6) + log10 C(n, i+1)
               + log10 C(i+1, 7),  for i in [7, n),
    with loge0 = log10(3(n-7)) and logalpha = logalpha0 + 0.5 log10(e_i).
    Positions outside [7, n) are +inf.  `n` may be a 0-d tensor."""
    M = es.shape[-1]
    n = torch.as_tensor(n, dtype=torch.float32, device=es.device)
    loge0 = torch.log10(3.0 * torch.clamp(n - 7.0, min=1.0))
    idx = torch.arange(M, dtype=torch.float32, device=es.device)
    logcn = _log10_comb(n, idx + 1.0)                 # log10 C(n, i+1)
    logc7 = _log10_comb(idx + 1.0, torch.tensor(7.0, device=es.device))
    pos_ok = (idx >= 7) & (idx < n)
    logalpha = logalpha0 + 0.5 * torch.log10(torch.clamp(es, min=1e-30))
    nfa = loge0 + logalpha * (idx - 6.0) + logcn + logc7
    return torch.where(pos_ok, nfa, float("inf"))


def _sample_fs(xy1n, xy2n, weights, u: torch.Tensor) -> torch.Tensor:
    """7-subsets of the `weights`-eligible rows from the uniforms u
    [batch, M] -> F candidates [3 batch, 3, 3]."""
    sidx = _top_idx(torch.where(weights[None, :], u, -1.0), 7)
    Fs = _fs_from_sample(xy1n[sidx], xy2n[sidx])      # [B,3,3,3]
    return torch.nan_to_num(Fs, nan=0.0).reshape(u.shape[0] * 3, 3, 3)


def _orsa_core(xy1, xy2, valid, w, h, u1: torch.Tensor, u2: torch.Tensor):
    """Two-phase batched ORSA with the uniforms u1, u2 [batch, M] of its
    phases.  Returns (F_px, inliers, min log10 NFA)."""
    dev = xy1.device
    n = valid.sum().to(torch.float32)
    nx = torch.tensor(float(w), dtype=torch.float32, device=dev)
    ny = torch.tensor(float(h), dtype=torch.float32, device=dev)
    norm = 1.0 / torch.sqrt(nx * ny)
    c = torch.stack([0.5 * nx, 0.5 * ny])
    xy1n = (xy1 - c) * norm
    xy2n = (xy2 - c) * norm
    logalpha0 = math.log10(2.0) + 0.5 * torch.log10((nx * nx + ny * ny) * norm * norm)

    def eval_models(Fs):
        """[B,3,3] -> per-model (min NFA, threshold err at the minimum)."""
        e = symm_epi_sum_sq(Fs, xy1n, xy2n)
        # degenerate (zeroed-NaN) candidates have zero error everywhere --
        # poison them so they can't look meaningful
        bad = torch.linalg.norm(Fs.reshape(-1, 9), dim=1) <= 1e-8
        e = torch.where(bad[:, None] | ~valid[None, :], float("inf"), e)
        es = torch.sort(e, dim=1).values              # [B,M] ascending
        nfa = nfa_curve(es, n, logalpha0)
        min_nfa, ki = torch.min(nfa, dim=1)
        return min_nfa, es.gather(1, ki[:, None])[:, 0]

    Fs1 = _sample_fs(xy1n, xy2n, valid, u1)
    nfa1, eth1 = eval_models(Fs1)
    b1 = torch.argmin(nfa1)
    F_b1, nfa_b1, eth_b1 = Fs1[b1], nfa1[b1], eth1[b1]

    # "optimization" phase (mode 2, orsa.cpp:585-601): resample among the
    # best model's meaningful inliers
    inl1 = valid & (symm_epi_sum_sq(F_b1, xy1n, xy2n) <= eth_b1)
    enough = inl1.sum() >= 8
    pool = torch.where(enough & (nfa_b1 < 0.0), inl1, valid)
    Fs2 = _sample_fs(xy1n, xy2n, pool, u2)
    nfa2, eth2 = eval_models(Fs2)
    b2 = torch.argmin(nfa2)

    use2 = nfa2[b2] < nfa_b1
    F_n = torch.where(use2, Fs2[b2], F_b1)
    best_nfa = torch.where(use2, nfa2[b2], nfa_b1)
    e_th = torch.where(use2, eth2[b2], eth_b1)
    inliers = valid & (symm_epi_sum_sq(F_n, xy1n, xy2n) <= e_th)

    # denormalize: p_n = T p_px with T = [[norm,0,-cx norm],[0,norm,-cy norm]]
    z = torch.zeros_like(norm)
    T = torch.stack([torch.stack([norm, z, -c[0] * norm]),
                     torch.stack([z, norm, -c[1] * norm]),
                     torch.stack([z, z, torch.ones_like(norm)])])
    F_px = T.T @ F_n @ T
    nrm = torch.linalg.norm(F_px)
    return F_px / torch.where(nrm < 1e-12, 1.0, nrm), inliers, best_nfa


def orsa_filter(t: Tentatives, pars: RANSACPars, w: int, h: int,
                draws: Optional[Draws] = None,
                generator: Optional[torch.Generator] = None,
                nfa_max: float = -2.0) -> MatchResult:
    """ORSAFiltering (matching.cpp:825-915): run ORSA on an image of w x h;
    if the match is meaningful (log10 NFA < nfa_max) keep the meaningful
    inliers and apply the F-LAF check, else reject everything.
    MatchResult.H holds F (unit norm), score = -log10 NFA.

    draws(name, shape) -> uniforms in [0, 1): "orsa1" and "orsa2", each
    [max(batch_hypotheses, MIN_BATCH), M], for the two phases; without
    `draws` they come from `generator`."""
    u = _drawer(draws, generator, t.xy1.device)
    shape = (max(pars.batch_hypotheses, MIN_BATCH), t.m)
    F, inl, nfa = _orsa_core(t.xy1, t.xy2, t.valid, w, h, u("orsa1", shape),
                             u("orsa2", shape))
    keep = inl & (nfa < nfa_max)
    if pars.LAFCoef > 0:
        keep = _laf_tail(t, keep, F, pars.LAFCoef * pars.err_threshold)
    t_out = t.with_valid(keep)
    return MatchResult(tentatives=t_out, H=F, n_inliers=keep.sum(),
                       score=-nfa.to(torch.float32))
