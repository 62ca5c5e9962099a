# Frozen copy of mods_tpu_torch/detect/affine_shape.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""Baumberg affine-shape adaptation: the SMM method on the kernel path, and
the Hessian method.

Counterpart of the JAX package's detect/affine_shape.py (reference
affine.cpp:26-158): the per-keypoint SMM iteration runs inside the
Baumberg kernels of ops/patch_kernels.py, reading the octave's blur stack
in place through aligned 112x256 windows when the octave is at least that
large, and precropped 104x104 windows otherwise.  The Hessian method
(`method == "Hessian"`) samples 3x3 warped patches with the exact sampler
`imops.affine_sample_level`, as the JAX package does outside any Pallas
kernel, so it is PyTorch on either device.  The JAX package's exact
sampler path for SMM (`engine=False`) is not ported: the port has one SMM
route, the kernels'.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import AffineShapeParams
from ..ops import image as imops
from ..ops import patch_engine as pe
from ..ops import patch_kernels as pk

# Baumberg crop window: the worst admissible footprint (9.5 px half-patch
# x ratio <= 2.05 x sqrt(6) anisotropy ~= 47.7 px) plus centre and
# bilinear slack.
BAUMBERG_WIN = 104


def inv_sqrt_2x2(a, b, c):
    """Inverse square root of SPD [[a,b],[b,c]], normalized to det 1
    (reference helpers.cpp:463-502 invSqrt).  Returns (a', b', c', l1, l2)."""
    bnz = b != 0.0
    r_ = torch.where(bnz, (c - a) / (2.0 * b), torch.ones_like(a))
    t = torch.where(bnz,
                    torch.where(r_ >= 0, 1.0 / (r_ + torch.sqrt(1 + r_ * r_)),
                                -1.0 / (-r_ + torch.sqrt(1 + r_ * r_))),
                    0.0)
    rr = torch.where(bnz, 1.0 / torch.sqrt(1 + t * t), 1.0)
    tt = t * rr
    x = 1.0 / torch.sqrt(rr * rr * a - 2 * rr * tt * b + tt * tt * c)
    z = 1.0 / torch.sqrt(tt * tt * a + 2 * rr * tt * b + rr * rr * c)
    d = torch.sqrt(x * z)
    x = x / d
    z = z / d
    l1 = torch.maximum(x, z)
    l2 = torch.minimum(x, z)
    na = rr * rr * x + tt * tt * z
    nb = -rr * tt * x + tt * rr * z
    nc = tt * tt * x + rr * rr * z
    return na, nb, nc, l1, l2


def eigenvalues_2x2(a, b, c, d):
    """reference helpers.cpp:504-515 getEigenvalues. Returns (ok, l1, l2)."""
    trace = a + d
    delta1 = trace * trace - 4 * (a * d - b * c)
    ok = delta1 >= 0
    delta = torch.sqrt(torch.clamp(delta1, min=0.0))
    return ok, (trace + delta) / 2.0, (trace - delta) / 2.0


def rectify_up_is_up(A: torch.Tensor) -> torch.Tensor:
    """Lower-triangular det-1 form (reference helpers.cpp:380-389)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    det = torch.sqrt(torch.abs(a * d - b * c))
    b2a2 = torch.sqrt(b * b + a * a)
    n11 = b2a2 / det
    n12 = torch.zeros_like(a)
    n21 = (d * b + c * a) / (b2a2 * det)
    n22 = det / b2a2
    return torch.stack([torch.stack([n11, n12], -1),
                        torch.stack([n21, n22], -1)], -2)


def baumberg_batch(blurs: torch.Tensor, lev: torch.Tensor,
                   lx: torch.Tensor, ly: torch.Tensor, ratio: torch.Tensor,
                   valid: torch.Tensor, par: AffineShapeParams
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run Baumberg on a padded batch of keypoints of ONE octave.

    blurs: [L,H,W] octave blur stack; `lev` the per-keypoint blur level
    (one below the response peak, reference pyramid.cpp:402); lx, ly the
    position in octave pixels; ratio = s / initialSigma.
    Returns (U [N,2,2] with det 1, ok [N])."""
    n = lx.shape[0]
    dev = blurs.device
    if not par.doBaumberg:
        return torch.eye(2, device=dev).expand(n, 2, 2).clone(), valid
    if par.method == "Hessian":
        return _baumberg_hessian(blurs, lev, lx, ly, ratio, valid, par)
    ws = par.smmWindowSize
    mask = torch.from_numpy(imops.gauss_mask(ws)).to(dev)
    max_iter = par.maxIterations
    conv = float(par.convergenceThreshold)
    H, W = blurs.shape[-2], blurs.shape[-1]
    lev = lev.to(torch.int32).contiguous()
    vf = valid.to(torch.float32)
    if H >= pk.DMA_WIN_Y and W >= pk.DMA_WIN_X:
        lw = torch.full((n,), W, dtype=torch.int32, device=dev)
        lh = torch.full((n,), H, dtype=torch.int32, device=dev)
        woy, wox = pk.dma_window_origins(lx, ly, lw, lh)
        params = torch.stack([
            lx - wox.to(torch.float32), ly - woy.to(torch.float32),
            ratio, vf, wox.to(torch.float32), woy.to(torch.float32),
            torch.full((n,), float(W), device=dev),
            torch.full((n,), float(H), device=dev)], -1)
        U, ok = pk.dma_baumberg(blurs.contiguous(), lev, woy.contiguous(),
                                wox.contiguous(), params.contiguous(), mask,
                                ws, max_iter, conv)
        return U, ok & valid
    xy = torch.stack([lx, ly], -1)
    wins, wox, woy = pe.crop_windows(blurs, lev, xy, BAUMBERG_WIN)
    params = torch.stack([
        lx - wox, ly - woy, ratio, vf,
        wox.to(torch.float32), woy.to(torch.float32),
        torch.full((n,), float(W), device=dev),
        torch.full((n,), float(H), device=dev)], -1)
    U, ok = pk.baumberg_windows(wins, params.contiguous(), mask, ws, max_iter,
                                conv)
    return U, ok & valid


def _baumberg_hessian(blurs, lev, lx, ly, ratio, valid, par: AffineShapeParams):
    """The AFF_BMBRG_HESSIAN variant (affine.cpp:92-131): iterate on the 3x3
    Hessian of the warped patch, U <- Au U Au with Au the SVD-style inverse
    square root.  affRatio = ratio * initialSigma * affMeasRegion (octave
    pixels).  The reference's accept/reject order holds: each iteration
    updates only the rows not yet done, accepts before it rejects, and
    takes U at acceptance.  The loop runs all maxIterations without asking
    the device whether every row is done: once a row is done, an iteration
    leaves it as it is, so the JAX package's early exit changes nothing."""
    n = lx.shape[0]
    dev = blurs.device
    aff_ratio = ratio * par.initialSigma * par.affMeasRegion
    conv = par.convergenceThreshold
    eye = torch.eye(2, device=dev).expand(n, 2, 2).clone()
    U, outU = eye, eye
    erb = torch.zeros(n, device=dev)
    done = ~valid
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(par.maxIterations):
        p = imops.affine_sample_level(blurs, lev, lx, ly,
                                      U * aff_ratio[:, None, None], 3, 3)
        Dxx = (p[:, 0, 0] - 2 * p[:, 0, 1] + p[:, 0, 2]
               + 2 * p[:, 1, 0] - 4 * p[:, 1, 1] + 2 * p[:, 1, 2]
               + p[:, 2, 0] - 2 * p[:, 2, 1] + p[:, 2, 2])
        Dyy = (p[:, 0, 0] + 2 * p[:, 0, 1] + p[:, 0, 2]
               - 2 * p[:, 1, 0] - 4 * p[:, 1, 1] - 2 * p[:, 1, 2]
               + p[:, 2, 0] + 2 * p[:, 2, 1] + p[:, 2, 2])
        Dxy = p[:, 0, 0] - p[:, 0, 2] - p[:, 2, 0] + p[:, 2, 2]
        # eigendecomposition of [[Dxx,Dxy],[Dxy,Dyy]] in SVD order (|lambda|
        # descending), the signs carried by Vt's rows
        tr = Dxx + Dyy
        disc = torch.sqrt(torch.clamp((Dxx - Dyy) ** 2 + 4 * Dxy * Dxy, min=0.0))
        lam1 = (tr + disc) / 2
        lam2 = (tr - disc) / 2
        swap = lam2.abs() > lam1.abs()
        big = torch.where(swap, lam2, lam1)
        sml = torch.where(swap, lam1, lam2)
        theta = 0.5 * torch.atan2(2 * Dxy, Dxx - Dyy)
        ct, st = torch.cos(theta), torch.sin(theta)
        # eigenvector of lam1 (ct, st), of lam2 (-st, ct)
        e1 = torch.stack([torch.where(swap, -st, ct), torch.where(swap, ct, st)], -1)
        e2 = torch.stack([torch.where(swap, ct, -st), torch.where(swap, st, ct)], -1)
        w1, w2 = big.abs(), sml.abs()
        era = 1.0 - w2 / torch.clamp(w1, min=1e-20)
        det = torch.sqrt(torch.clamp(w1 * w2, min=1e-20))
        q2 = torch.sqrt(torch.sqrt(w1 / det))
        q1 = 1.0 / q2
        # Au = U diag(q1, q2) Vt, Vt's rows sign(lambda_i) e_i
        s1, s2 = torch.sign(big), torch.sign(sml)
        Au = ((q1 * s1)[:, None, None] * e1[:, :, None] * e1[:, None, :]
              + (q2 * s2)[:, None, None] * e2[:, :, None] * e2[:, None, :])
        Un = Au @ U @ Au
        nan_bad = ~torch.isfinite(Un).all(dim=-1).all(dim=-1)
        eok, l1, l2 = eigenvalues_2x2(Un[:, 0, 0], Un[:, 0, 1], Un[:, 1, 0], Un[:, 1, 1])
        aniso_bad = (~eok) | (l1 / l2 > 6.0) | (l2 / l1 > 6.0)
        converged = (era < conv) & (erb < conv)
        accept_now = (~done) & (~nan_bad) & (~aniso_bad) & converged
        reject_now = (~done) & (nan_bad | aniso_bad)
        outU = torch.where(accept_now[:, None, None], Un, outU)
        ok = ok | accept_now
        U = torch.where(done[:, None, None], U, Un)
        erb = torch.where(done, erb, era)
        done = done | accept_now | reject_now
    return outU, ok & valid
