"""Scale-space detector: Hessian, DoG (and intensity-invariant iiDoG) and
Harris responses.

Counterpart of the JAX package's detect/pyramid.py (reference
detectors/affinedetectors/pyramid.cpp): per-octave response stacks,
3x3x3 NMS as max-pooling with the same wrap-around, scan-order candidate
lists with cap truncation, and the 5-iteration subpixel localizer as a
vectorized masked loop over a padded candidate set.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from ..config import PyramidParams
from ..ops import image as imops


class OctaveKeypoints(NamedTuple):
    """Per-octave padded localization output (octave coordinates)."""
    rc: torch.Tensor        # [K,2] float32 final (row, col) + subpixel offset
    level: torch.Tensor     # [K] int32 response level index (1..numberOfScales)
    scale: torch.Tensor     # [K] float32 sigma in octave pixels
    response: torch.Tensor  # [K]
    valid: torch.Tensor     # [K] bool


def hessian_response(img: torch.Tensor, norm) -> torch.Tensor:
    """det(Hessian) * norm^2 via 3x3 differences (pyramid.cpp:196-254).
    The border ring is zero."""
    c = img[..., 1:-1, 1:-1]
    Lxx = img[..., 1:-1, :-2] - 2.0 * c + img[..., 1:-1, 2:]
    Lyy = img[..., :-2, 1:-1] - 2.0 * c + img[..., 2:, 1:-1]
    Lxy = (img[..., :-2, 2:] - img[..., :-2, :-2] +
           img[..., 2:, :-2] - img[..., 2:, 2:]) / 4.0
    resp = (Lxx * Lyy - Lxy * Lxy) * (norm * norm)
    return torch.nn.functional.pad(resp, (1, 1, 1, 1))


def dog_response(img: torch.Tensor, sigma_extra: float) -> torch.Tensor:
    """img - blur(img) (pyramid.cpp:165-170)."""
    return img - imops.gaussian_blur(img, sigma_extra)


def _iidog(img: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """DoG scaled by 255/(img + nxt) where that sum is below 255.  Both
    branches are evaluated, as jnp.where does: where img + nxt is 0 (a
    black border) the response is 0 * inf = NaN, as in the JAX package."""
    s = img + nxt
    dog = img - nxt
    return torch.where(s < 255.0, dog * (255.0 / s), dog)


def iidog_response(img: torch.Tensor, sigma_extra: float) -> torch.Tensor:
    """Intensity-invariant DoG (pyramid.cpp:172-194 iidogResponse)."""
    return _iidog(img, imops.gaussian_blur(img, sigma_extra))


def harris_response(img: torch.Tensor, norm: float) -> torch.Tensor:
    """Harris cornerness (pyramid.cpp:256-278)."""
    sigmasq = 0.6 * norm
    sigma = math.sqrt(sigmasq)
    gx, gy = imops.compute_gradient(img)
    dx2 = sigmasq * imops.gaussian_blur(gx * gx, sigma)
    dy2 = sigmasq * imops.gaussian_blur(gy * gy, sigma)
    dxy = sigmasq * imops.gaussian_blur(gx * gy, sigma)
    tr = dx2 + dy2
    return dx2 * dy2 - dxy * dxy - 0.04 * tr * tr


def build_octave(first_level: torch.Tensor, par: PyramidParams,
                 init_sigma: float):
    """Blur stack + response stack for one octave
    (reference pyramid.cpp:428-494 detectOctaveKeypoints).
    Returns (blurs [S+2,H,W], responses [S+2,H,W], sigmas, next_first)."""
    S = par.numberOfScales
    sigma_step = 2.0 ** (1.0 / S)
    blurs = [first_level]
    sigmas = [init_sigma]
    cur_sigma = init_sigma
    for _ in range(1, S + 2):
        inc = cur_sigma * math.sqrt(sigma_step * sigma_step - 1.0)
        blurs.append(imops.gaussian_blur(blurs[-1], inc))
        cur_sigma *= sigma_step
        sigmas.append(cur_sigma)
    next_first = imops.half_image(blurs[S])
    blur_stack = torch.stack(blurs)
    if par.detector_type == "Hessian":
        norms = torch.tensor(sigmas, dtype=torch.float32,
                             device=blur_stack.device)[:, None, None] ** 2
        resp = hessian_response(blur_stack, norms)
    elif par.detector_type == "DoG":
        # level i: blurs[i] - blurs[i+1]; the last level blurs one step
        # further (pyramid.cpp:172-194); iiDoGMode rescales
        def dog(i):
            nxt = (blurs[i + 1] if i + 1 < len(blurs) else imops.gaussian_blur(
                blurs[i], sigmas[i] * math.sqrt(sigma_step ** 2 - 1)))
            return _iidog(blurs[i], nxt) if par.iiDoGMode else blurs[i] - nxt
        resp = torch.stack([dog(i) for i in range(len(blurs))])
    elif par.detector_type == "Harris":
        resp = torch.stack([harris_response(blurs[i], sigmas[i] ** 2)
                            for i in range(len(blurs))])
    else:
        raise ValueError(par.detector_type)
    return blur_stack, resp, sigmas, next_first


def _maxpool3(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, min) over the 3x3x3 neighborhood of a [L,H,W] stack; the
    shifts wrap around like jnp.roll."""
    mx = x
    mn = x
    for axis in (-1, -2, -3):
        mx = torch.maximum(torch.maximum(torch.roll(mx, 1, axis),
                                         torch.roll(mx, -1, axis)), mx)
        mn = torch.minimum(torch.minimum(torch.roll(mn, 1, axis),
                                         torch.roll(mn, -1, axis)), mn)
    return mx, mn


def thresholds(par: PyramidParams) -> Tuple[float, float, float]:
    """(pos_th, edge_th, final_th), as Python floats: find_extrema's
    extremum threshold (0.8 * threshold under FixedTh, else 0), localize's
    edge test and its final response threshold (threshold squared for
    Hessian, threshold for DoG and Harris, under FixedTh; else 0)."""
    fixed = par.detector_mode == "FixedTh"
    pos_th = 0.8 * par.threshold if fixed else 0.0
    edge_th = ((par.edgeEigenValueRatio + 1.0) ** 2) / par.edgeEigenValueRatio
    if fixed:
        final_th = par.threshold ** 2 if par.detector_type == "Hessian" else par.threshold
    else:
        final_th = 0.0
    return pos_th, edge_th, final_th


def find_extrema(resp: torch.Tensor, par: PyramidParams, max_cands: int):
    """3x3x3 NMS over middle levels -> candidate list in scan order
    (level, r, c), truncated or zero-padded to k = min(max_cands, size).
    Returns (lev, r, c, valid, n_extrema)."""
    L, H, W = resp.shape
    pos_th, _, _ = thresholds(par)
    mx, mn = _maxpool3(resp)
    mid = resp[1:L - 1]
    is_ext = (((mid > pos_th) & (mid >= mx[1:L - 1])) |
              ((mid < -pos_th) & (mid <= mn[1:L - 1])))
    b = par.border
    ar_h = torch.arange(H, device=resp.device)
    ar_w = torch.arange(W, device=resp.device)
    row_ok = (ar_h >= b) & (ar_h < H - b)
    col_ok = (ar_w >= b) & (ar_w < W - b)
    is_ext = is_ext & row_ok[None, :, None] & col_ok[None, None, :]

    k = min(max_cands, is_ext.numel())
    src = torch.nonzero(is_ext.reshape(-1))[:, 0].to(torch.int32)  # row-major
    n_extrema = src.shape[0]
    idx = torch.zeros(k, dtype=torch.int32, device=resp.device)
    valid = torch.zeros(k, dtype=torch.bool, device=resp.device)
    m = min(k, n_extrema)
    idx[:m] = src[:m]
    valid[:m] = True
    lev = idx // (H * W) + 1
    r = (idx % (H * W)) // W
    c = idx % W
    return lev, r, c, valid, n_extrema


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cramer's-rule 3x3 solve; NaN/inf on singular systems."""
    def det3(M):
        return (M[0, 0] * (M[1, 1] * M[2, 2] - M[1, 2] * M[2, 1])
                - M[0, 1] * (M[1, 0] * M[2, 2] - M[1, 2] * M[2, 0])
                + M[0, 2] * (M[1, 0] * M[2, 1] - M[1, 1] * M[2, 0]))

    def rep(col):
        M = A.clone()
        M[:, col] = b
        return det3(M)
    return torch.stack([rep(0), rep(1), rep(2)]) / det3(A)


def localize(resp: torch.Tensor, blurs: torch.Tensor, lev, r0, c0, cand_valid,
             par: PyramidParams, sigmas: List[float]):
    """Vectorized 5-iteration subpixel localization (pyramid.cpp:281-403).
    Returns (OctaveKeypoints in octave pixels, final r, final c)."""
    L, H, W = resp.shape
    K = r0.shape[0]
    dev = resp.device
    _, edge_th, final_th = thresholds(par)

    flat = resp.reshape(-1)
    offs = torch.tensor([dl * H * W + dr * W + dc
                         for dl in (-1, 0, 1)
                         for dr in (-1, 0, 1)
                         for dc in (-1, 0, 1)], dtype=torch.int64, device=dev)
    base_lev = lev.to(torch.int64) * (H * W)

    def q(dl, dr, dc):
        return (dl + 1) * 9 + (dr + 1) * 3 + (dc + 1)

    r, c = r0, c0
    zf = torch.zeros(K, dtype=torch.float32, device=dev)
    bx, by, bs, val = zf, zf, zf, zf
    alive = cand_valid
    rejected = ~cand_valid
    for it in range(5):
        lin = base_lev + r.to(torch.int64) * W + c.to(torch.int64)
        cu = flat[(lin[:, None] + offs[None, :]).clamp(0, flat.shape[0] - 1)]

        def cur(dr, dc):
            return cu[:, q(0, dr, dc)]

        def low(dr, dc):
            return cu[:, q(-1, dr, dc)]

        def high(dr, dc):
            return cu[:, q(1, dr, dc)]
        c11 = cur(0, 0)
        dxx = cur(0, -1) - 2.0 * c11 + cur(0, 1)
        dyy = cur(-1, 0) - 2.0 * c11 + cur(1, 0)
        dss = low(0, 0) - 2.0 * c11 + high(0, 0)
        dxy = 0.25 * (cur(1, 1) - cur(1, -1) - cur(-1, 1) + cur(-1, -1))
        dxs = 0.25 * (high(0, 1) - high(0, -1) - low(0, 1) + low(0, -1))
        dys = 0.25 * (high(1, 0) - high(-1, 0) - low(1, 0) + low(-1, 0))
        dx = 0.5 * (cur(0, 1) - cur(0, -1))
        dy = 0.5 * (cur(1, 0) - cur(-1, 0))
        ds = 0.5 * (high(0, 0) - low(0, 0))
        edge_score = (dxx + dyy) ** 2 / (dxx * dyy - dxy * dxy)
        edge_bad = ((edge_score >= edge_th) | (edge_score < 0)) if it == 0 \
            else torch.zeros_like(alive)
        det = (dxx * (dyy * dss - dys * dys)
               - dxy * (dxy * dss - dys * dxs)
               + dxs * (dxy * dys - dyy * dxs))
        nbx = (-(dx * (dyy * dss - dys * dys)
                 - dxy * (dy * dss - dys * ds)
                 + dxs * (dy * dys - dyy * ds)) / det)
        nby = (-(dxx * (dy * dss - dys * ds)
                 - dx * (dxy * dss - dxs * dys)
                 + dxs * (dxy * ds - dxs * dy)) / det)
        nbs = (-(dxx * (dyy * ds - dy * dys)
                 - dxy * (dxy * ds - dy * dxs)
                 + dx * (dxy * dys - dyy * dxs)) / det)
        nan_bad = ~(torch.isfinite(nbx) & torch.isfinite(nby) & torch.isfinite(nbs))
        val_new = c11 + 0.5 * (dx * nbx + dy * nby + ds * nbs)
        move_px = nbx > 0.6
        move_mx = nbx < -0.6
        move_py = nby > 0.6
        move_my = nby < -0.6
        oob = ((move_px & (c >= W - 3)) | (move_mx & (c <= 3)) |
               (move_py & (r >= H - 3)) | (move_my & (r <= 3)))
        nc = c + move_px.to(torch.int32) - move_mx.to(torch.int32)
        nr = r + move_py.to(torch.int32) - move_my.to(torch.int32)
        converged = (nr == r) & (nc == c)
        bad = edge_bad | nan_bad | oob
        upd = alive & ~bad
        r = torch.where(upd, nr, r)
        c = torch.where(upd, nc, c)
        bx = torch.where(upd, nbx, bx)
        by = torch.where(upd, nby, by)
        bs = torch.where(upd, nbs, bs)
        val = torch.where(upd, val_new, val)
        rejected = rejected | (alive & bad)
        alive = alive & ~bad & ~converged
    b = torch.stack([bx, by, bs], dim=-1)
    ok = ((~rejected)
          & (b.abs().amax(dim=-1) <= 1.5)
          & (val.abs() >= final_th))
    sig = torch.tensor(sigmas, dtype=torch.float32, device=dev)
    scale = sig[lev.long()] * torch.exp2(b[:, 2] / par.numberOfScales)
    rc = torch.stack([r.to(torch.float32) + b[:, 1],
                      c.to(torch.float32) + b[:, 0]], dim=-1)
    return OctaveKeypoints(rc=rc, level=lev, scale=scale, response=val,
                           valid=ok), r, c


def dedup_octave_map(r: torch.Tensor, c: torch.Tensor, valid: torch.Tensor,
                     W: int) -> torch.Tensor:
    """octaveMap dedup: the first accepted candidate in scan order claims
    its integer cell (pyramid.cpp:387-391)."""
    n = r.shape[0]
    cell = r.to(torch.int64) * W + c.to(torch.int64)
    order = torch.arange(n, dtype=torch.int64, device=r.device)
    key = torch.where(valid, cell, -1 - order)   # invalid get unique keys
    sk, perm = torch.sort(key, stable=True)
    first_of_run = torch.ones(n, dtype=torch.bool, device=r.device)
    first_of_run[1:] = sk[1:] != sk[:-1]
    keep = torch.zeros(n, dtype=torch.bool, device=r.device)
    keep[perm] = first_of_run
    return valid & keep
