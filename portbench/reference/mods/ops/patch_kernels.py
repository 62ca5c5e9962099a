# Frozen copy of mods_tpu_torch/ops/patch_kernels.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""Patch resampling and Baumberg: the plain PyTorch versions of the port's
four CUDA kernels (csrc/patch_kernels.cu), which are the counterparts of
the Pallas kernels of the JAX package's ops/pallas_patch.py.

| function         | replaces (pallas_patch.py)              | port's CUDA entry |
| ---------------- | --------------------------------------- | ----------------- |
| dma_baumberg     | dma_baumberg / _dma_baumberg_kernel     | baumberg_pyr      |
| dma_hat_resample | dma_hat_resample / _dma_resample_kernel | resample_pyr      |
| baumberg_windows | baumberg_pallas / _baumberg_kernel      | baumberg_win      |
| hat_resample     | hat_resample / _resample_kernel         | resample_win      |

In this frozen copy each function is its plain version, on the CPU and
on the card alike: the reference builds and launches no kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

DMA_WIN_Y = 112
DMA_WIN_X = 256


# --------------------------------------------------------------------------- #
# Window origins
# --------------------------------------------------------------------------- #
def dma_window_origins(cx, cy, lw, lh):
    """Aligned (8, 128) window origins covering (cx, cy) +- 52 px, clipped
    to the level extent (lw, lh); floor division as in the JAX package."""
    oy = torch.div(torch.floor(cy).to(torch.int32) - 52, 8,
                   rounding_mode="floor") * 8
    ox = torch.div(torch.floor(cx).to(torch.int32) - 52, 128,
                   rounding_mode="floor") * 128
    oy = torch.minimum(torch.clamp(oy, min=0),
                       torch.clamp(lh - DMA_WIN_Y, min=0).to(torch.int32))
    ox = torch.minimum(torch.clamp(ox, min=0),
                       torch.clamp(lw - DMA_WIN_X, min=0).to(torch.int32))
    return oy, ox


# --------------------------------------------------------------------------- #
# Plain versions
# --------------------------------------------------------------------------- #
def _pyr_fetch(stack, lev, oy, ox):
    lev, oy, ox = lev.long()[:, None], oy.long()[:, None], ox.long()[:, None]
    return lambda yi, xi: stack[lev, oy + yi, ox + xi]


def _win_fetch(wins):
    k = torch.arange(wins.shape[0], device=wins.device)[:, None]
    return lambda yi, xi: wins[k, yi, xi]


def _footprint(px, py, ox, oy, lw, lh, WY: int, WX: int):
    """Which window-local [n, S] positions are sampled (inside the level
    and the window: the test of pallas_patch.py:88-90, 425-428), their
    floors, and the top-left taps, clamped into the window for rejected
    samples so that a gather stays in bounds."""
    gx = px + ox[:, None]
    gy = py + oy[:, None]
    inb = ((gx >= 0.0) & (gy >= 0.0) &
           (torch.floor(gx) < lw[:, None] - 1.0) &
           (torch.floor(gy) < lh[:, None] - 1.0) &
           (px >= 0.0) & (py >= 0.0) & (px < WX - 1.0) & (py < WY - 1.0))
    fx0 = torch.floor(px)
    fy0 = torch.floor(py)
    x0 = torch.nan_to_num(fx0, nan=0.0).clamp(0, WX - 2).long()
    y0 = torch.nan_to_num(fy0, nan=0.0).clamp(0, WY - 2).long()
    return inb, fx0, fy0, x0, y0


def _sample(fetch, px, py, ox, oy, lw, lh, WY: int, WX: int, x_first: bool):
    """Exact 4-tap bilinear at window-local [n, S] positions, zero where
    `_footprint` rejects the sample."""
    inb, fx0, fy0, x0, y0 = _footprint(px, py, ox, oy, lw, lh, WY, WX)
    wx0 = 1.0 - torch.abs(px - fx0)
    wx1 = 1.0 - torch.abs(px - (fx0 + 1.0))
    wy0 = 1.0 - torch.abs(py - fy0)
    wy1 = 1.0 - torch.abs(py - (fy0 + 1.0))
    v00, v01 = fetch(y0, x0), fetch(y0, x0 + 1)
    v10, v11 = fetch(y0 + 1, x0), fetch(y0 + 1, x0 + 1)
    if x_first:
        val = (wx0 * v00 + wx1 * v01) * wy0 + (wx0 * v10 + wx1 * v11) * wy1
    else:
        val = (wy0 * v00 + wy1 * v10) * wx0 + (wy0 * v01 + wy1 * v11) * wx1
    return torch.where(inb, val, 0.0)


def _grid(P: int, device):
    c = float(P // 2)
    f = torch.arange(P * P, device=device)
    jg = (f // P).to(torch.float32) - c      # row (y)
    ig = (f % P).to(torch.float32) - c       # col (x)
    return ig[None, :], jg[None, :]


def _plain_resample(fetch, params, P: int, WY: int, WX: int, x_first: bool):
    ig, jg = _grid(P, params.device)
    pr = params
    px = pr[:, 0:1] + ig * pr[:, 2:3] + jg * pr[:, 3:4]
    py = pr[:, 1:2] + ig * pr[:, 4:5] + jg * pr[:, 5:6]
    out = _sample(fetch, px, py, pr[:, 6], pr[:, 7], pr[:, 8], pr[:, 9],
                  WY, WX, x_first)
    return out.reshape(-1, P, P)


def dma_hat_resample(pyr, lev, oy, ox, params, P: int):
    """pyr [L,H,W] + per-keypoint level / aligned window origin (oy, ox)
    + params [n, 10 or 11] (cxl cyl a00 a01 a10 a11 ox oy lw lh [live])
    -> patches [n, P, P].  Replaces pallas_patch.dma_hat_resample."""
    out = _plain_resample(_pyr_fetch(pyr, lev, oy, ox), params, P,
                          DMA_WIN_Y, DMA_WIN_X, True)
    if params.shape[1] > 10:
        out = torch.where((params[:, 10] > 0.5)[:, None, None], out, 0.0)
    return out


def hat_resample(wins, params, P: int):
    """wins [n, W, W] + params [n, >=10] -> patches [n, P, P].
    Replaces pallas_patch.hat_resample."""
    W = wins.shape[-1]
    return _plain_resample(_win_fetch(wins), params, P, W, W, False)


def _plain_baumberg(fetch, params, mask, ws: int, max_iter: int, conv: float,
                    WY: int, WX: int, x_first: bool):
    """The Baumberg SMM iteration of pallas_patch.py:204-275, vectorized
    over keypoints with per-keypoint done masks."""
    # imported here: detect/affine_shape.py imports this module
    from ..detect.affine_shape import eigenvalues_2x2, inv_sqrt_2x2
    n = params.shape[0]
    dev = params.device
    ig, jg = _grid(ws, dev)
    n_mask = float(ws * ws)
    m = mask.reshape(1, ws, ws)
    cxl, cyl, ratio = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    ox, oy, lw, lh = params[:, 4], params[:, 5], params[:, 6], params[:, 7]
    one = torch.ones(n, device=dev)
    zero = torch.zeros(n, device=dev)
    u11, u12, u21, u22 = one, zero, zero, one
    o11, o12, o21, o22 = one, zero, zero, one
    ratio_bef = zero
    done = ~(params[:, 3] > 0.5)
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        a00 = u11[:, None] * ratio
        a01 = u12[:, None] * ratio
        a10 = u21[:, None] * ratio
        a11 = u22[:, None] * ratio
        px = cxl + ig * a00 + jg * a01
        py = cyl + ig * a10 + jg * a11
        img = _sample(fetch, px, py, ox, oy, lw, lh, WY, WX,
                      x_first).reshape(n, ws, ws)
        gx = torch.cat([img[:, :, 1:2] - img[:, :, 0:1],
                        img[:, :, 2:] - img[:, :, :-2],
                        img[:, :, -1:] - img[:, :, -2:-1]], dim=2)
        gy = torch.cat([img[:, 1:2, :] - img[:, 0:1, :],
                        img[:, 2:, :] - img[:, :-2, :],
                        img[:, -1:, :] - img[:, -2:-1, :]], dim=1)
        a = (gx * gx * m).sum(dim=(1, 2)) / n_mask
        b = (gx * gy * m).sum(dim=(1, 2)) / n_mask
        cc = (gy * gy * m).sum(dim=(1, 2)) / n_mask
        na, nb, nc, l1, l2 = inv_sqrt_2x2(a, b, cc)
        nan_bad = ~(torch.isfinite(na) & torch.isfinite(nb) & torch.isfinite(nc))
        ratio_act = 1.0 - l2 / l1
        v11 = na * u11 + nb * u21
        v12 = na * u12 + nb * u22
        v21 = nb * u11 + nc * u21
        v22 = nb * u12 + nc * u22
        eok, e1, e2 = eigenvalues_2x2(v11, v12, v21, v22)
        aniso_bad = (~eok) | (e1 / e2 > 6.0) | (e2 / e1 > 6.0)
        converged = (ratio_act < conv) & (ratio_bef < conv)
        accept_now = (~done) & (~nan_bad) & (~aniso_bad) & converged
        reject_now = (~done) & (nan_bad | aniso_bad)
        o11 = torch.where(accept_now, v11, o11)
        o12 = torch.where(accept_now, v12, o12)
        o21 = torch.where(accept_now, v21, o21)
        o22 = torch.where(accept_now, v22, o22)
        ok = ok | accept_now
        u11 = torch.where(done, u11, v11)
        u12 = torch.where(done, u12, v12)
        u21 = torch.where(done, u21, v21)
        u22 = torch.where(done, u22, v22)
        ratio_bef = torch.where(done, ratio_bef, ratio_act)
        done = done | accept_now | reject_now
    U = torch.stack([o11, o12, o21, o22], dim=-1).reshape(n, 2, 2)
    return U, ok


def dma_baumberg(stack, lev, oy, ox, params, mask, ws: int, max_iter: int,
                 conv: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """stack [L,H,W] + per-keypoint level / aligned origin + params [n, 8]
    (cxl cyl ratio valid ox oy lw lh) + mask [ws, ws] -> (U [n,2,2], ok [n]).
    Replaces pallas_patch.dma_baumberg."""
    return _plain_baumberg(_pyr_fetch(stack, lev, oy, ox), params, mask, ws,
                           max_iter, conv, DMA_WIN_Y, DMA_WIN_X, True)


def baumberg_windows(wins, params, mask, ws: int, max_iter: int,
                     conv: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """wins [n, W, W] + params [n, 8] + mask [ws, ws] -> (U, ok).
    Replaces pallas_patch.baumberg_pallas."""
    W = wins.shape[-1]
    return _plain_baumberg(_win_fetch(wins), params, mask, ws, max_iter, conv,
                           W, W, False)
