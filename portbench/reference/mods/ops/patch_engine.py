# Frozen copy of mods_tpu_torch/ops/patch_engine.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""The patch engine — affine patch sampling from a mip pyramid.

Counterpart of the JAX package's ops/patch_engine.py, kernel path only:
the level choice, window origins and anti-aliasing stay here in PyTorch,
and the per-sample bilinear work goes to the resample kernels of
ops/patch_kernels.py (the DMA-window kernel on images of at least
112x256, the precropped-window kernel on smaller ones).  The JAX
package's chunking over keypoints was a memory measure for the TPU; the
port samples all keypoints in one call, with the same results.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import image as imops
from . import patch_kernels as pk

WIN = 96          # precropped window size

_LEVEL_SIGMAS = (0.5, 0.8, 0.95, 1.13, 1.35, 1.6, 1.9, 2.26, 2.69, 3.2,
                 3.8, 4.52, 5.38, 6.4, 7.61, 9.05, 10.76, 12.8, 15.22, 18.1)
_LEVEL_SPACING = (1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
                  2, 4, 4, 4, 4, 8, 8, 8, 8, 16)


def build_mip_pyramid(img: torch.Tensor,
                      n_levels: int = len(_LEVEL_SIGMAS)) -> torch.Tensor:
    """[H,W] -> [L,H,W] anti-alias pyramid: level l has blur
    _LEVEL_SIGMAS[l] at spacing _LEVEL_SPACING[l], top-left on a zero
    canvas of the image's size."""
    H, W = img.shape
    levels = [img]
    cur = img
    cur_sigma = _LEVEL_SIGMAS[0]
    for o in range(1, n_levels):
        target = _LEVEL_SIGMAS[o]
        inc = math.sqrt(target ** 2 - cur_sigma ** 2) / _LEVEL_SPACING[o - 1]
        cur = imops.gaussian_blur(cur, inc)
        cur_sigma = target
        if _LEVEL_SPACING[o] > _LEVEL_SPACING[o - 1]:
            cur = imops.half_image(cur)
        if tuple(cur.shape) == (H, W):
            levels.append(cur)
        else:
            canvas = torch.zeros((H, W), dtype=img.dtype, device=img.device)
            canvas[: cur.shape[0], : cur.shape[1]] = cur
            levels.append(canvas)
    return torch.stack(levels)


def _gather_windows(stack: torch.Tensor, lev: torch.Tensor, oy: torch.Tensor,
                    ox: torch.Tensor, win: int) -> torch.Tensor:
    """[n, win, win] windows of `stack` at levels `lev`, origins (oy, ox)."""
    r = torch.arange(win, device=stack.device)
    return stack[lev.long()[:, None, None],
                 oy.long()[:, None, None] + r[None, :, None],
                 ox.long()[:, None, None] + r[None, None, :]].contiguous()


def crop_windows(stack: torch.Tensor, lev: torch.Tensor, xy: torch.Tensor,
                 win: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[L,H,W] stack + per-item level/center -> ([n,win,win], ox, oy) with
    win = min(win, H, W) and origins clipped into the stack."""
    L, H, W = stack.shape
    win = min(win, H, W)
    ox = torch.clamp(torch.floor(xy[:, 0]).to(torch.int32) - win // 2,
                     0, max(W - win, 0))
    oy = torch.clamp(torch.floor(xy[:, 1]).to(torch.int32) - win // 2,
                     0, max(H - win, 0))
    return _gather_windows(stack, lev, oy, ox, win), ox, oy


_AA_MODES = ("topup", "blend", "single")


def sample_patches(pyr: torch.Tensor, xy: torch.Tensor, A: torch.Tensor,
                   out_size: int, mode: str = "antialias",
                   valid: torch.Tensor = None,
                   blend: str = "topup") -> torch.Tensor:
    """Affine patches from a mip pyramid (auto level selection).

    patch[n,p,q] = img(xy[n] + A[n] @ (q-c, p-c)), A in image pixels,
    exact bilinear at the chosen level, zero outside the image.
    mode="antialias" picks the level by blur, with "topup", "blend" or
    "single" anti-aliasing (`blend`); mode="fit" picks the least blurred
    level whose window fits."""
    L, H, W = pyr.shape
    n = xy.shape[0]
    dev = pyr.device
    if blend not in _AA_MODES:
        raise ValueError(f"anti-aliasing mode {blend!r}: want one of "
                         f"{_AA_MODES}")
    if mode not in ("antialias", "fit"):
        raise ValueError(f"mode {mode!r}: want 'antialias' or 'fit'")
    P_s = out_size
    c = P_s // 2
    win = min(WIN, H, W)
    max_extent = (win - 4) / 2.0
    spacing_arr = torch.tensor(_LEVEL_SPACING[:L], dtype=torch.float32, device=dev)
    sigma_arr = torch.tensor(_LEVEL_SIGMAS[:L], dtype=torch.float32, device=dev)

    # singular values of the step matrix A (image px per patch px)
    tr = (A * A).sum(dim=(1, 2))
    dt = torch.abs(A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0])
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * dt * dt, min=0.0))
    lmax = torch.sqrt(torch.clamp((tr + disc) / 2.0, min=1e-12))
    lmin = torch.clamp(dt / lmax, min=1e-6)
    if blend == "topup" and mode == "antialias":
        sig_t = torch.sqrt(_LEVEL_SIGMAS[0] ** 2 + (1.5 * lmin) ** 2)
    else:
        k_iso = torch.sqrt(dt + 1e-12)
        sig_t = torch.sqrt(_LEVEL_SIGMAS[0] ** 2 + (1.5 * k_iso) ** 2)
    live = (torch.ones((n,), device=dev) if valid is None
            else valid.to(torch.float32))

    corn = torch.stack([(A[:, :, 0] + A[:, :, 1]) * c,
                        (A[:, :, 0] - A[:, :, 1]) * c], -1)
    extent = corn.abs().amax(dim=(1, 2)) + 2.0
    fit_bad = extent[:, None] / spacing_arr[None, :] > max_extent      # [n,L]
    if mode == "antialias" and blend == "topup":
        under = sigma_arr[None, :] <= sig_t[:, None] * 1.02
        cost = torch.where(under, sig_t[:, None] - sigma_arr[None, :],
                           10.0 + sigma_arr[None, :] - sig_t[:, None])
    elif mode == "antialias":
        cost = torch.abs(torch.log(sigma_arr[None, :] /
                                   torch.clamp(sig_t, min=_LEVEL_SIGMAS[0])[:, None]))
    else:
        cost = torch.arange(L, dtype=torch.float32, device=dev)[None, :].expand(n, L)
    cost = torch.where(fit_bad, 1e9, cost)
    lev = torch.argmin(cost, dim=1).to(torch.int32)
    if mode == "antialias" and blend == "blend":
        lev2 = torch.clamp(lev + 1, 0, L - 1)
        sig_lo = sigma_arr[lev.long()]
        sig_hi = sigma_arr[lev2.long()]
        tgt = torch.maximum(sig_t, sig_lo)
        wgt = torch.clamp(torch.log(tgt / sig_lo)
                          / torch.clamp(torch.log(sig_hi / sig_lo), min=1e-6),
                          0.0, 1.0)

    def level_sample(lv):
        scale_l = spacing_arr[lv.long()]
        shift_l = (scale_l - 1.0) / 2.0
        lwv = (W / scale_l).to(torch.int32)
        lhv = (H / scale_l).to(torch.int32)
        cx = (xy[:, 0] - shift_l) / scale_l
        cy = (xy[:, 1] - shift_l) / scale_l
        if H >= pk.DMA_WIN_Y and W >= pk.DMA_WIN_X:
            oyd, oxd = pk.dma_window_origins(cx, cy, lwv, lhv)
            params = torch.stack([
                cx - oxd, cy - oyd,
                A[:, 0, 0] / scale_l, A[:, 0, 1] / scale_l,
                A[:, 1, 0] / scale_l, A[:, 1, 1] / scale_l,
                oxd.to(torch.float32), oyd.to(torch.float32),
                lwv.to(torch.float32), lhv.to(torch.float32), live], -1)
            return pk.dma_hat_resample(pyr, lv.contiguous(), oyd.contiguous(),
                                       oxd.contiguous(), params.contiguous(), P_s)
        ox = torch.minimum(torch.clamp(torch.floor(cx).to(torch.int32) - win // 2,
                                       min=0),
                           torch.clamp(lwv - win, min=0))
        oy = torch.minimum(torch.clamp(torch.floor(cy).to(torch.int32) - win // 2,
                                       min=0),
                           torch.clamp(lhv - win, min=0))
        wins = _gather_windows(pyr, lv, oy, ox, win)
        params = torch.stack([
            cx - ox, cy - oy,
            A[:, 0, 0] / scale_l, A[:, 0, 1] / scale_l,
            A[:, 1, 0] / scale_l, A[:, 1, 1] / scale_l,
            ox.to(torch.float32), oy.to(torch.float32),
            lwv.to(torch.float32), lhv.to(torch.float32)], -1)
        return pk.hat_resample(wins, params.contiguous(), P_s)

    out_lo = level_sample(lev)
    if mode == "antialias" and blend == "blend":
        out_hi = level_sample(lev2)
        return ((1.0 - wgt[:, None, None]) * out_lo
                + wgt[:, None, None] * out_hi)
    if mode == "antialias" and blend == "topup":
        # patch-domain isotropic top-up blur solved for the most stretched
        # axis (see the JAX package's sample_patches)
        sig_lev = sigma_arr[lev.long()]
        sp2 = ((1.5 * lmax) ** 2 + _LEVEL_SIGMAS[0] ** 2
               - sig_lev ** 2) / torch.clamp(lmax * lmax, min=1e-12)
        sig_p = torch.sqrt(torch.clamp(sp2, min=1e-6))
        r = torch.arange(P_s, dtype=torch.float32, device=dev)
        D2 = (r[None, :] - r[:, None]) ** 2                      # [P_s,P_s]
        K = torch.exp(-D2[None] / (2.0 * sig_p[:, None, None] ** 2))
        K = torch.where(D2[None] <= 25.0, K, 0.0)                # radius 5
        K = K / torch.clamp(K.sum(-1, keepdim=True), min=1e-12)
        blurred = torch.bmm(K, out_lo)                           # rows (y)
        return torch.bmm(blurred, K.transpose(1, 2))             # cols (x)
    return out_lo
