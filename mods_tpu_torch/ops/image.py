"""Batched image primitives (blur, gradients, masks, normalization).

Counterpart of the JAX package's ops/image.py, restricted to what the
flagship path uses.  Images are float32 [..., H, W], intensities 0..255;
coordinates are (x, y) with x = column.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


# --------------------------------------------------------------------------- #
# Gaussian blur (separable), OpenCV-compatible kernel
# --------------------------------------------------------------------------- #
def gaussian_kernel1d(sigma: float, ksize: Optional[int] = None) -> np.ndarray:
    """OpenCV getGaussianKernel-compatible coefficients (host-side).

    reference: helpers.cpp:717-731 uses cv::GaussianBlur with
    size = int(2*3*sigma+1) forced odd."""
    if ksize is None:
        ksize = int(2.0 * 3.0 * sigma + 1.0)
        if ksize % 2 == 0:
            ksize += 1
        ksize = max(ksize, 1)
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def _pad_index(n: int, r: int, mode: str, device) -> torch.Tensor:
    """Source indices of a 1-D axis of length n padded by r on each side:
    "replicate" repeats the edge, "reflect" mirrors without repeating it
    (numpy's "edge" and "reflect")."""
    i = torch.arange(-r, n + r, device=device)
    if mode == "replicate":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _sep_conv(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray,
              border: str) -> torch.Tensor:
    """Separable 2-D convolution on [..., H, W] as shift-and-add over
    static slices, tap by tap in the same order and float32 rounding as
    the JAX package (no cuDNN convolution)."""
    mode = {"replicate": "replicate", "reflect101": "reflect"}[border]
    rx = (kx.shape[0] - 1) // 2
    ry = (ky.shape[0] - 1) // 2
    H, W = img.shape[-2], img.shape[-1]
    if rx > 0:
        p = img.index_select(-1, _pad_index(W, rx, mode, img.device))
        out = float(kx[0]) * p[..., :, 0:W]
        for i in range(1, kx.shape[0]):
            out = out + float(kx[i]) * p[..., :, i:i + W]
        img = out
    if ry > 0:
        p = img.index_select(-2, _pad_index(H, ry, mode, img.device))
        out = float(ky[0]) * p[..., 0:H, :]
        for i in range(1, ky.shape[0]):
            out = out + float(ky[i]) * p[..., i:i + H, :]
        img = out
    return img


def gaussian_blur(img: torch.Tensor, sigma: float,
                  sigma_y: Optional[float] = None,
                  border: str = "replicate") -> torch.Tensor:
    """Gaussian blur matching reference helpers.cpp:717-731 semantics."""
    if sigma_y is None:
        sigma_y = sigma
    return _sep_conv(img, gaussian_kernel1d(sigma), gaussian_kernel1d(sigma_y),
                     border)


# --------------------------------------------------------------------------- #
# Gradients
# --------------------------------------------------------------------------- #
def compute_gradient(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Un-normalized central differences, one-sided at the borders
    (reference helpers.cpp:779-797; the central difference is NOT
    divided by 2)."""
    left = img[..., :, 1:2] - img[..., :, 0:1]
    right = img[..., :, -1:] - img[..., :, -2:-1]
    mid_x = img[..., :, 2:] - img[..., :, :-2]
    gx = torch.cat([left, mid_x, right], dim=-1)
    top = img[..., 1:2, :] - img[..., 0:1, :]
    bot = img[..., -1:, :] - img[..., -2:-1, :]
    mid_y = img[..., 2:, :] - img[..., :-2, :]
    gy = torch.cat([top, mid_y, bot], dim=-2)
    return gx, gy


def gradient_mag_ori(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradient magnitude + orientation (atan2 of the un-halved
    differences)."""
    gx, gy = compute_gradient(img)
    return torch.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx)


# --------------------------------------------------------------------------- #
# Patch geometry and normalization
# --------------------------------------------------------------------------- #
def interpolate_check_borders(w, h, ofsx, ofsy, A, res_w, res_h):
    """True when the affinely-deformed patch touches the image boundary
    (reference helpers.cpp:524-549 interpolateCheckBorders): the 4
    corners of the (res_w, res_h) patch mapped by A around (ofsx, ofsy)
    against [1, w-2] x [1, h-2]."""
    half_w = torch.ceil(res_w / 2.0)
    half_h = torch.ceil(res_h / 2.0)
    cs = torch.stack([
        torch.stack([-half_w, -half_h], -1),
        torch.stack([-half_w, +half_h], -1),
        torch.stack([+half_w, -half_h], -1),
        torch.stack([+half_w, +half_h], -1),
    ], -2)  # [...,4,2]
    imx = (ofsx[..., None] + cs[..., 0] * A[..., 0, 0, None]
           + cs[..., 1] * A[..., 0, 1, None])
    imy = (ofsy[..., None] + cs[..., 0] * A[..., 1, 0, None]
           + cs[..., 1] * A[..., 1, 1, None])
    bad = ((torch.floor(imx) <= 0) | (torch.floor(imy) <= 0) |
           (torch.ceil(imx) >= (w - 2)) | (torch.ceil(imy) >= (h - 2)))
    return bad.any(dim=-1)


def photometric_normalize(patch: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalize to mean 128 / std 50 under mask, clamp to [0,255]
    (reference helpers.cpp:666-715; no-op when std < 1e-4)."""
    m = (mask > 0).to(patch.dtype)
    gsum = m.sum(dim=(-2, -1), keepdim=True)
    mean = (patch * m).sum(dim=(-2, -1), keepdim=True) / gsum
    var = torch.sqrt(((mean - patch) ** 2 * m).sum(dim=(-2, -1), keepdim=True)
                     / gsum)
    fac = 50.0 / var
    normed = torch.clamp(128.0 + fac * (patch - mean), 0.0, 255.0)
    return torch.where(var < 1e-4, patch, normed)


def circular_gauss_mask(size: int, sigma: float = 0.0) -> np.ndarray:
    """reference helpers.cpp:442-461 computeCircularGaussMask (host)."""
    half = size >> 1
    r2 = float(half * half)
    sigma2 = 0.9 * r2 if sigma == 0 else 2.0 * sigma * sigma
    y, x = np.mgrid[0:size, 0:size]
    disq = (y - half) ** 2 + (x - half) ** 2
    mask = np.where(disq < r2, np.exp(-disq / sigma2), 0.0)
    return mask.astype(np.float32)


def gauss_mask(size: int) -> np.ndarray:
    """reference helpers.cpp:411-440 computeGaussMask: separable Gaussian
    with 3*sigma fit into half size, plus tail folding (host)."""
    half = size >> 1
    scale = half / 3.0
    scale2 = -2.0 * scale * scale
    tmp = np.exp(np.arange(half + 1, dtype=np.float64) ** 2 / scale2)
    end = int(math.ceil(scale * 5.0) - half)
    for i in range(1, end):
        tmp[half - i] += math.exp(((i + half) * (i + half)) / scale2)
    line = np.concatenate([tmp[::-1], tmp[1:]])  # index -half..half
    return np.outer(line, line).astype(np.float32)


# --------------------------------------------------------------------------- #
# Resampling
# --------------------------------------------------------------------------- #
def half_image(img: torch.Tensor) -> torch.Tensor:
    """cv::resize(.., 0.5, INTER_LINEAR) as used by the pyramid
    (reference pyramid.cpp:476) == 2x2 box average."""
    H2, W2 = img.shape[-2] // 2, img.shape[-1] // 2
    img = img[..., : 2 * H2, : 2 * W2]
    r = img.reshape(img.shape[:-2] + (H2, 2, W2, 2))
    return r.mean(dim=(-3, -1))
