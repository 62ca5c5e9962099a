# Frozen copy of mods_tpu_torch/ops/image.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""Batched image primitives (blur, gradients, masks, normalization,
bilinear gathers and warps).

Counterpart of the JAX package's ops/image.py (reference
detectors/helpers.cpp).  Images are float32 [..., H, W], intensities
0..255; coordinates are (x, y) with x = column.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def as_image(img, device: torch.device) -> torch.Tensor:
    """An [H,W] image (numpy array or tensor) as float32 on `device`."""
    return torch.as_tensor(np.asarray(img, np.float32) if not torch.is_tensor(img)
                           else img, dtype=torch.float32).to(device)


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


def double_image(img: torch.Tensor) -> torch.Tensor:
    """reference helpers.cpp:733-765 doubleImage (2x bilinear upsample)."""
    H, W = img.shape[-2], img.shape[-1]
    a = img
    ax = torch.cat([0.5 * (a[..., :, :-1] + a[..., :, 1:]), a[..., :, -1:]], -1)
    ay = torch.cat([0.5 * (a[..., :-1, :] + a[..., 1:, :]), a[..., -1:, :]], -2)
    axy = torch.cat([0.5 * (ax[..., :-1, :] + ax[..., 1:, :]), ax[..., -1:, :]], -2)
    out = torch.empty(img.shape[:-2] + (2 * H, 2 * W), dtype=img.dtype,
                      device=img.device)
    out[..., 0::2, 0::2] = a
    out[..., 0::2, 1::2] = ax
    out[..., 1::2, 0::2] = ay
    out[..., 1::2, 1::2] = axy
    return out


def gaussian_blur_xy(img: torch.Tensor, sigma_x: float, sigma_y: float,
                     min_ksize: int = 3, border: str = "reflect101") -> torch.Tensor:
    """Anisotropic blur for view synthesis (reference
    synth-detection.cpp:488-500): kernel size floor(6 s + 1), forced odd,
    at least 3; cv::GaussianBlur's default border (REFLECT_101)."""
    def ksz(s):
        k = int(math.floor(2.0 * 3.0 * s + 1.0))
        if k % 2 == 0:
            k += 1
        return max(k, min_ksize)
    return _sep_conv(img, gaussian_kernel1d(sigma_x, ksz(sigma_x)),
                     gaussian_kernel1d(sigma_y, ksz(sigma_y)), border)


# --------------------------------------------------------------------------- #
# Bilinear gathers (the reference `interpolate` and cv2's BORDER_CONSTANT).
# The JAX package computes these outside any Pallas kernel, and so does the
# port, on either device.
# --------------------------------------------------------------------------- #
def _patch_grid(cx, cy, A: torch.Tensor, out_h: int, out_w: int):
    """Positions of an out_h x out_w patch centred at (cx, cy) with affine
    A: [..., out_h, out_w] each; pixel (j, i) (both centred) comes from
    (cx + i*a11 + j*a12, cy + i*a21 + j*a22)."""
    dev = A.device
    ii = torch.arange(out_w, dtype=torch.float32, device=dev) - out_w // 2
    jj = torch.arange(out_h, dtype=torch.float32, device=dev) - out_h // 2
    j, i = jj[:, None], ii[None, :]
    a = lambda r, c: A[..., r, c, None, None]
    cx = torch.as_tensor(cx, dtype=torch.float32, device=dev)[..., None, None]
    cy = torch.as_tensor(cy, dtype=torch.float32, device=dev)[..., None, None]
    return cx + i * a(0, 0) + j * a(0, 1), cy + i * a(1, 0) + j * a(1, 1)


def _bilinear(fetch, wx, wy, H: int, W: int):
    """Bilinear value at (wx, wy) from `fetch(y, x)` of the four taps, and
    the reference's in-image test (floor + bounds against W-1 / H-1)."""
    x0 = torch.floor(wx)
    y0 = torch.floor(wy)
    inb = (wx >= 0) & (wy >= 0) & (x0 < W - 1) & (y0 < H - 1)
    x0i = torch.clamp(x0.to(torch.int32), 0, W - 2).long()
    y0i = torch.clamp(y0.to(torch.int32), 0, H - 2).long()
    fx = wx - x0i
    fy = wy - y0i
    v00, v01 = fetch(y0i, x0i), fetch(y0i, x0i + 1)
    v10, v11 = fetch(y0i + 1, x0i), fetch(y0i + 1, x0i + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top), inb


def bilinear_gather(img: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Bilinear lookup at float positions; `fill` where the sample is not
    inside (reference helpers.cpp:598-616: wx, wy >= 0, floor(wx) < W-1,
    floor(wy) < H-1)."""
    H, W = img.shape[-2], img.shape[-1]
    val, inb = _bilinear(lambda y, x: img[y, x], wx, wy, H, W)
    return torch.where(inb, val, fill)


def affine_sample(img: torch.Tensor, cx, cy, A: torch.Tensor,
                  out_h: int, out_w: int) -> torch.Tensor:
    """out_h x out_w patches centred at (cx, cy) [...] with affine A
    [..., 2, 2] -> [..., out_h, out_w]; bilinear, zero outside (reference
    helpers.cpp:551-664 interpolate, boundary branch)."""
    wx, wy = _patch_grid(cx, cy, A, out_h, out_w)
    return bilinear_gather(img, wx, wy)


def affine_sample_level(imgs: torch.Tensor, lev, cx, cy, A: torch.Tensor,
                        out_h: int, out_w: int) -> torch.Tensor:
    """affine_sample from level `lev` [...] of a stacked [L,H,W] pyramid."""
    H, W = imgs.shape[-2], imgs.shape[-1]
    wx, wy = _patch_grid(cx, cy, A, out_h, out_w)
    li = torch.as_tensor(lev, device=imgs.device).long()[..., None, None]
    val, inb = _bilinear(lambda y, x: imgs[li, y, x], wx, wy, H, W)
    return torch.where(inb, val, 0.0)


def bilinear_gather_constant(img: torch.Tensor, wx: torch.Tensor,
                             wy: torch.Tensor, fill: float) -> torch.Tensor:
    """cv2 BORDER_CONSTANT bilinear: taps outside the image read `fill`,
    so positions partly outside blend with it (unlike `bilinear_gather`,
    which zeroes the whole sample)."""
    H, W = img.shape[-2], img.shape[-1]
    x0 = torch.floor(wx).to(torch.int32)
    y0 = torch.floor(wy).to(torch.int32)
    fx = wx - x0
    fy = wy - y0

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
        v = img[torch.clamp(yy, 0, H - 1).long(), torch.clamp(xx, 0, W - 1).long()]
        return torch.where(ok, v, fill)

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = v00 + fx * (v01 - v00)
    bot = v10 + fx * (v11 - v10)
    return top + fy * (bot - top)


def warp_affine(img: torch.Tensor, M: np.ndarray, out_h: int, out_w: int,
                fill: float = 128.0) -> torch.Tensor:
    """cv::warpAffine(INTER_LINEAR, BORDER_CONSTANT): M is the forward 2x3
    map dst = M @ (x, y, 1); sampling inverts it in float64 on the host
    (reference synth-detection.cpp:472-515)."""
    M = np.asarray(M, np.float64).reshape(2, 3)
    Mi = np.linalg.inv(np.vstack([M, [0, 0, 1]]))[:2]
    dev = img.device
    X = torch.arange(out_w, dtype=torch.float32, device=dev)[None, :]
    Y = torch.arange(out_h, dtype=torch.float32, device=dev)[:, None]
    f = lambda v: float(np.float32(v))
    wx = f(Mi[0, 0]) * X + f(Mi[0, 1]) * Y + f(Mi[0, 2])
    wy = f(Mi[1, 0]) * X + f(Mi[1, 1]) * Y + f(Mi[1, 2])
    return bilinear_gather_constant(img, wx, wy, fill=fill)
