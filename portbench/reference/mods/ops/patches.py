# Frozen copy of mods_tpu_torch/ops/patches.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""Descriptor patch extraction — the reference's two-stage anti-aliased
sampler (the `patch_source="reference"` route).

Counterpart of the JAX package's ops/patches.py (reference
synth-detection.hpp:170-263 DescribeRegions and synth-detection.cpp:38-132
ExtractPatchesColumn, slow path):
  mrScale        = ceil(s * mrSize)
  patchImageSize = 2*int(mrScale) + 1            (odd)
  k              = patchImageSize / patchSize
  k <= 0.4 : one interpolation with A*k
  k >  0.4 : a (patchImageSize+2)^2 window at unit spacing, a Gaussian
             blur of sigma 1.5*k, then the centre subsampled at spacing k.
Keypoints go in groups by the window size (BUCKETS), as in the JAX
package, so that each group shares one window size; the port needs no
power-of-two padding of the group sizes, which were static shapes there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import image as imops

K_SIGMA = 2.0 * 3.0 * math.sqrt(3.0)   # synth-detection.cpp:21 (the
#   measurement region's k_sigma, not the LAF check's 3.0)

# window sizes that cover patchImageSize+2
BUCKETS = (32, 48, 64, 96, 128, 192, 288, 416, 608, 1024)


def patch_image_size(s: torch.Tensor, mr_size: float) -> torch.Tensor:
    """int, odd (reference synth-detection.hpp:187-189)."""
    return 2 * torch.ceil(s * mr_size).to(torch.int64) + 1


def _gauss_kernels_per_item(sigma: torch.Tensor, max_r: int) -> torch.Tensor:
    """[N, 2*max_r+1] normalized Gaussian rows, each truncated as OpenCV
    does: ksize = int(6*sigma+1) forced odd (helpers.cpp:726-731)."""
    x = torch.arange(-max_r, max_r + 1, dtype=torch.float32, device=sigma.device)
    w = torch.exp(-(x[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    ks = (6.0 * sigma + 1.0).to(torch.int32)
    ks = ks + (1 - ks % 2)
    r = torch.clamp((ks - 1) // 2, max=max_r)
    w = torch.where(x[None, :].abs() <= r[:, None], w, 0.0)
    return w / w.sum(dim=1, keepdim=True)


def _extract_single_stage(img, xy, scaled_A, patch_size: int) -> torch.Tensor:
    return imops.affine_sample(img, xy[:, 0], xy[:, 1], scaled_A,
                               patch_size, patch_size)


def _extract_two_stage(img, xy, A, k, bucket: int, patch_size: int) -> torch.Tensor:
    """The two-stage sampler on a bucket x bucket window whose centre is
    the keypoint.  Window entries beyond the item's own size read image
    content where the reference reflects its border (the JAX package's
    deliberate deviation, kept)."""
    max_r = max(1, int(math.ceil((6.0 * 1.5 * (bucket / patch_size) + 1.0) / 2)))
    inter = imops.affine_sample(img, xy[:, 0], xy[:, 1], A, bucket, bucket)
    kern = _gauss_kernels_per_item(1.5 * k, max_r)             # [n, K]
    K = 2 * max_r + 1
    # separable per-item blur with numpy-"reflect" borders
    p = inter.index_select(-1, imops._pad_index(bucket, max_r, "reflect", img.device))
    hor = torch.einsum("nyxk,nk->nyx", p.unfold(-1, K, 1), kern)
    p2 = hor.index_select(-2, imops._pad_index(bucket, max_r, "reflect", img.device))
    smoothed = torch.einsum("nxyk,nk->nyx", p2.transpose(1, 2).unfold(-1, K, 1), kern)
    # subsample at spacing k around the window's centre (the keypoint)
    ctr = float(bucket // 2)
    n = xy.shape[0]
    eye = torch.eye(2, device=img.device)
    return imops.affine_sample_level(
        smoothed, torch.arange(n, device=img.device),
        torch.full((n,), ctr, device=img.device),
        torch.full((n,), ctr, device=img.device),
        eye * k[:, None, None], patch_size, patch_size)


def extract_patches_host(img: torch.Tensor, xy: torch.Tensor, A: torch.Tensor,
                         s: torch.Tensor, mr_size: float, patch_size: int,
                         photo_norm: bool, fast: bool = False) -> torch.Tensor:
    """Patches [N, P, P] of dense keypoints (valid rows only), grouped on
    the host by window size."""
    n = xy.shape[0]
    dev = img.device
    out = torch.zeros((n, patch_size, patch_size), device=dev)
    if n == 0:
        return out
    mask = torch.from_numpy(imops.circular_gauss_mask(patch_size)).to(dev)
    norm = (lambda p: imops.photometric_normalize(p, mask)) if photo_norm \
        else (lambda p: p)
    if fast:
        # reference fast path (ExtractPatchesColumn:103-127): one stage,
        # patchImageSize from mrSize alone
        k = float(2 * int(mr_size) + 1) / patch_size
        return norm(_extract_single_stage(img, xy, A * (k * s)[:, None, None],
                                          patch_size))
    pis = patch_image_size(s, mr_size)
    k = pis.to(torch.float32) / patch_size
    single = (k <= 0.4).cpu().numpy()
    if single.any():
        idx = torch.from_numpy(np.nonzero(single)[0]).to(dev)
        out[idx] = norm(_extract_single_stage(
            img, xy[idx], A[idx] * k[idx, None, None], patch_size))
    bucket_of = np.digitize((pis + 2).cpu().numpy(), BUCKETS, right=True)
    for bi, b in enumerate(BUCKETS):
        sel = ~single & (bucket_of == bi)
        if sel.any():
            idx = torch.from_numpy(np.nonzero(sel)[0]).to(dev)
            out[idx] = norm(_extract_two_stage(img, xy[idx], A[idx], k[idx], b,
                                               patch_size))
    return out
