# Frozen copy of mods_tpu_torch/desc/sift.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""SIFT / RootSIFT / HalfSIFT descriptors — batched formulation.

Counterpart of the JAX package's desc/sift.py (reference
matching/siftdesc.cpp): the per-pixel trilinear scatter becomes two
matrix products with the exact spatial-bin weight tables, and the
normalization quantizes to uint8 levels with the 512-length norm
(siftdesc.cpp:199-278).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SIFTDescriptorParams
from ..ops import image as imops


def _spatial_weights(patch_size: int, spatial_bins: int) -> np.ndarray:
    """[patch_size, spatial_bins] bilinear spatial-bin weights
    (siftdesc.cpp:22-71 precomputeBinsAndWeights)."""
    half = patch_size >> 1
    step = float(spatial_bins + 1) / (2 * half)
    w = np.zeros((patch_size, spatial_bins), np.float32)
    for i in range(patch_size):
        x = step * i
        xi = int(x)
        b0, b1 = xi - 1, xi
        w1 = x - xi
        w0 = 1.0 - w1
        if b0 < 0 or b0 >= spatial_bins:
            b0, w0 = max(0, min(b0, spatial_bins - 1)), 0.0
        if b1 < 0 or b1 >= spatial_bins:
            b1, w1 = max(0, min(b1, spatial_bins - 1)), 0.0
        w[i, b0] += w0
        w[i, b1] += w1
    return w


def _raw_hist(patches: torch.Tensor, mask: torch.Tensor, roww: torch.Tensor,
              ori_bins: int) -> torch.Tensor:
    """[N,P,P] -> [N, sb, sb, ob] unnormalized histograms."""
    mag, ori = imops.gradient_mag_ori(patches)
    val = mask[None] * mag
    # orientation soft-binning (siftdesc.cpp:97-104): two bins per pixel
    o = ori_bins * (ori + 2.0 * math.pi) / (2.0 * math.pi)
    bo0 = o.to(torch.int32)
    wo1 = o - bo0.to(torch.float32)
    bo0 = torch.remainder(bo0, ori_bins).long()
    bo1 = torch.remainder(bo0 + 1, ori_bins)
    wo0 = 1.0 - wo1
    N, P = patches.shape[0], patches.shape[-1]
    vo = torch.zeros((N, P, P, ori_bins), device=patches.device)
    vo.scatter_(-1, bo0[..., None], (val * wo0)[..., None])
    vo.scatter_(-1, bo1[..., None], (val * wo1)[..., None])
    # desc[n,r,c,o] = sum_pq roww[p,r] roww[q,c] vo[n,p,q,o]
    t = torch.einsum("pr,npqo->nrqo", roww, vo)
    return torch.einsum("qc,nrqo->nrco", roww, t)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _sift_norm(v: torch.Tensor, max_bin: float, root: bool) -> torch.Tensor:
    """L2 -> clip -> conditional renorm -> (RootSIFT: L1 + sqrt) ->
    quantize to 0..255 with the 512-length norm."""
    v = _normalize(v)
    clipped = torch.clamp(v, max=max_bin)
    changed = (v > max_bin).any(dim=-1, keepdim=True)
    v = torch.where(changed, _normalize(clipped), v)
    if root:
        s = v.abs().sum(dim=-1, keepdim=True)
        v = torch.sqrt(v / s)
    q = 512.0 * v + 0.5
    # float -> int truncates; NaN rows (all-zero patches) quantize to 0
    q = torch.nan_to_num(q, nan=0.0).to(torch.int32)
    return torch.clamp(q, 0, 255).to(torch.float32)


def describe_patches(patches: torch.Tensor, par: SIFTDescriptorParams) -> torch.Tensor:
    """[N,P,P] photometrically-normalized patches -> [N,D] descriptors."""
    P = par.PEParam.patchSize
    dev = patches.device
    mask = torch.from_numpy(imops.circular_gauss_mask(P)).to(dev)
    roww = torch.from_numpy(_spatial_weights(P, par.spatialBins)).to(dev)
    d = _raw_hist(patches, mask, roww, par.orientationBins)
    if par.doHalfSIFT:
        # fold orientation bins mod pi (siftdesc.cpp:411-435)
        ob = par.orientationBins
        d = d[..., : ob // 2] + d[..., ob // 2:]
    return _sift_norm(d.reshape(d.shape[0], -1), par.maxBinValue,
                      bool(par.useRootSIFT))
