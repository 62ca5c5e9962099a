# Frozen copy of mods_tpu_torch/detect/orientation.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""Dominant gradient orientation — batched over keypoints.

Counterpart of the JAX package's detect/orientation.py (reference
synth-detection.cpp:811-929, 1039-1149): 36-bin magnitude-weighted
histogram, 6x circular box smoothing, parabolic peak interpolation, all
peaks >= th*max in ascending-bin order, capped at maxAngles.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops import image as imops

BINS = 36


def orientation_histogram(patches: torch.Tensor, mask: torch.Tensor,
                          half_sift: bool = False) -> torch.Tensor:
    """[N,P,P] patches -> smoothed [N,36] histograms.  Contributions only
    where mask>0 and |grad|>1; the first and last rows are skipped."""
    mag, ori = imops.gradient_mag_ori(patches)
    bin_f = BINS * (ori / math.pi + 1.0) / 2.0
    b = torch.clamp(bin_f.to(torch.int32), 0, BINS)   # bin 36 is dropped
    w = torch.where((mask[None] > 0) & (mag > 1.0), mag * mask[None], 0.0)
    w[:, 0, :] = 0.0
    w[:, -1, :] = 0.0
    bf = b.reshape(b.shape[0], -1)
    wf = w.reshape(w.shape[0], -1)
    bins = torch.arange(BINS, dtype=torch.int32, device=patches.device)
    # bincount as a compare-multiply-reduce, summed in the same order as
    # the JAX package
    hist = (wf[:, :, None] * (bf[:, :, None] == bins[None, None, :])).sum(dim=1)
    for _ in range(6):
        hist = torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)
    if half_sift:
        h = BINS // 2
        hist = torch.cat([hist[:, :h] + hist[:, h:],
                          torch.zeros_like(hist[:, h:])], -1)
    return hist


def dominant_angles(hist: torch.Tensor, max_th: float, max_angles: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Peak detection + parabolic interpolation.  Returns (angles
    [N,max_angles], valid [N,max_angles]): the first max_angles peaks in
    ascending bin order (the reference does not sort peaks by value)."""
    n = hist.shape[0]
    thresh = hist.amax(dim=-1, keepdim=True) * max_th
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    is_peak = (hist >= thresh) & (hist > left) & (hist > right)
    pp = (left - right) / (left - 2.0 * hist + right) / 2.0
    bin_idx = torch.arange(BINS, dtype=torch.float32, device=hist.device)
    angles_all = 2.0 * math.pi * (bin_idx + 0.5 + pp) / BINS - math.pi
    rank = torch.cumsum(is_peak.to(torch.int32), dim=-1) - 1
    take = is_peak & (rank < max_angles)
    idx = torch.where(take, rank, max_angles).long()
    angles = torch.zeros((n, max_angles + 1), device=hist.device)
    ok = torch.zeros((n, max_angles + 1), dtype=torch.bool, device=hist.device)
    # the peaks taken have distinct ranks; everything else lands in the
    # dropped last column
    angles.scatter_(1, idx, torch.where(take, angles_all, 0.0))
    ok.scatter_(1, idx, take)
    return angles[:, :max_angles], ok[:, :max_angles]


def apply_rotation(A: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """A' = A . R with R = [[cos(-a), sin(-a)], [-sin(-a), cos(-a)]]
    (synth-detection.cpp:1102-1109); A [...,2,2], angle [...]."""
    ci = torch.cos(-angle)
    si = torch.sin(-angle)
    a11, a12 = A[..., 0, 0], A[..., 0, 1]
    a21, a22 = A[..., 1, 0], A[..., 1, 1]
    return torch.stack([
        torch.stack([a11 * ci + a12 * -si, a11 * si + a12 * ci], -1),
        torch.stack([a21 * ci + a22 * -si, a21 * si + a22 * ci], -1)], -2)


def orientation_patches(img: torch.Tensor, xy: torch.Tensor, A: torch.Tensor,
                        s: torch.Tensor, mr_size: float, patch_size: int
                        ) -> torch.Tensor:
    """Orientation-estimation patches sampled exactly from the image
    (reference DetectOrientation, synth-detection.cpp:1054-1097):
    patchImageSize = 2*int(mrSize)+1, step A * patchImageSize/patchSize * s."""
    k = float(2 * int(mr_size) + 1) / float(patch_size)
    return imops.affine_sample(img, xy[:, 0], xy[:, 1],
                               A * (k * s)[:, None, None], patch_size, patch_size)
