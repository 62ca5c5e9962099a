"""Scale-space detection (Hessian-Affine, DoG, Harris-Affine): the octave
loop, one octave, and the final selection.

Counterpart of the JAX package's detect/detector.py (reference
DetectAffineKeypoints, scale-space-detector.cpp:13-32,
detectPyramidKeypoints, pyramid.cpp:496-529, and prepareKeysForExport,
scale-space-detector.hpp:126-198).  Baumberg always has the kernels'
semantics here: the kernels on the card, their plain versions on the CPU
(the JAX package's TPU route; its CPU route samples exactly instead).
Baumberg's Hessian method samples exactly on either device
(affine_shape.py).  An octave's extrema search, localization and
duplicate map run as CUDA kernels on the card and as the plain chain of
pyramid.py on the CPU (ops/octave_extrema.py).
"""
from __future__ import annotations

import math
from typing import List

import torch

from .. import timelog
from ..config import PyramidParams, ScaleSpaceDetectorParams
from ..ops import image as imops
from ..ops.octave_extrema import octave_extrema
from ..timelog import span
from ..types import Keypoints, concat_keypoints
from . import pyramid as pyr
from .affine_shape import baumberg_batch, rectify_up_is_up


def octave_cap_schedule(max_cands: int, n_octaves: int) -> List[int]:
    """Candidate caps per octave: the area quarters with each octave and so
    do the extrema, so the padded capacity halves (at least 128)."""
    return [max(128, max_cands >> o) for o in range(n_octaves)]


def detect_keypoints(img: torch.Tensor, par: ScaleSpaceDetectorParams,
                     max_kp: int = 8192, max_octave_cands: int = 4096,
                     tilt: float = 1.0, zoom: float = 1.0) -> Keypoints:
    """Multi-octave detection of an [H,W] float32 image in 0..255, sorted
    by |response| and cut to max_kp rows.  tilt/zoom rescale the region
    count of the reg-number modes for a synthesized view
    (scale-space-detector.cpp:20-21)."""
    py = par.pyramid
    reg_number = py.reg_number
    if (tilt > 2.0) or (zoom < 0.5):
        reg_number = int(math.floor(zoom * reg_number / tilt))
    h, w = img.shape[-2], img.shape[-1]
    pixel_distance = 1.0
    if py.upscaleInputImage > 0:        # the first level is the image doubled
        h, w, pixel_distance = 2 * h, 2 * w, 0.5
    # each octave halves the image (floor) until a side is <= 2*border+2
    min_size = 2 * py.border + 2
    n_octaves = 0
    while h > min_size and w > min_size:
        n_octaves, h, w = n_octaves + 1, h // 2, w // 2
    per_octave = []
    first = img
    for o, cap in enumerate(octave_cap_schedule(max_octave_cands, n_octaves)):
        kp, first, _ = _detect_octave(first, par, py.initialSigma,
                                      pixel_distance, cap, from_image=o == 0)
        per_octave.append(kp)
        pixel_distance *= 2.0
    return _select_sort(concat_keypoints(per_octave), max_kp, py.detector_mode,
                        py.threshold, py.rel_threshold, reg_number,
                        py.rel_reg_number, bool(par.affine.doBaumberg))


def _first_level(img: torch.Tensor, py: PyramidParams) -> torch.Tensor:
    """The first octave's first level: the image, doubled if the pyramid
    says so, blurred up to initialSigma."""
    cur_sigma = 0.5
    if py.upscaleInputImage > 0:
        img = imops.double_image(img)
        cur_sigma *= 2.0
    if py.initialSigma > cur_sigma:
        img = imops.gaussian_blur(img, math.sqrt(py.initialSigma ** 2 - cur_sigma ** 2))
    return img


def _detect_octave(first_level: torch.Tensor, par: ScaleSpaceDetectorParams,
                   init_sigma: float, pixel_distance: float, max_cands: int,
                   from_image: bool = False):
    """One octave: responses -> extrema -> localization -> Baumberg.
    from_image: `first_level` is the input image, made the first level
    here, inside the octave's pyramid span.  Traced, the counters
    `detect.octaves` and `detect.octaves.kernel` (the octaves whose
    extrema the CUDA kernels found) each add one.
    Returns (Keypoints in GLOBAL coords, next_first_level, n_extrema)."""
    with span("DetectTime.pyramid"):
        if from_image:
            first_level = _first_level(first_level, par.pyramid)
        blurs, resp, sigmas, next_first = pyr.build_octave(
            first_level, par.pyramid, init_sigma)
    with span("DetectTime.extrema"):
        okp, _, _, valid, n_ext = octave_extrema(resp, par.pyramid, max_cands,
                                                 sigmas)
    if timelog.active() is not None:
        timelog.count("detect.octaves", 1)
        # on the card the wrapper launches the kernels or raises
        timelog.count("detect.octaves.kernel", int(resp.is_cuda))

    # Baumberg on prevBlur (= blurs[level-1]); reference pyramid.cpp:402
    lx = okp.rc[:, 1]
    ly = okp.rc[:, 0]
    ratio = okp.scale / par.affine.initialSigma
    U, ok = baumberg_batch(blurs, okp.level - 1, lx, ly, ratio, valid,
                           par.affine)
    s_glob = okp.scale * pixel_distance
    det = torch.sqrt(torch.abs(U[:, 0, 0] * U[:, 1, 1] - U[:, 0, 1] * U[:, 1, 0]))
    kp = Keypoints(
        xy=torch.stack([lx, ly], -1) * pixel_distance,
        A=rectify_up_is_up(U),
        s=s_glob * det,
        response=okp.response,
        valid=ok,
    )
    return kp, next_first, n_ext


def _select_sort(kp: Keypoints, max_kp: int, mode: str, threshold: float,
                 rel_threshold: float, reg_number: int,
                 rel_reg_number: float, do_baumberg: bool) -> Keypoints:
    """Sort by |response| descending (ties: lower index first, as
    lax.top_k), keep the top max_kp rows, apply the detection-mode cut.
    Rows are selected with an index gather; the JAX package's one-hot
    contraction gives the same rows when they are finite."""
    n = kp.n
    mag = torch.where(kp.valid, kp.response.abs(), -1.0)
    k = min(max_kp, n)
    vals, idx = torch.sort(mag, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    out = Keypoints(xy=kp.xy[idx], A=kp.A[idx], s=kp.s[idx],
                    response=kp.response[idx], valid=vals >= 0.0)
    if mode == "FixedTh":
        return out.sanitize()
    count = out.valid.sum()
    rank = torch.arange(k, device=mag.device)
    if mode == "RelativeTh":
        keep = out.response.abs() >= vals[0] * rel_threshold
    elif mode == "FixedRegNumber":
        keep = rank < (reg_number * 3 if do_baumberg else reg_number)
    elif mode == "RelativeRegNumber":
        keep = rank < torch.floor(rel_reg_number * count).to(torch.int32)
    elif mode == "NotLessThanRegions":
        above = (out.response.abs() >= threshold).sum()
        keep = rank < torch.clamp(above, min=reg_number)
    else:
        keep = torch.ones(k, dtype=torch.bool, device=mag.device)
    out = out.with_valid(out.valid & keep)
    if mode == "FixedRegNumber":
        out = out.with_valid(out.valid & (rank < reg_number))
    return out.sanitize()
