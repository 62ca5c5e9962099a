"""Per-view extraction: detect -> reproject -> orient -> describe.

Counterpart of the JAX package's pipeline.py (reference
ImageRepresentation::SynthDetectDescribeKeypoints,
imagerepresentation.cpp:686-1104) for the Hessian-Affine detector with
Baumberg or AffNet, the histogram orientation or OriNet, and the SIFT
family and HardNet (the CNN stages in desc/cnn.py).  The control flow is
host Python; every stage runs batched on padded tensors on the image's
device.  Patches come from the mip patch engine (ops/patch_engine.py, the
resample kernels on the card) or from the reference's two-stage sampler
(ops/patches.py), as `Config.patch_source` says (`_use_engine`).
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .config import Config, DominantOrientationParams, SIFTDescriptorParams
from .desc import cnn
from .desc import sift as siftmod
from .desc.cnn import _use_engine
from .detect import orientation as ori
from .detect.detector import detect_keypoints
from .ops import image as imops
from .ops import patch_engine as pe
from .ops import patches as patchops
from .types import Features, Keypoints, concat_keypoints

K_SIGMA = 2.0 * 3.0 * math.sqrt(3.0)   # synth-detection.cpp:21

SIFT_FAMILY = ("RootSIFT", "SIFT", "HalfRootSIFT", "HalfSIFT")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class TimeLog:
    """Per-phase wall-clock seconds (reference structures.hpp:33-56)."""
    SynthTime: float = 0.0
    DetectTime: float = 0.0
    OrientTime: float = 0.0
    DescTime: float = 0.0
    MatchTime: float = 0.0
    RANSACTime: float = 0.0
    MiscTime: float = 0.0

    def total(self) -> float:
        return (self.SynthTime + self.DetectTime + self.OrientTime +
                self.DescTime + self.MatchTime + self.RANSACTime + self.MiscTime)

    @contextlib.contextmanager
    def phase(self, name: str, device):
        """Adds the wall time of the block to the field `name`, after the
        device has finished the block's work; the block is a profiler span
        of that name."""
        with record_function(name):
            t0 = time.perf_counter()
            yield
            _sync(device)
            setattr(self, name, getattr(self, name) + time.perf_counter() - t0)


@dataclass
class ViewFeatures:
    """Features of one synthesized view, keyed by descriptor; `regions` is
    the reference's map["None"] (the set without descriptors)."""
    regions: Features
    by_desc: Dict[str, Features] = field(default_factory=dict)


def _not_ported(what: str, item: int):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A item {item})")


def reproject_keypoints(kp: Keypoints, H: np.ndarray, orig_w: int, orig_h: int,
                        mr_size: float, dont_remove: bool) -> Keypoints:
    """Detection frame -> original frame through H^-1 (its affine part),
    then the centre-inside filter and, unless dont_remove, the border
    filter (reference synth-detection.cpp:151-190)."""
    H = np.asarray(H, np.float64).reshape(3, 3)
    if np.abs(H - np.eye(3)).sum() < 0.01:
        rep = kp
    else:
        Hi = np.linalg.inv(H)
        Hi2 = torch.as_tensor(Hi[:2, :2], dtype=torch.float32, device=kp.xy.device)
        tv = torch.as_tensor(Hi[:2, 2], dtype=torch.float32, device=kp.xy.device)
        rep = Keypoints(kp.xy @ Hi2.T + tv, torch.einsum("ij,njk->nik", Hi2, kp.A),
                        kp.s, kp.response, kp.valid)
    inside = ((rep.xy[:, 0] > 0) & (rep.xy[:, 0] < orig_w) &
              (rep.xy[:, 1] > 0) & (rep.xy[:, 1] < orig_h))
    ok = rep.valid & inside
    if not dont_remove:
        ok = ok & ~imops.interpolate_check_borders(
            orig_w, orig_h, rep.xy[:, 0], rep.xy[:, 1], rep.A,
            mr_size * rep.s, mr_size * rep.s)
    return rep.with_valid(ok)


def _orient_batch(img, kp: Keypoints, mr_size: float, max_angles: int,
                  patch_size: int, th: float, half_sift: bool):
    """Orientation of a padded batch: A rotated per angle [N, max_angles,
    2, 2], the angles' valid mask, and the border test's pass mask."""
    h, w = img.shape
    touch = imops.interpolate_check_borders(w, h, kp.xy[:, 0], kp.xy[:, 1], kp.A,
                                            K_SIGMA * kp.s, K_SIGMA * kp.s)
    ok = kp.valid & ~touch
    patches = ori.orientation_patches(img, kp.xy, kp.A, kp.s, mr_size, patch_size)
    mask = torch.from_numpy(imops.circular_gauss_mask(patch_size, patch_size / 3.0)
                            ).to(img.device)
    hist = ori.orientation_histogram(patches, mask, half_sift)
    angles, aok = ori.dominant_angles(hist, th, max_angles)
    return ori.apply_rotation(kp.A[:, None], angles), aok & ok[:, None], ok


def orient_features(img: torch.Tensor, kp: Keypoints,
                    dom: DominantOrientationParams,
                    half_sift: bool = False) -> Keypoints:
    """DetectOrientation (synth-detection.cpp:1039-1149): one row per
    (keypoint, angle), the angles of a keypoint together."""
    max_angles = dom.maxAngles if dom.maxAngles > 0 else 8
    A_rot, aok, _ = _orient_batch(img, kp, float(dom.PEParam.mrSize), max_angles,
                                  int(dom.PEParam.patchSize), float(dom.threshold),
                                  half_sift)
    return Keypoints(xy=kp.xy.repeat_interleave(max_angles, dim=0),
                     A=A_rot.reshape(-1, 2, 2),
                     s=kp.s.repeat_interleave(max_angles),
                     response=kp.response.repeat_interleave(max_angles),
                     valid=aok.reshape(-1))


def upright_features(img: torch.Tensor, kp: Keypoints,
                     dom: DominantOrientationParams) -> Keypoints:
    """addUpRight: the keypoints as they are, where they pass the border
    check."""
    h, w = img.shape
    touch = imops.interpolate_check_borders(w, h, kp.xy[:, 0], kp.xy[:, 1], kp.A,
                                            K_SIGMA * kp.s, K_SIGMA * kp.s)
    return kp.with_valid(kp.valid & ~touch)


def _describe_sift_engine(pyr, xy, A, s, valid, par: SIFTDescriptorParams,
                          blend: str = "topup") -> torch.Tensor:
    """SIFT-family description through the mip patch engine, with the
    reference's per-keypoint patchImageSize = 2*ceil(s*mrSize)+1 and
    k = patchImageSize/patchSize."""
    ps = par.PEParam.patchSize
    k = (2.0 * torch.ceil(s * par.PEParam.mrSize) + 1.0) / ps
    patches = pe.sample_patches(pyr, xy, A * k[:, None, None], ps, valid=valid,
                                blend=blend)
    if par.PEParam.photoNorm:
        mask = torch.from_numpy(imops.circular_gauss_mask(ps)).to(pyr.device)
        patches = imops.photometric_normalize(patches, mask)
    return torch.where(valid[:, None], siftmod.describe_patches(patches, par), 0.0)


def describe_sift_family(img: torch.Tensor, kp: Keypoints,
                         par: SIFTDescriptorParams,
                         pyr: Optional[torch.Tensor] = None,
                         use_engine: bool = False,
                         blend: str = "topup") -> torch.Tensor:
    """Patches + SIFT/RootSIFT/HalfSIFT (reference DescribeRegions,
    synth-detection.hpp:170-263): [N, D] quantized descriptors, zero rows
    for invalid keypoints.  With use_engine the patches come from the mip
    engine, else from the reference's two-stage sampler."""
    if use_engine and pyr is not None:
        return _describe_sift_engine(pyr, kp.xy, kp.A, kp.s, kp.valid, par,
                                     blend=blend)
    idx = torch.nonzero(kp.valid).flatten()
    patches = patchops.extract_patches_host(
        img, kp.xy[idx], kp.A[idx], kp.s[idx], par.PEParam.mrSize,
        par.PEParam.patchSize, par.PEParam.photoNorm,
        fast=par.PEParam.FastPatchExtraction)
    out = torch.zeros((kp.n, par.dims), device=img.device)
    if idx.numel():
        out[idx] = siftmod.describe_patches(patches, par)
    return out


def extract_view(img_view: torch.Tensor, H: np.ndarray, orig_w: int, orig_h: int,
                 cfg: Config, detector: str, descriptors: List[str],
                 tilt: float = 1.0, zoom: float = 1.0,
                 timelog: Optional[TimeLog] = None,
                 keypoints: Optional[Keypoints] = None) -> ViewFeatures:
    """The per-view pipeline of one detector (reference
    imagerepresentation.cpp:705-1099).  `keypoints` replaces detection."""
    tl = timelog or TimeLog()
    dev = img_view.device
    eng = _use_engine(cfg, dev)
    # the view's mip pyramid (the JAX package's cnn.mip_pyramid), built at
    # its first use and shared by the CNN stages and the descriptors
    pyr_box: List[torch.Tensor] = []

    def view_pyr() -> Optional[torch.Tensor]:
        if not eng:
            return None
        if not pyr_box:
            pyr_box.append(pe.build_mip_pyramid(img_view))
        return pyr_box[0]

    with tl.phase("DetectTime", dev):
        if keypoints is not None:
            kp = keypoints
        else:
            if detector != "HessianAffine":
                raise _not_ported(f"the {detector} detector", 3)
            det_par = cfg.hessian
            if det_par.affine.external_command:
                raise _not_ported("the external affine-shape command", 5)
            kp = detect_keypoints(img_view, det_par, max_kp=cfg.max_keypoints,
                                  max_octave_cands=cfg.max_octave_cands,
                                  tilt=tilt, zoom=zoom)
            # the deep path: AffNet in place of Baumberg
            # (imagerepresentation.cpp:798-855)
            if det_par.affine.useZMQ:
                kp = cnn.affnet_adapt(img_view, kp, cfg, pyr=view_pyr())

    with tl.phase("OrientTime", dev):
        # reproject + centre-inside filter (imagerepresentation.cpp:867)
        mr = cfg.rootsift.PEParam.mrSize + 0.01
        kp_rep = reproject_keypoints(kp, H, orig_w, orig_h, mr, dont_remove=True)
        kp_f = kp.with_valid(kp_rep.valid)
        if cfg.domori.external_command:
            raise _not_ported("the external orientation command", 5)
        if cfg.domori.useZMQ:
            oriented = cnn.orinet_orient(img_view, kp_f, cfg, pyr=view_pyr())
        else:
            oriented = orient_features(img_view, kp_f, cfg.domori, half_sift=False)
        oriented_half = (orient_features(img_view, kp_f, cfg.domori, half_sift=True)
                         if any("Half" in d for d in descriptors) else None)
        upright = (upright_features(img_view, kp_f, cfg.domori)
                   if cfg.domori.addUpRight else None)

    out = ViewFeatures(regions=Features(det=kp_f, reproj=kp_rep,
                                        desc=torch.zeros((kp.n, 1), device=dev)))
    for desc_name in descriptors:
        with tl.phase("DescTime", dev):
            hardnet = desc_name in ("ZMQ", "HardNet", "HardNet++")
            if desc_name == "CLIDescriptor":
                raise _not_ported("the external descriptor command", 5)
            if desc_name not in SIFT_FAMILY and not hardnet:
                raise ValueError(f"unknown descriptor {desc_name}")
            parts = [] if upright is None else [upright]
            parts.append(oriented_half if "Half" in desc_name and oriented_half
                         is not None else oriented)
            kp_desc = parts[0] if len(parts) == 1 else concat_keypoints(parts)
            # second reprojection, with border removal (ReprojectRegions,
            # imagerepresentation.cpp:951; k_sigma extent)
            kp_desc_rep = reproject_keypoints(kp_desc, H, orig_w, orig_h, K_SIGMA,
                                              dont_remove=False)
            kp_desc = kp_desc.with_valid(kp_desc_rep.valid)
            if hardnet:
                desc = cnn.hardnet_describe(img_view, kp_desc, cfg, pyr=view_pyr())
            else:
                par = {"RootSIFT": cfg.rootsift, "SIFT": cfg.sift,
                       "HalfRootSIFT": cfg.halfrootsift,
                       "HalfSIFT": cfg.halfsift}[desc_name]
                desc = describe_sift_family(img_view, kp_desc, par, pyr=view_pyr(),
                                            use_engine=eng, blend=cfg.mip_aa)
            out.by_desc[desc_name] = Features(det=kp_desc, reproj=kp_desc_rep,
                                              desc=desc)
    return out
