"""Two-view matching — the MODS loop.

Counterpart of the JAX package's twoview.py (reference mods.cpp:202-383):
escalation steps, cheapest view synthesis first; each step synthesizes
the views of both images, extracts features from every view, matches all
the features gathered so far per (detector, descriptor) group, filters
duplicates and verifies; the loop stops once a step verifies at least
`minMatches`.  The loop is host Python; every stage inside runs batched
on the device.  Detectors: Hessian-Affine, DoG and Harris-Affine (all
of a step's views through one atlas where the step allows it), MSER (the
host component tree on each view's pixels) and ReadAffs (keypoints from a
file, on the identity view).  Verification: LORANSAC (LO-RANSAC-H),
LORANSACF (DEGENSAC), ORSA, and GR_TRUTH (a ground-truth H beside
LO-RANSAC-H).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import full_float32, resolve_device
from .config import Config, ViewSynthParameters
from .ops import image as imops
from .match.matching import (concat_tentatives, duplicate_filter,
                             match_distance_threshold, match_fginn)
from .detect.mser import detect_mser
from .io.keys import load_affs
from .pipeline import ViewFeatures, extract_view
from .synth.atlas import atlas_eligible, extract_step_atlas
from .synth.vs import generate_synth_view, set_vs_pars
from . import timelog
from .timelog import TimeLog, tracing
from .types import Features, MatchResult, Tentatives, concat_keypoints
from .verify.fundamental import loransac_f
from .verify.homography import Draws, hmatrix_filter, loransac_h
from .verify.orsa import orsa_filter

VER_TYPES = ("LORANSAC", "LORANSACF", "ORSA", "GR_TRUTH")
# the detectors a step may name; the JAX package skips any other (ORB)
DETECTORS = ("HessianAffine", "DoG", "HarrisAffine", "MSER", "ReadAffs")


@dataclass
class ImageRepresentation:
    """Per-image feature store keyed [detector][descriptor] (reference
    imagerepresentation.h:16-68 RegionVectorMap)."""
    name: str = ""
    store: Dict[str, Dict[str, List[Features]]] = field(default_factory=dict)

    def add(self, detector: str, vf: ViewFeatures) -> None:
        d = self.store.setdefault(detector, {})
        d.setdefault("None", []).append(vf.regions)
        for desc, f in vf.by_desc.items():
            d.setdefault(desc, []).append(f)

    def get(self, detector: str, desc: str) -> List[Features]:
        return self.store.get(detector, {}).get(desc, [])

    def n_regions(self) -> int:
        return sum(int(f.count()) for d in self.store.values()
                   for f in d.get("None", []))

    def n_descriptors(self, exclude_none: bool = True) -> int:
        return sum(int(f.count()) for d in self.store.values()
                   for desc, fl in d.items()
                   if not (exclude_none and desc == "None") for f in fl)


@dataclass
class TwoViewResult:
    tentatives: int = 0
    unique_tentatives: int = 0
    inliers: int = 0
    inlier_ratio: float = 0.0
    H: Optional[np.ndarray] = None
    steps_done: int = 0
    regions1: int = 0
    regions2: int = 0
    descriptors1: int = 0
    descriptors2: int = 0
    true_matches_gt: int = 0
    timelog: TimeLog = field(default_factory=TimeLog)
    final: Optional[MatchResult] = None
    rep1: Optional[ImageRepresentation] = None
    rep2: Optional[ImageRepresentation] = None
    # the counts after each step (regions, descriptors, tentatives, unique
    # tentatives, inliers), which the JAX package does not keep; with
    # tracing on also "trace": {"spans": {name: {"host_ms", "device_ms",
    # "calls"}}, "counts": {name: int}}, the step's spans and counters
    # (timelog.py; device_ms None off CUDA)
    per_step: List[Dict] = field(default_factory=list)


def _add_regions(rep: ImageRepresentation, det_name: str, vf: ViewFeatures) -> None:
    """Stores a view set's features; traced, counts its valid regions under
    `detect.regions.<detector>` (untraced, the count is not computed)."""
    rep.add(det_name, vf)
    if timelog.active() is not None:
        timelog.count(f"detect.regions.{det_name}", vf.regions.count())


def _extract_image(img: torch.Tensor, cfg: Config, step, prev_views: Dict,
                   rep: ImageRepresentation, tl: TimeLog) -> None:
    """SynthDetectDescribeKeypoints of one image for one escalation step:
    only the views that earlier steps did not synthesize.  Each detector's
    extraction is the span `Detector.<name>`."""
    for det_name in step.detectors:
        if det_name in DETECTORS:
            with timelog.span(f"Detector.{det_name}"):
                _extract_detector(img, cfg, det_name, step.detectors[det_name],
                                  prev_views, rep, tl)


def _extract_detector(img: torch.Tensor, cfg: Config, det_name: str, sched: Dict,
                      prev_views: Dict, rep: ImageRepresentation, tl: TimeLog) -> None:
    H_img, W_img = img.shape
    dev = img.device
    views, prev_views[det_name] = set_vs_pars(
        sched["scale_set"], sched["tilt_set"], sched["phi"],
        sched["descriptors"], sched["fginn"], sched["dist"],
        sched["init_sigma"], sched["do_blur"],
        prev_views.setdefault(det_name, []))
    # all of the step's views through one atlas (the reference's
    # per-view tasks, imagerepresentation.cpp:692-705)
    if atlas_eligible(cfg, det_name, views, dev):
        regions, by_desc = extract_step_atlas(img, cfg, det_name, views,
                                              W_img, H_img, timelog=tl)
        _add_regions(rep, det_name, ViewFeatures(regions=regions, by_desc=by_desc))
        return
    for i, vp in enumerate(views):
        with tl.phase("SynthTime", dev):
            sv = generate_synth_view(img, vp.tilt, vp.phi, vp.zoom,
                                     vp.InitSigma, vp.doBlur, i)
        keypoints = None
        if det_name == "ReadAffs":
            # keypoints from a file (imagerepresentation.cpp:741-771), in
            # the image's frame: the identity view only
            if abs(vp.tilt - 1.0) > 1e-6 or abs(vp.phi) > 1e-6:
                continue
            fname = cfg.read_affs_fname.replace("{name}", rep.name)
            keypoints = load_affs(fname, device=dev).det
        elif det_name == "MSER":
            # the host component tree on the view's pixels (to the host,
            # the C++ tree, the frames back on the device); its frames go
            # through the same stages as the scale-space detectors'
            with tl.phase("DetectTime", dev), timelog.span("DetectTime.mser"):
                keypoints = detect_mser(sv.pixels, cfg.mser)
        _add_regions(rep, det_name, extract_view(
            sv.pixels, sv.H, W_img, H_img, cfg, det_name, vp.descriptors,
            tilt=sv.tilt, zoom=sv.zoom, timelog=tl, keypoints=keypoints))


def _compact_tentatives(t: Tentatives, cap: Optional[int] = None) -> Tentatives:
    """Valid entries first (stable), cut to the valid count rounded up to a
    power of two (at least 16), so that the O(M^2) duplicate filter runs on
    what is there."""
    order = torch.sort((~t.valid).to(torch.uint8), stable=True).indices
    n = int(t.valid.sum())
    m = 1 << max(4, (max(1, n) - 1).bit_length())
    if cap is not None:
        m = min(m, cap)
    return t.map(lambda x: x[order[:min(m, t.m)]])


def _concat_features(fl: List[Features]) -> Features:
    if len(fl) == 1:
        return fl[0]
    return Features(det=concat_keypoints([f.det for f in fl]),
                    reproj=concat_keypoints([f.reproj for f in fl]),
                    desc=torch.cat([f.desc for f in fl]))


def _is_int(desc: str) -> bool:
    # SIFT-family descriptors are integers 0..255: exact f32 distances
    return desc not in ("ZMQ", "HardNet", "HardNetTPU")


def _match_sets(all_tents: Dict[Tuple[str, ...], Tentatives],
                f1l: List[Features], f2l: List[Features], cfg: Config,
                desc: str, ratio: float, dth: float, fginn_key: Tuple[str, ...],
                dist_key: Tuple[str, ...]) -> None:
    """One matching of the bank (correspondencebank.cpp:245-343): each
    image's feature sets concatenated once, FGINN into
    all_tents[fginn_key] when ratio > 0, then the distance matcher into
    all_tents[dist_key] when dth > 0."""
    if (ratio <= 0 and dth <= 0) or not f1l or not f2l:
        return
    f1, f2 = _concat_features(f1l), _concat_features(f2l)
    if ratio > 0:
        all_tents[fginn_key] = match_fginn(f1, f2, cfg.matching, ratio,
                                           int_exact=_is_int(desc))
    if dth > 0:
        all_tents[dist_key] = match_distance_threshold(f1, f2, cfg.matching, dth)


@full_float32()
def match_images(img1, img2, cfg: Config, H_gt: Optional[np.ndarray] = None,
                 ver_type: str = "LORANSAC",
                 pre_extracted: Optional[Tuple[Features, Features]] = None,
                 device=None, draws: Optional[Draws] = None,
                 generator: Optional[torch.Generator] = None,
                 trace: Optional[bool] = None) -> TwoViewResult:
    """The MODS loop (mods.cpp:202-383) on `device` (CUDA unless the
    caller asks for "cpu").

    img1/img2: float32 [H,W] grayscale in 0..255.
    ver_type: LORANSAC (homography), LORANSACF (DEGENSAC fundamental
    matrix; `H` holds F), ORSA (a-contrario F on img1's width and height;
    `H` holds F) or GR_TRUTH (needs H_gt; without it the step verifies as
    LORANSAC, as in the reference).
    pre_extracted: (features1, features2) that replace extraction; one
    step only (reference read_pre_extracted, mods.cpp:197-229).
    draws / generator: the RANSAC uniforms of every step, under the names
    that `verify.homography.loransac_h`, `verify.fundamental.loransac_f`
    and `verify.orsa.orsa_filter` ask for.
    trace: the tracer (timelog.py) on or off; None: on while a torch
    profiler records.  On, every phase ends in a device synchronize and
    each step's spans and counters land in `per_step[i]["trace"]`; off,
    the phases take host time alone."""
    if ver_type not in VER_TYPES:
        raise ValueError(f"ver_type {ver_type!r}: want one of {VER_TYPES}")
    dev = resolve_device(device)
    res = TwoViewResult()
    tl = res.timelog
    tl.trace = tracing(trace)
    rep1 = ImageRepresentation("img1")
    rep2 = ImageRepresentation("img2")
    prev1: Dict[str, List[ViewSynthParameters]] = {}
    prev2: Dict[str, List[ViewSynthParameters]] = {}
    all_tents: Dict[Tuple[str, ...], Tentatives] = {}

    iters = cfg.iters
    if pre_extracted is not None:
        iters = cfg.iters[:1]
        step0 = iters[0]
        det0 = (step0.separate_detectors[0] if step0.separate_detectors
                else "HessianAffine")
        desc0 = (step0.separate_descriptors[0] if step0.separate_descriptors
                 else "RootSIFT")
        for rep, f in zip((rep1, rep2), pre_extracted):
            f = f.to(dev)
            rep.add(det0, ViewFeatures(regions=f, by_desc={desc0: f}))
    else:
        img1 = imops.as_image(img1, dev)
        img2 = imops.as_image(img2, dev)

    curr_matches = 0
    with tl.recording(dev) as step_trace:
        for si, step in enumerate(iters):
            if curr_matches >= cfg.matching.minMatches:
                break
            res.steps_done = si + 1
            if pre_extracted is None:
                _extract_image(img1, cfg, step, prev1, rep1, tl)
                _extract_image(img2, cfg, step, prev2, rep2, tl)

            with tl.phase("MatchTime", dev):
                # grouped matching: the regions of all group detectors per group
                # descriptor, thresholds from the config-level maps
                # (correspondencebank.cpp:245-285)
                for desc in step.group_descriptors:
                    _match_sets(
                        all_tents,
                        [f for det in step.group_detectors for f in rep1.get(det, desc)],
                        [f for det in step.group_detectors for f in rep2.get(det, desc)],
                        cfg, desc, cfg.matching.FGINNThreshold.get(desc, 0.0),
                        cfg.matching.DistanceThreshold.get(desc, 0.0),
                        ("Group", desc), ("GroupDist", desc))
                # separate matching per (detector, descriptor), thresholds from
                # the step's schedule (correspondencebank.cpp:288-343)
                for det in step.separate_detectors:
                    sched = step.detectors.get(det)
                    if sched is None and pre_extracted is None:
                        continue
                    for desc in step.separate_descriptors:
                        ratio = sched["fginn"].get(desc, 0.0) if sched is not None else 0.8
                        dth = sched["dist"].get(desc, 0.0) if sched is not None else 0.0
                        _match_sets(all_tents, rep1.get(det, desc), rep2.get(det, desc),
                                    cfg, desc, ratio, dth, (det, desc),
                                    (det, desc, "dist"))

            with tl.phase("MiscTime", dev):
                if timelog.active() is not None:
                    # what the concatenation sees of each detector's group
                    # (a group of an earlier step stays in the bank)
                    for key, t in all_tents.items():
                        name = key[0] + "".join(f".{k}" for k in key[2:])
                        timelog.count(f"match.tentatives.{name}", t.count())
                merged = concat_tentatives(list(all_tents.values()))
                res.tentatives = int(merged.count())
                merged = _compact_tentatives(merged)
                if cfg.filtering.doBeforeRANSAC:
                    merged = duplicate_filter(merged, cfg.filtering.duplicateDist,
                                              cfg.filtering.mode)
                res.unique_tentatives = int(merged.count())

            with tl.phase("RANSACTime", dev):
                if ver_type == "LORANSACF":
                    mr = loransac_f(merged, cfg.ransac, draws=draws, generator=generator)
                elif ver_type == "ORSA":
                    mr = orsa_filter(merged, cfg.ransac, img1.shape[1], img1.shape[0],
                                     draws=draws, generator=generator)
                else:
                    mr = loransac_h(merged, cfg.ransac, draws=draws, generator=generator)
                res.inliers = int(mr.n_inliers)
                res.H = mr.H.cpu().numpy()
                res.final = mr
                curr_matches = res.inliers
                if ver_type == "GR_TRUTH" and H_gt is not None:
                    res.true_matches_gt = int(hmatrix_filter(merged, H_gt,
                                                             cfg.ransac).count())
                    if not cfg.matching.RANSACforStopping:
                        curr_matches = res.true_matches_gt
            res.per_step.append(dict(
                regions1=rep1.n_regions(), regions2=rep2.n_regions(),
                descriptors1=rep1.n_descriptors(), descriptors2=rep2.n_descriptors(),
                tentatives=res.tentatives, unique_tentatives=res.unique_tentatives,
                inliers=res.inliers))
            if step_trace is not None:
                res.per_step[-1]["trace"] = step_trace.take_step()

    res.inlier_ratio = (res.inliers / res.unique_tentatives
                        if res.unique_tentatives else 0.0)
    last = res.per_step[-1] if res.per_step else {}
    res.regions1 = last.get("regions1", 0)
    res.regions2 = last.get("regions2", 0)
    res.descriptors1 = last.get("descriptors1", 0)
    res.descriptors2 = last.get("descriptors2", 0)
    res.rep1 = rep1
    res.rep2 = rep2
    return res
