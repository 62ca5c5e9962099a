"""Typed configuration for the PyTorch/CUDA MODS port.

A copy of the JAX package's config module (the port imports nothing from
that package), plus `from_dict` / `to_dict` to carry a config across
between the two as the plain nested dict that `dataclasses.asdict` gives.

Mirrors the reference INI schema (reference: io_mods.cpp:101-740,
configuration.hpp, detectors/detectors_parameters.hpp, descriptors_parameters.hpp)
so the reference's ``config_*.ini`` / ``iters_*.ini`` files drive this engine
unchanged.  All defaults below are the reference defaults.

Precision: the port runs everything in float32 with TF32 off.
`Config.patch_precision` (the TPU's single bf16 MXU pass for patch
resampling) has no counterpart here; the field is kept so that configs
round-trip, and the port ignores it.
"""
from __future__ import annotations

import dataclasses
import math
import copy
import re
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


# --------------------------------------------------------------------------- #
# Tolerant INI parser (reference uses inih; files contain `;` comments,
# trailing semicolons and duplicate keys — configparser chokes on them).
# --------------------------------------------------------------------------- #
class IniFile:
    """Parses the reference's INI dialect: `key = value ; comment`."""

    def __init__(self, path: Optional[str] = None, text: Optional[str] = None):
        self.sections: Dict[str, Dict[str, str]] = {}
        self.section_order: List[str] = []
        if path is not None:
            with open(path, "r", errors="replace") as f:
                text = f.read()
        if text is not None:
            self._parse(text)

    def _parse(self, text: str) -> None:
        cur = None
        for raw in text.splitlines():
            line = raw.strip()
            if not line or line.startswith(";") or line.startswith("#"):
                continue
            m = re.match(r"\[(.+?)\]", line)
            if m:
                cur = m.group(1).strip()
                if cur not in self.sections:
                    self.sections[cur] = {}
                    self.section_order.append(cur)
                # content may follow the section header on the same line
                rest = line[m.end():].strip()
                if rest and not rest.startswith(";"):
                    continue
                continue
            if cur is None or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip()
            # strip inline comment (first `;` terminates the value)
            val = val.split(";", 1)[0].strip()
            self.sections[cur][key] = val

    # ---- typed getters (reference: inih/cpp/INIReader + extensions) ---- #
    def get(self, section: str, key: str, default: str = "") -> str:
        return self.sections.get(section, {}).get(key, default)

    def get_int(self, section: str, key: str, default: int = 0) -> int:
        v = self.get(section, key, "")
        try:
            return int(float(v))
        except ValueError:
            return default

    def get_float(self, section: str, key: str, default: float = 0.0) -> float:
        v = self.get(section, key, "")
        try:
            return float(v)
        except ValueError:
            return default

    def get_bool(self, section: str, key: str, default: bool = False) -> bool:
        v = self.get(section, key, "").lower()
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        return default

    def get_float_list(self, section: str, key: str,
                       default: Tuple[float, ...] = ()) -> List[float]:
        v = self.get(section, key, "")
        if not v:
            return list(default)
        out = []
        for tok in v.split(","):
            tok = tok.strip()
            if tok:
                try:
                    out.append(float(tok))
                except ValueError:
                    pass
        return out if out else list(default)

    def get_str_list(self, section: str, key: str,
                     default: Tuple[str, ...] = ()) -> List[str]:
        v = self.get(section, key, "")
        if not v:
            return list(default)
        out = [tok.strip() for tok in v.split(",") if tok.strip()]
        return out if out else list(default)


# --------------------------------------------------------------------------- #
# Parameter dataclasses
# --------------------------------------------------------------------------- #
@dataclass
class PatchExtractionParams:
    """reference: detectors/structures.hpp:76-88"""
    patchSize: int = 41
    mrSize: float = 5.1962
    FastPatchExtraction: bool = False
    photoNorm: bool = True


@dataclass
class PyramidParams:
    """reference: detectors/structures.hpp:114-151"""
    upscaleInputImage: int = 0
    numberOfScales: int = 3
    initialSigma: float = 1.6
    threshold: float = 16.0 / 3.0
    rel_threshold: float = -1.0
    reg_number: int = -1
    rel_reg_number: float = 0.1
    edgeEigenValueRatio: float = 10.0
    border: int = 5
    doOnNormal: int = 1
    detector_mode: str = "FixedTh"   # FixedTh|RelativeTh|FixedRegNumber|RelativeRegNumber|NotLessThanRegions
    detector_type: str = "Hessian"   # Hessian|DoG|Harris
    iiDoGMode: bool = False


@dataclass
class AffineShapeParams:
    """reference: detectors/affinedetectors/affine.h:26-68"""
    maxIterations: int = 16
    convergenceThreshold: float = 0.05
    smmWindowSize: int = 19
    patchSize: int = 41
    initialSigma: float = 1.6
    mrSize: float = 3.0 * math.sqrt(3.0)
    doBaumberg: bool = True
    sampleFromImage: bool = False
    method: str = "SMM"              # SMM | Hessian
    affMeasRegion: float = 0.5
    external_command: str = ""
    useZMQ: bool = False             # in TPU build: use on-device AffNet


@dataclass
class ScaleSpaceDetectorParams:
    pyramid: PyramidParams = field(default_factory=PyramidParams)
    affine: AffineShapeParams = field(default_factory=AffineShapeParams)


@dataclass
class SIFTDescriptorParams:
    """reference: matching/siftdesc.h:32-67"""
    spatialBins: int = 4
    orientationBins: int = 8
    maxBinValue: float = 0.2
    useRootSIFT: bool = False
    doHalfSIFT: bool = False
    doNorm: bool = True
    magnLess: bool = False
    PEParam: PatchExtractionParams = field(default_factory=PatchExtractionParams)

    @property
    def dims(self) -> int:
        d = self.spatialBins * self.spatialBins * self.orientationBins
        return d // 2 if self.doHalfSIFT else d


@dataclass
class DominantOrientationParams:
    """reference: detectors/structures.hpp (DomOriPars) + io_mods.cpp:730-745"""
    maxAngles: int = -1
    threshold: float = 0.8
    addUpRight: bool = False
    halfSIFTMode: bool = False
    useZMQ: bool = False             # in TPU build: use on-device OriNet
    external_command: str = ""
    PEParam: PatchExtractionParams = field(
        default_factory=lambda: PatchExtractionParams(patchSize=19, mrSize=3.0 * math.sqrt(3.0)))


@dataclass
class CNNParams:
    """Replaces reference zmqDescriptorParams (structures.hpp:91-108):
    the CNNs run in-process on the TPU instead of behind a ZMQ daemon."""
    patchSize: int = 32
    mrSize: float = 5.1962
    weights: str = ""                # path to .pth / .npz weights
    batchSize: int = 512


@dataclass
class MatchPars:
    """reference: matching/matching.hpp:97-137"""
    knn: int = 50                    # mods.cpp:47 (const int nn = 50)
    currMatchRatio: float = 0.8
    matchDistanceThreshold: float = 0.0
    contradDist: float = 10.0
    vector_dist: str = "L2"
    vector_matcher: str = "kdtree"   # informational; TPU build uses exact MXU kNN
    kd_trees: int = 4
    knn_checks: int = 128
    maxSteps: int = 4
    minMatches: int = 15
    doBothRANSACgroundTruth: bool = True
    RANSACforStopping: bool = True
    FGINNThreshold: Dict[str, float] = field(default_factory=dict)
    DistanceThreshold: Dict[str, float] = field(default_factory=dict)


@dataclass
class RANSACPars:
    """reference: matching/matching.hpp:139-164"""
    err_threshold: float = 2.0
    confidence: float = 0.99
    max_samples: int = 1_000_000
    localOptimization: int = 1
    errorType: str = "Sampson"       # Sampson | SymmSum | SymmMax
    useF: bool = False
    doSymmCheck: bool = False
    doDegeneracyCheck: bool = True   # DEGENSAC H-degeneracy (exp_ranF.c:959)
    LAFCoef: float = 3.0
    HLAFCoef: float = 10.0
    justMarkOutliers: bool = False
    # TPU-batched RANSAC knobs (no reference equivalent: replaces the
    # sequential adaptive loop of degensac/exp_ranH.c with fixed batches)
    batch_hypotheses: int = 1024
    lo_batch: int = 64
    lo_irls_iters: int = 4
    seed: int = 42


@dataclass
class DuplicateFilteringParams:
    """reference: configuration.hpp (FilteringParams) + io_mods.cpp:665"""
    doBeforeRANSAC: bool = True
    duplicateDist: float = 3.0
    mode: str = "bestFGINN"          # random|bestFGINN|bestDistance|biggerRegion


@dataclass
class ViewSynthParameters:
    """reference: detectors/structures.hpp:196-211"""
    tilt: float = 1.0
    phi: float = 0.0                 # radians
    zoom: float = 1.0
    InitSigma: float = 0.5
    doBlur: bool = True
    descriptors: List[str] = field(default_factory=list)
    FGINNThreshold: Dict[str, float] = field(default_factory=dict)
    DistanceThreshold: Dict[str, float] = field(default_factory=dict)


@dataclass
class IterationStep:
    """One escalation step: per-detector synthesis schedule.
    reference: io_mods.cpp:456-491 (GetIterPars)."""
    detectors: Dict[str, List[ViewSynthParameters]] = field(default_factory=dict)
    # WhatToMatch (reference configuration.hpp):
    separate_detectors: List[str] = field(default_factory=list)
    separate_descriptors: List[str] = field(default_factory=list)
    group_detectors: List[str] = field(default_factory=list)
    group_descriptors: List[str] = field(default_factory=list)


def detector_step(detectors, tilts, phi, descriptor: str = "RootSIFT",
                  group: bool = False):
    """One escalation step that runs each detector of `detectors` on the
    views of `tilts` x `phi` with one descriptor at FGINN 0.8, matched per
    detector (SeparateDetectors) or all together (GroupDetectors; the
    threshold then comes from cfg.matching.FGINNThreshold)."""
    st = IterationStep()
    for det in detectors:
        st.detectors[det] = dict(
            tilt_set=list(tilts), scale_set=[1.0], phi=phi, init_sigma=0.5,
            do_blur=True, descriptors=[descriptor], fginn={descriptor: 0.8},
            dist={descriptor: 0.0})
    if group:
        st.group_detectors = list(detectors)
        st.group_descriptors = [descriptor]
    else:
        st.separate_detectors = list(detectors)
        st.separate_descriptors = [descriptor]
    return st


@dataclass
class MSERParams:
    """reference: detectors_parameters.hpp (ExtremaParams)"""
    max_area: float = 0.01
    min_size: int = 30
    min_margin: float = 10.0
    rel_threshold: float = 0.0001
    reg_number: int = 500
    detector_mode: str = "FixedTh"
    doOnWLD: bool = False
    doOnNormal: bool = True
    PEParam: PatchExtractionParams = field(default_factory=PatchExtractionParams)


@dataclass
class Config:
    """Aggregate config (reference: io_mods.h:15-41 `configs`)."""
    # detectors
    hessian: ScaleSpaceDetectorParams = field(default_factory=ScaleSpaceDetectorParams)
    dog: ScaleSpaceDetectorParams = field(default_factory=ScaleSpaceDetectorParams)
    harris: ScaleSpaceDetectorParams = field(default_factory=ScaleSpaceDetectorParams)
    mser: MSERParams = field(default_factory=MSERParams)
    # descriptors
    rootsift: SIFTDescriptorParams = field(default_factory=lambda: SIFTDescriptorParams(useRootSIFT=True))
    sift: SIFTDescriptorParams = field(default_factory=SIFTDescriptorParams)
    halfrootsift: SIFTDescriptorParams = field(default_factory=lambda: SIFTDescriptorParams(useRootSIFT=True, doHalfSIFT=True))
    halfsift: SIFTDescriptorParams = field(default_factory=lambda: SIFTDescriptorParams(doHalfSIFT=True))
    domori: DominantOrientationParams = field(default_factory=DominantOrientationParams)
    # on-device CNNs (replace reference ZMQ daemons)
    hardnet: CNNParams = field(default_factory=CNNParams)
    affnet: CNNParams = field(default_factory=CNNParams)
    orinet: CNNParams = field(default_factory=CNNParams)
    # matching / verification
    matching: MatchPars = field(default_factory=MatchPars)
    ransac: RANSACPars = field(default_factory=RANSACPars)
    filtering: DuplicateFilteringParams = field(default_factory=DuplicateFilteringParams)
    # escalation schedule
    iters: List[IterationStep] = field(default_factory=list)
    # ReadAffs pseudo-detector (reference ReadAffsFromFileParams,
    # detectors_parameters.hpp:8-13 / imagerepresentation.cpp:741-771):
    # keypoints loaded from file instead of detected.  `{name}` in the
    # path is replaced by the image-representation name (img1/img2).
    read_affs_fname: str = ""
    # external CLI descriptor (reference CLIDescriptorParams,
    # imagerepresentation.cpp:1017-1090): `<runfile> patches.bmp out.txt`
    cli_descriptor_runfile: str = ""
    cli_descriptor_patch_size: int = 41
    cli_descriptor_mr_size: float = 5.1962
    # misc
    load_color: bool = True
    verbose: bool = False
    # CNN patch sampling path: "auto" = mip engine on TPU, reference
    # slow path elsewhere; "engine" / "reference" force one path
    # (bounds the CPU-vs-TPU numeric divergence explicitly — see
    # tests/test_patch_engine.py::test_engine_vs_reference_tolerance)
    patch_source: str = "auto"
    # Pallas resample matmul precision on TPU: DEFAULT = 1 bf16 MXU
    # pass, HIGHEST = 6 passes (tests/test_tpu_precision.py bounds the
    # difference end to end)
    patch_precision: str = "DEFAULT"
    # anti-alias strategy of the descriptor resampler:
    #   "topup"  — one level (matched to the least-stretched axis) plus
    #              a per-keypoint patch-space top-up blur solved for the
    #              most-stretched axis: reproduces the reference's
    #              normalized-frame 1.5k blur (anisotropic in image
    #              space) to O((lmin/lmax)^2)
    #   "blend"  — trilinear two-level blend (isotropic image-space AA)
    #   "single" — nearest level only (fastest, larger AA error)
    mip_aa: str = "topup"
    # jitter-averaged (TTA) HardNet descriptors: average the embeddings
    # of K slightly perturbed frame samplings before quantizing (0/1 =
    # single forward, reference-daemon behavior).  Recall robustness to
    # frame-estimation noise at K extra forwards.
    hardnet_tta: int = 0
    # padding caps for fixed-shape device code
    max_keypoints: int = 8192        # per (detector, view)
    max_octave_cands: int = 8192     # candidate extrema per octave


# --------------------------------------------------------------------------- #
# Loaders from the reference INI format
# --------------------------------------------------------------------------- #
def _load_patch_extraction(ini: IniFile, section: str, p: PatchExtractionParams) -> None:
    p.patchSize = ini.get_int(section, "patchSize", p.patchSize)
    p.mrSize = ini.get_float(section, "mrSize", p.mrSize)
    p.FastPatchExtraction = ini.get_bool(section, "FastPatchExtraction", p.FastPatchExtraction)
    p.photoNorm = ini.get_bool(section, "photoNorm", p.photoNorm)


def _load_scale_space(ini: IniFile, section: str, p: ScaleSpaceDetectorParams) -> None:
    """reference: io_mods.cpp:167-240 (GetHessPars / GetHarrPars / GetDoGPars)"""
    py, af = p.pyramid, p.affine
    py.detector_mode = ini.get(section, "mode", py.detector_mode)
    py.threshold = ini.get_float(section, "threshold", py.threshold)
    py.rel_threshold = ini.get_float(section, "relativeThreshold", py.rel_threshold)
    py.reg_number = ini.get_int(section, "regionsNumber", py.reg_number)
    py.rel_reg_number = ini.get_float(section, "relativeRegionsNumber", py.rel_reg_number)
    py.numberOfScales = ini.get_int(section, "numberOfScales", py.numberOfScales)
    py.initialSigma = ini.get_float(section, "initialSigma", py.initialSigma)
    py.edgeEigenValueRatio = ini.get_float(section, "edgeEigenValueRatio", py.edgeEigenValueRatio)
    py.border = ini.get_int(section, "border", py.border)
    py.upscaleInputImage = ini.get_int(section, "upscaleInputImage", py.upscaleInputImage)
    af.maxIterations = ini.get_int(section, "max_iter", af.maxIterations)
    af.convergenceThreshold = ini.get_float(section, "convergenceThreshold", af.convergenceThreshold)
    af.smmWindowSize = ini.get_int(section, "smmWindowSize", af.smmWindowSize)
    af.patchSize = ini.get_int(section, "patch_size", af.patchSize)
    af.initialSigma = py.initialSigma
    af.doBaumberg = ini.get_bool(section, "doBaumberg", af.doBaumberg)
    af.sampleFromImage = ini.get_bool(section, "sampleFromImage", af.sampleFromImage)
    af.method = ini.get(section, "method", af.method)
    # external CLI affine-shape estimator (io_mods.cpp:133)
    af.external_command = ini.get(section, "external_command", af.external_command)


def load_config(config_path: str, iters_path: Optional[str] = None) -> Config:
    """Load a Config from reference-format INI files.

    reference: io_mods.cpp:558-740 (getCLIparam + Get*Pars per section).
    """
    cfg = Config()
    ini = IniFile(config_path)

    cfg.load_color = ini.get_bool("Computing", "LoadColor", cfg.load_color)
    # ReadAffs pseudo-detector source (io_mods.cpp:162-166 GetReadPars)
    cfg.read_affs_fname = ini.get("ReadAffs", "fname", cfg.read_affs_fname)

    _load_scale_space(ini, "HessianAffine", cfg.hessian)
    cfg.hessian.pyramid.detector_type = "Hessian"
    _load_scale_space(ini, "DoG", cfg.dog)
    cfg.dog.pyramid.detector_type = "DoG"
    _load_scale_space(ini, "HarrisAffine", cfg.harris)
    cfg.harris.pyramid.detector_type = "Harris"

    # AffineAdaptation toggles the deep (AffNet) path (reference io_mods.cpp)
    cfg.hessian.affine.useZMQ = ini.get_bool("AffineAdaptation", "useZMQ", False)
    cfg.affnet.mrSize = ini.get_float("AffNet", "mrSize", cfg.affnet.mrSize)
    cfg.affnet.patchSize = ini.get_int("AffNet", "patchSize", cfg.affnet.patchSize)
    cfg.orinet.mrSize = ini.get_float("OriNet", "mrSize", cfg.orinet.mrSize)
    cfg.orinet.patchSize = ini.get_int("OriNet", "patchSize", cfg.orinet.patchSize)
    cfg.hardnet.mrSize = ini.get_float("zmqDescriptor", "mrSize", cfg.hardnet.mrSize)
    cfg.hardnet.patchSize = ini.get_int("zmqDescriptor", "patchSize", cfg.hardnet.patchSize)

    # MSER
    s = "MSER"
    cfg.mser.max_area = ini.get_float(s, "max_area", cfg.mser.max_area)
    cfg.mser.min_size = ini.get_int(s, "min_size", cfg.mser.min_size)
    cfg.mser.min_margin = ini.get_float(s, "min_margin", cfg.mser.min_margin)
    cfg.mser.detector_mode = ini.get(s, "mode", cfg.mser.detector_mode)
    cfg.mser.reg_number = ini.get_int(s, "regionsNumber", cfg.mser.reg_number)

    # Dominant orientation
    s = "DominantOrientation"
    do = cfg.domori
    do.maxAngles = ini.get_int(s, "maxAngles", do.maxAngles)
    do.threshold = ini.get_float(s, "threshold", do.threshold)
    do.addUpRight = ini.get_bool(s, "addUpright", do.addUpRight)
    do.halfSIFTMode = ini.get_bool(s, "halfSIFTMode", do.halfSIFTMode)
    do.useZMQ = ini.get_bool(s, "useZMQ", do.useZMQ)
    do.PEParam.mrSize = ini.get_float(s, "mrSize", do.PEParam.mrSize)
    do.PEParam.patchSize = ini.get_int(s, "patchSize", do.PEParam.patchSize)
    # external CLI orientation estimator (io_mods.cpp:738)
    do.external_command = ini.get(s, "external_command", do.external_command)

    # descriptors
    for name, dp in (("SIFTDescriptor", cfg.sift), ("SIFTDescriptor", cfg.rootsift),
                     ("SIFTDescriptor", cfg.halfsift), ("SIFTDescriptor", cfg.halfrootsift)):
        dp.spatialBins = ini.get_int(name, "spatialBins", dp.spatialBins)
        dp.orientationBins = ini.get_int(name, "orientationBins", dp.orientationBins)
        dp.maxBinValue = ini.get_float(name, "maxBinValue", dp.maxBinValue)
        _load_patch_extraction(ini, name, dp.PEParam)

    # matching
    s = "Matching"
    m = cfg.matching
    m.contradDist = ini.get_float(s, "contradDist", m.contradDist)
    m.vector_dist = ini.get(s, "vector_dist", m.vector_dist)
    m.vector_matcher = ini.get(s, "vector_matcher", m.vector_matcher)
    m.kd_trees = ini.get_int(s, "kd_trees", m.kd_trees)
    m.knn_checks = ini.get_int(s, "knn_checks", m.knn_checks)
    m.doBothRANSACgroundTruth = ini.get_bool(s, "doBothRANSACgroundTruth", m.doBothRANSACgroundTruth)
    m.RANSACforStopping = ini.get_bool(s, "RANSACforStopping", m.RANSACforStopping)
    # per-descriptor thresholds used by GROUP matching
    # (reference io_mods.cpp:330-334: matchRatio<Desc> / matchDistance<Desc>)
    for dn in ("RootSIFT", "SIFT", "HalfSIFT", "HalfRootSIFT", "ZMQ",
               "HardNet", "ORB"):
        v = ini.get_float(s, "matchRatio" + dn, 0.0)
        if v:
            m.FGINNThreshold[dn] = v
        v = ini.get_float(s, "matchDistance" + dn, 0.0)
        if v:
            m.DistanceThreshold[dn] = v

    # duplicate filtering
    s = "DuplicateFiltering"
    f = cfg.filtering
    f.doBeforeRANSAC = ini.get_bool(s, "doBeforeRANSAC", f.doBeforeRANSAC)
    f.duplicateDist = ini.get_float(s, "duplicateDist", f.duplicateDist)
    f.mode = ini.get(s, "whichCorrespondenceRemains", f.mode)

    # RANSAC
    s = "RANSAC"
    r = cfg.ransac
    r.err_threshold = ini.get_float(s, "err_threshold", r.err_threshold)
    r.confidence = ini.get_float(s, "confidence", r.confidence)
    r.max_samples = ini.get_int(s, "max_samples", r.max_samples)
    r.localOptimization = ini.get_int(s, "localOptimization", r.localOptimization)
    r.errorType = ini.get(s, "ErrorType", r.errorType)
    r.doSymmCheck = ini.get_bool(s, "doSymmCheck", r.doSymmCheck)
    r.LAFCoef = ini.get_float(s, "LAFcoef", r.LAFCoef)
    r.HLAFCoef = ini.get_float(s, "HLAFcoef", r.HLAFCoef)

    cfg.verbose = ini.get_bool("TextOutput", "verbose", cfg.verbose)

    if iters_path is not None:
        cfg.iters, cfg.matching.maxSteps, cfg.matching.minMatches = load_iters(iters_path)
    return cfg


_DETECTOR_NAMES = ("HessianAffine", "DoG", "HarrisAffine", "MSER", "ORB", "ReadAffs")


def load_iters(path: str) -> Tuple[List[IterationStep], int, int]:
    """Parse an iters_*.ini escalation schedule.

    reference: io_mods.cpp:456-491 (GetIterPars) + iters_MODS.ini layout:
    sections `[<Detector><i>]` with TiltSet/ScaleSet/Phi/initSigma/Descriptors/
    FGINNThreshold/DistanceThreshold and `[Matching<i>]` with
    Separate/Group Detectors/Descriptors.
    """
    ini = IniFile(path)
    steps = ini.get_int("Iterations", "Steps", 1)
    min_matches = ini.get_int("Iterations", "minMatches", 15)
    out: List[IterationStep] = []
    for i in range(steps):
        st = IterationStep()
        for det in _DETECTOR_NAMES:
            sec = f"{det}{i}"
            if sec not in ini.sections:
                continue
            tilt_set = ini.get_float_list(sec, "TiltSet", (1.0,))
            scale_set = ini.get_float_list(sec, "ScaleSet", (1.0,))
            phi = ini.get_float(sec, "Phi", 360.0)
            init_sigma = ini.get_float(sec, "initSigma", 0.5)
            do_blur = ini.get_bool(sec, "doBlur", True)
            descs = ini.get_str_list(sec, "Descriptors", ())
            fginn = ini.get_float_list(sec, "FGINNThreshold", (0.8,))
            dth = ini.get_float_list(sec, "DistanceThreshold", (0.0,))
            # broadcast thresholds to the descriptor list length
            while len(fginn) < len(descs):
                fginn.append(fginn[-1] if fginn else 0.8)
            while len(dth) < len(descs):
                dth.append(dth[-1] if dth else 0.0)
            st.detectors[det] = dict(
                tilt_set=tilt_set, scale_set=scale_set, phi=phi,
                init_sigma=init_sigma, do_blur=do_blur, descriptors=descs,
                fginn={d: t for d, t in zip(descs, fginn)},
                dist={d: t for d, t in zip(descs, dth)},
            )  # type: ignore
        msec = f"Matching{i}"
        st.separate_detectors = ini.get_str_list(msec, "SeparateDetectors", ())
        st.separate_descriptors = ini.get_str_list(msec, "SeparateDescriptors", ())
        st.group_detectors = ini.get_str_list(msec, "GroupDetectors", ())
        st.group_descriptors = ini.get_str_list(msec, "GroupDescriptors", ())
        out.append(st)
    return out, steps, min_matches


# --------------------------------------------------------------------------- #
# Plain-dict round trip (e.g. with dataclasses.asdict of the JAX Config)
# --------------------------------------------------------------------------- #
def _build(cls, d: Dict[str, Any]):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v, t = d[f.name], hints[f.name]
        if dataclasses.is_dataclass(t):
            v = _build(t, v)
        elif typing.get_origin(t) is list and typing.get_args(t) \
                and dataclasses.is_dataclass(typing.get_args(t)[0]):
            v = [_build(typing.get_args(t)[0], x) if isinstance(x, dict)
                 else copy.deepcopy(x) for x in v]
        else:
            v = copy.deepcopy(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def from_dict(d: Dict[str, Any]) -> Config:
    """Config from a nested plain dict (`dataclasses.asdict` of a Config
    of this module or of the JAX package's identical schema)."""
    return _build(Config, d)


def to_dict(cfg: Config) -> Dict[str, Any]:
    """Nested plain dict of `cfg`; `from_dict` inverts it."""
    return dataclasses.asdict(cfg)
