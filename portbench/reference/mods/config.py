# Frozen copy of mods_tpu_torch/config.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""Typed configuration of the MODS loop: the dataclasses of the port's
config module that the benchmark's configurations set, with the
reference's defaults (io_mods.cpp:101-740, configuration.hpp,
detectors/detectors_parameters.hpp, descriptors_parameters.hpp).  The
INI loaders and the settings of the paths that the harness does not
carry (ReadAffs, the external commands, AffNet and OriNet) are left out.

Precision: everything runs in float32 with TF32 off.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List


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
    # the CNN descriptor (replaces the reference's ZMQ daemon)
    hardnet: CNNParams = field(default_factory=CNNParams)
    # matching / verification
    matching: MatchPars = field(default_factory=MatchPars)
    ransac: RANSACPars = field(default_factory=RANSACPars)
    filtering: DuplicateFilteringParams = field(default_factory=DuplicateFilteringParams)
    # escalation schedule
    iters: List[IterationStep] = field(default_factory=list)
    # misc
    load_color: bool = True
    verbose: bool = False
    # CNN patch sampling path: "auto" = mip engine on TPU, reference
    # slow path elsewhere; "engine" / "reference" force one path
    # (bounds the CPU-vs-TPU numeric divergence explicitly — see
    # tests/test_patch_engine.py::test_engine_vs_reference_tolerance)
    patch_source: str = "auto"
    # anti-alias strategy of the descriptor resampler:
    #   "topup"  — one level (matched to the least-stretched axis) plus
    #              a per-keypoint patch-space top-up blur solved for the
    #              most-stretched axis: reproduces the reference's
    #              normalized-frame 1.5k blur (anisotropic in image
    #              space) to O((lmin/lmax)^2)
    #   "blend"  — trilinear two-level blend (isotropic image-space AA)
    #   "single" — nearest level only (fastest, larger AA error)
    mip_aa: str = "topup"
    # padding caps for fixed-shape device code
    max_keypoints: int = 8192        # per (detector, view)
    max_octave_cands: int = 8192     # candidate extrema per octave
