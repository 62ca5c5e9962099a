"""The deep pipeline's descriptor A/B: HardNet against RootSIFT on the same
AffNet + OriNet frames of an image pair, each matched (FGINN, duplicate
filter, LO-RANSAC-H).  Splits descriptor quality from the pipeline's
geometry.

    python -m mods_tpu_torch.tools.diag_deep_ab --img1 IMG1 --img2 IMG2
        [--config config.ini] [--iters iters.ini] [--device cuda|cpu]

RootSIFT describes the frames at HardNet's mrSize with 41-pixel patches
and matches on the integer distance route; HardNet on the float route.
Without --config: testing.deep_config() (tools/common.py); AffNet and
OriNet load their default weights, or run at seeded random weights under
MODS_TPU_ALLOW_RANDOM_CNN.  Each verification draws from a generator
seeded with cfg.ransac.seed.  --device defaults to the CUDA card; without
one only --device cpu runs.
"""
from __future__ import annotations

import argparse
import copy
import sys
import time

import torch

from .. import full_float32, resolve_device
from ..config import Config
from ..desc.cnn import hardnet_describe
from ..match.matching import duplicate_filter, match_fginn
from ..ops.image import as_image
from ..pipeline import describe_sift_family
from ..types import Features
from ..verify.homography import loransac_h
from . import common
from .diag_deep import deep_frames


@full_float32()
def extract(img: torch.Tensor, cfg: Config):
    """(keypoints, their reprojection, HardNet descriptors, RootSIFT
    descriptors) of the deep extraction of one [H,W] image."""
    kp, rep, _ = deep_frames(img, cfg)
    d_hn = hardnet_describe(img, kp, cfg)
    # RootSIFT on the same frames, measured over HardNet's region
    par = copy.deepcopy(cfg.rootsift)
    par.PEParam.mrSize = cfg.hardnet.mrSize
    par.PEParam.patchSize = 41
    d_rs = describe_sift_family(img, kp, par)
    return kp, rep, d_hn, d_rs


@full_float32()
def match_counts(f1: Features, f2: Features, cfg: Config, int_exact: bool):
    """(tentatives, unique tentatives, inliers) of one descriptor."""
    t = match_fginn(f1, f2, cfg.matching, 0.8, int_exact=int_exact)
    td = duplicate_filter(t, cfg.filtering.duplicateDist, cfg.filtering.mode)
    mr = loransac_h(td, cfg.ransac,
                    generator=common.ransac_generator(cfg, t.xy1.device))
    return int(t.count()), int(td.count()), int(mr.n_inliers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_inputs(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = common.tool_config(args, deep=True)
    img1, img2 = common.load_pair(args)
    t0 = time.time()
    kp1, rep1, hn1, rs1 = extract(as_image(img1, dev), cfg)
    kp2, rep2, hn2, rs2 = extract(as_image(img2, dev), cfg)
    print(f"extract {time.time() - t0:.1f}s  n1={int(kp1.valid.sum())} "
          f"n2={int(kp2.valid.sum())}", flush=True)
    for tag, d1, d2, int_exact in (("HardNet(ours)", hn1, hn2, False),
                                   ("RootSIFT     ", rs1, rs2, True)):
        n_t, n_u, n_i = match_counts(Features(det=kp1, reproj=rep1, desc=d1),
                                     Features(det=kp2, reproj=rep2, desc=d2),
                                     cfg, int_exact)
        print(f"{tag}: tentatives={n_t} unique={n_u} inliers={n_i}", flush=True)
    print("reference deep (graf): 264 tentatives -> 254 unique -> 147 inliers")
    return 0


if __name__ == "__main__":
    sys.exit(main())
