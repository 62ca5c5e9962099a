"""Per-stage counts of the deep extraction of an image pair: detected,
kept by AffNet, inside after reprojection, oriented by OriNet, clear of
the border, described by HardNet.  Splits "too few regions" from "weak
descriptors".

    python -m mods_tpu_torch.tools.diag_deep --img1 IMG1 --img2 IMG2
        [--config config.ini] [--iters iters.ini] [--device cuda|cpu]

Without --config: testing.deep_config() (tools/common.py); AffNet and
OriNet load their default weights, or run at seeded random weights under
MODS_TPU_ALLOW_RANDOM_CNN.  The reference's deep run of graf1 / graf6
(its README.md:60-61) reads 3731 regions / 3358 descriptors and 4527 /
4118.  --device defaults to the CUDA card; without one only --device cpu
runs.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict

import numpy as np
import torch

from .. import full_float32, resolve_device
from ..config import Config
from ..desc.cnn import affnet_adapt, hardnet_describe, orinet_orient
from ..detect.detector import detect_keypoints
from ..ops.image import as_image
from ..ops.patches import K_SIGMA
from ..pipeline import reproject_keypoints
from . import common


def deep_frames(img: torch.Tensor, cfg: Config):
    """The deep extraction's frames of one [H,W] image up to description:
    (AffNet + OriNet keypoints, valid where they clear the border; their
    reprojection; the keypoints left after each stage)."""
    h, w = img.shape
    eye = np.eye(3)
    kp = detect_keypoints(img, cfg.hessian, max_kp=cfg.max_keypoints,
                          max_octave_cands=cfg.max_octave_cands)
    n = dict(detected=int(kp.valid.sum()))
    kp = affnet_adapt(img, kp, cfg)
    n["affnet_ok"] = int(kp.valid.sum())
    rep = reproject_keypoints(kp, eye, w, h, cfg.rootsift.PEParam.mrSize + 0.01,
                              dont_remove=True)
    n["reproj_ok"] = int(rep.valid.sum())
    kp = orinet_orient(img, kp.with_valid(rep.valid), cfg)
    n["orinet"] = int(kp.valid.sum())
    rep = reproject_keypoints(kp, eye, w, h, K_SIGMA, dont_remove=False)
    n["border_ok"] = int(rep.valid.sum())
    return kp.with_valid(rep.valid), rep, n


@full_float32()
def stage_counts(img: torch.Tensor, cfg: Config) -> Dict[str, int]:
    """The keypoints left after each stage of the deep extraction of one
    [H,W] image on its device, HardNet's descriptors last."""
    kp, _, n = deep_frames(img, cfg)
    desc = hardnet_describe(img, kp, cfg)
    n["described"] = int((desc.abs().sum(dim=1) > 0).sum())
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_inputs(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = common.tool_config(args, deep=True)
    img1, img2 = common.load_pair(args)
    py = cfg.hessian.pyramid
    print("cfg.max_keypoints =", cfg.max_keypoints,
          "max_octave_cands =", cfg.max_octave_cands)
    print("hessian threshold =", py.threshold, "mode =", py.detector_mode,
          "regionsNumber =", py.reg_number)
    print("hessian.affine.useZMQ =", cfg.hessian.affine.useZMQ)
    print("domori.useZMQ =", cfg.domori.useZMQ)
    for path, img in ((args.img1, img1), (args.img2, img2)):
        name = os.path.splitext(os.path.basename(path))[0]
        n = stage_counts(as_image(img, dev), cfg)
        print(f"{name}: " + " ".join(f"{k}={v}" for k, v in n.items()))
    print("reference (graf): graf1 3731/3358, graf6 4527/4118")
    return 0


if __name__ == "__main__":
    sys.exit(main())
