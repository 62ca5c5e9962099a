"""The benchmark's plain reference: the MODS loop in plain PyTorch.

`mods/` is a frozen copy of the port's modules on the paths that a
configuration file can drive (mods_tpu_torch: config, types, twoview,
pipeline, synth, detect, ops, desc, match, verify): the detectors
Hessian-Affine, DoG (with iiDoG) and Harris-Affine with Baumberg, and
MSER; the gradient orientation; the SIFT family and HardNet; FGINN; and
the verifiers LORANSAC (LO-RANSAC-H) and LORANSACF (DEGENSAC).  Relative
imports are kept.  Left out, as no configuration file can name them:
ORSA, GR_TRUTH, ReadAffs, AffNet and OriNet (their weights are not in the
repository), the external commands, the INI loaders, and the four-card
path.  A schedule types DoG and Harris (`pbcore/portcfg.py`).  Three
changes besides: `ops/patch_kernels.py` takes the plain PyTorch version
of each of the four CUDA kernels on every device (on the card too);
`full_float32` reads its precision from `mods.PRECISION`, so that the
lower-precision control can switch TF32 on; and MSER's host C++ is the
reference's own copy (`native/mser.cpp`), which `mods/detect/mser.py`
builds with g++ at its first call, never at import, into
`.pbcache/reference_build/` of the checkout.  HardNet's weights come from
the file that the configuration names; a missing file raises.  It imports
nothing of mods_tpu_torch, takes nothing that the program made (it builds
its own configuration from the configuration's file and loads HardNet's
weights from the file itself), and runs on the card in plain torch
operations after the program's window has closed."""
from __future__ import annotations

from typing import Dict

from pbcore.portcfg import build_config


def match_pair(img1, img2, spec: Dict, draws, device, tf32: bool = False):
    """The reference's TwoViewResult for one pair, under the configuration
    `spec` (a configs/*.json dict) and the RANSAC draws `draws`.  With tf32
    the matmuls and convolutions run in TF32: the control one precision
    below the configuration's float32."""
    from .mods import PRECISION
    from .mods import config as rcfg
    from .mods.twoview import match_images
    cfg = build_config(rcfg, spec)
    saved = dict(PRECISION)
    if tf32:
        PRECISION.update(matmul="high", cudnn_tf32=True)
    try:
        return match_images(img1, img2, cfg, device=device, draws=draws,
                            ver_type=spec.get("ver_type", "LORANSAC"))
    finally:
        PRECISION.update(saved)
