"""The benchmark's plain reference: the MODS loop in plain PyTorch.

`mods/` is a frozen copy of the port's modules on the path that the
configurations drive (mods_tpu_torch: config, types, twoview, pipeline,
synth, detect, ops, desc, match, verify): Hessian-Affine with Baumberg,
the SIFT family and HardNet, FGINN and LO-RANSAC-H.  Relative imports are
kept; the paths that no cell runs (MSER, ReadAffs, DoG, Harris, AffNet,
OriNet, the external commands, DEGENSAC, ORSA, the INI loaders) are left
out, and a later cell that needs one copies it in.  Two changes besides:
`ops/patch_kernels.py` takes the plain PyTorch version of each of the
four CUDA kernels on every device (on the card too), and `full_float32`
reads its precision from `mods.PRECISION`, so that the lower-precision
control can switch TF32 on.  HardNet's weights come from the file that
the configuration names; a missing file raises.  It imports nothing of
mods_tpu_torch, takes nothing that the program made (it builds its own
configuration from the configuration's file and loads HardNet's weights
from the file itself), and runs on the card in plain torch operations
after the program's window has closed."""
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
