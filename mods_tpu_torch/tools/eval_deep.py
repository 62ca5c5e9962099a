"""Score HardNet checkpoints on an image pair through the MODS loop with
the deep configuration: one line a checkpoint, which is how a trainer's
checkpoints are chosen.

    python -m mods_tpu_torch.tools.eval_deep [CKPT.npz ...] --img1 IMG1
        --img2 IMG2 [--config config.ini] [--iters iters.ini]
        [--device cuda|cpu]

CKPT defaults to the repository's weights/HardNetPS.npz; the
OUT.s{step}.npz, OUT.best.npz and OUT.last.npz files of
`python -m mods_tpu_torch.tools.train_hardnet` and the JAX package's
trainer load alike (desc/cnn.load_layers).  A checkpoint that does not
exist raises FileNotFoundError.  Without INIs: testing.deep_config()
(AffNet, OriNet, HardNet) and one Hessian-Affine ZMQ step
(tools/common.py); AffNet and OriNet load their default weights, or run
at seeded random weights under MODS_TPU_ALLOW_RANDOM_CNN.  The RANSAC
draws come from a generator seeded with cfg.ransac.seed.  The reference's
deep run of graf1 / graf6 (its README.md:47-64) reads 264 tentatives,
254 unique, 147 inliers.  --device defaults to the CUDA card; without one
only --device cpu runs.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .. import resolve_device
from ..desc.cnn import DEFAULT_WEIGHTS
from ..twoview import match_images
from . import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("weights", nargs="*", default=[str(DEFAULT_WEIGHTS["hardnet"])])
    common.add_inputs(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    img1, img2 = common.load_pair(args)
    for p in args.weights:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        cfg = common.tool_config(args, deep=True)
        cfg.hardnet.weights = p
        t0 = time.time()
        r = match_images(img1, img2, cfg, device=dev,
                         generator=common.ransac_generator(cfg, dev))
        print(f"{os.path.basename(p):24s} tent={r.tentatives:4d} "
              f"uniq={r.unique_tentatives:4d} inl={r.inliers:4d} "
              f"ratio={r.inlier_ratio:.3f} ({time.time() - t0:.0f}s)  "
              f"[graf ref: 264/254/147]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
