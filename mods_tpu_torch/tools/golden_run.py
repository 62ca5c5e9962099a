"""Run an image pair through the MODS loop (twoview.match_images) with the
classic configuration and print the counts and the per-phase TimeLog (traced:
each phase timed to the end of its device work).

    python -m mods_tpu_torch.tools.golden_run --img1 IMG1 --img2 IMG2
        [--config config.ini] [--iters iters.ini] [--device cuda|cpu]

Without INIs: Config() and one Hessian-Affine RootSIFT step
(tools/common.py).  The RANSAC draws come from a generator seeded with
cfg.ransac.seed.  The reference's golden run of graf1 / graf6 with
config_affori_classic.ini and iters_HessianSIFT.ini (its README.md:83-115)
reads regions 2665/3287, descriptors 2331/2912, 74 unique tentatives and
21 inliers; the lines below print those as graf's.  --device defaults to
the CUDA card; without one only --device cpu runs.
"""
from __future__ import annotations

import argparse
import sys
import time

from .. import resolve_device
from ..twoview import match_images
from . import common


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_inputs(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = common.tool_config(args)
    img1, img2 = common.load_pair(args)
    t0 = time.time()
    r = match_images(img1, img2, cfg, device=dev,
                     generator=common.ransac_generator(cfg, dev), trace=True)
    dt = time.time() - t0
    print(f"device={dev} wall={dt:.1f}s")
    print(f"regions: {r.regions1}/{r.regions2} (graf ref 2665/3287)")
    print(f"descriptors: {r.descriptors1}/{r.descriptors2} (graf ref 2331/2912)")
    print(f"tentatives: {r.tentatives} unique: {r.unique_tentatives} (graf ref 74)")
    print(f"inliers: {r.inliers} (graf ref 21)  ratio {r.inlier_ratio:.3f}")
    print(r.timelog.__dict__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
