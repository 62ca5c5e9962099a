"""Embedding whitening for a HardNet checkpoint, from cached training
patches: writes one whitened checkpoint per alpha.

    python -m mods_tpu_torch.tools.whiten_hardnet <ckpt.npz> <pairs_cache.npz>
        [--alphas 0.25,0.5,0.75,1.0] [--n 40000] [--device cuda|cpu]

The anchors of up to --n pairs (drawn with default_rng(0)) are embedded
(desc/train.compute_whitening); each alpha's (mean, W) is saved beside the
weights as <ckpt>.wh{alpha}.npz (desc/train.save_hardnet_npz), which
desc/cnn.load_layers reads.  --device defaults to the CUDA card.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import resolve_device
from ..desc import train as T


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("ckpt")
    ap.add_argument("cache")
    ap.add_argument("--alphas", default="0.25,0.5,0.75,1.0")
    ap.add_argument("--n", type=int, default=40000)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    net = T.load_hardnet_npz(args.ckpt, resolve_device(args.device))
    a = np.load(args.cache)["a"]
    sel = np.random.default_rng(0).choice(len(a), min(args.n, len(a)), replace=False)
    patches = a[sel]
    for alpha in [float(x) for x in args.alphas.split(",")]:
        mu, W = T.compute_whitening(net, patches, alpha=alpha)
        out = args.ckpt.replace(".npz", f".wh{alpha:g}.npz")
        T.save_hardnet_npz(net, out, whiten=(mu, W))
        print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
