"""What the port's tools share: the image pair and the configuration they
run on, and the RANSAC generator.

The tools read the pair from `--img1` / `--img2` (gray = mean of the
channels, `cli.load_gray`) and the configuration from `--config` /
`--iters` (reference-format INIs; a named INI that does not exist raises
FileNotFoundError).  Without INIs, a classic tool runs the CLI's defaults
(Config() and one Hessian-Affine RootSIFT step on the identity view,
`cli.load_cli_config`) and a deep tool `testing.deep_config()` with one
Hessian-Affine ZMQ (HardNet) step.
"""
from __future__ import annotations

import argparse
from typing import Tuple

import numpy as np
import torch

from .. import cli
from ..config import Config, detector_step, load_config, load_iters
from ..testing import deep_config


def add_inputs(ap: argparse.ArgumentParser, pair_required: bool = True) -> None:
    """--img1, --img2, --config, --iters and --device."""
    ap.add_argument("--img1", required=pair_required, help="first image file")
    ap.add_argument("--img2", required=pair_required, help="second image file")
    ap.add_argument("--config", default=None, help="config INI (reference format)")
    ap.add_argument("--iters", default=None, help="iters INI (reference format)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")


def load_pair(args) -> Tuple[np.ndarray, np.ndarray]:
    """The two images of --img1 / --img2 as float32 gray in 0..255."""
    return cli.load_gray(args.img1), cli.load_gray(args.img2)


def tool_config(args, deep: bool = False) -> Config:
    """The configuration of --config / --iters, or the defaults above."""
    if not deep:
        return cli.load_cli_config(args.config, args.iters)
    cfg = load_config(args.config) if args.config else deep_config()
    if args.iters:
        cfg.iters, cfg.matching.maxSteps, cfg.matching.minMatches = load_iters(args.iters)
    else:
        cfg.iters = [detector_step(["HessianAffine"], [1.0], 360.0, "ZMQ")]
    return cfg


def ransac_generator(cfg: Config, device: torch.device) -> torch.Generator:
    """The RANSAC draws of one verification: a generator seeded with
    cfg.ransac.seed, as the JAX package's verifiers draw from
    PRNGKey(pars.seed) when given no key."""
    return torch.Generator(device=device).manual_seed(cfg.ransac.seed)
