"""The deep two-view matcher ("deep flagship"), end to end.

Counterpart of the JAX package's models/deep.py: the reference's deep
configuration (Hessian + AffNet + OriNet + HardNet,
config_aff_ori_desc_zeromq.ini, one view per image) as one program per
pair:

  detect (Hessian, Baumberg off) -> AffNet shape + rectify / anisotropy /
  border -> centre-inside filter -> OriNet orientation -> K_SIGMA border
  filter -> HardNet describe -> FGINN -> duplicate filter -> LO-RANSAC-H.

`extract_deep` is the counterpart of `extract_deep_jit`, `match_pair_deep`
of `_match_pair_deep_body` and `match_pairs_deep` of the batched
`lax.map` program.  The three nets' patches always come from the mip
patch engine (the resample kernels on the card), as in the JAX program.
The weights are a `params3` argument, (AffNet, OriNet, HardNet) modules
(`desc.cnn.nets3`).  Everything runs on `device` ("cuda" by default; the
CPU only when asked for), in float32 (`full_float32`).  Stages are
`record_function` spans: detect, mip_pyramid, affnet, orinet, describe,
match, duplicate_filter, ransac.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from .. import full_float32, resolve_device
from ..config import Config
from ..desc import cnn
from ..detect.detector import detect_keypoints
from ..match.matching import duplicate_filter, match_fginn
from ..ops import image as imops
from ..ops import patch_engine as pe
from ..ops.patches import K_SIGMA
from ..types import Features
from ..verify.homography import _ransac_h_core


@full_float32()
def extract_deep(img, cfg: Config, max_kp: int, params3, device=None) -> Features:
    """Single-view deep extraction (identity view): [H,W] image, 0..255 ->
    Features with max_kp padded rows.  params3: (AffNet, OriNet, HardNet)
    on `device`."""
    dev = resolve_device(device)
    img = imops.as_image(img, dev)
    net_aff, net_ori, net_hard = params3
    h, w = img.shape
    with record_function("detect"):
        kp = detect_keypoints(img, cfg.hessian, max_kp, cfg.max_octave_cands)
    with record_function("mip_pyramid"):
        pyr = pe.build_mip_pyramid(img)
    with record_function("affnet"):
        kp = cnn.affnet_shape(kp, cnn.engine_outputs(pyr, kp, cfg.affnet, net_aff,
                                                   cfg.mip_aa),
                              w, h, cfg.affnet.mrSize)
        # ReprojectRegionsAndRemoveTouchBoundary with the identity
        # (pipeline.reproject_keypoints, dont_remove=True): centres inside
        inside = ((kp.xy[:, 0] > 0) & (kp.xy[:, 0] < w) &
                  (kp.xy[:, 1] > 0) & (kp.xy[:, 1] < h))
        kp = kp.with_valid(kp.valid & inside)
    with record_function("orinet"):
        kp = cnn.orinet_rotate(kp, cnn.engine_outputs(pyr, kp, cfg.orinet, net_ori,
                                                      cfg.mip_aa))
        # the second reprojection, with border removal (ReprojectRegions,
        # imagerepresentation.cpp:951; K_SIGMA extent)
        touch = imops.interpolate_check_borders(
            w, h, kp.xy[:, 0], kp.xy[:, 1], kp.A, K_SIGMA * kp.s, K_SIGMA * kp.s)
        kp = kp.with_valid(kp.valid & inside & ~touch)
    with record_function("describe"):
        desc = cnn.engine_outputs(pyr, kp, cfg.hardnet, net_hard, cfg.mip_aa)
    return Features(det=kp, reproj=kp, desc=desc)


def ransac_draw_shapes(cfg: Config, max_kp: int) -> Tuple[Tuple[int, int],
                                                          Tuple[int, int]]:
    """Shapes of the two RANSAC uniforms `match_pair_deep` consumes:
    ((batch_hypotheses, M), (lo_batch, M)) with M the tentative capacity
    after the duplicate filter's cap (one row per keypoint)."""
    m = min(min(2048, 2 * max_kp), max_kp)
    return ((cfg.ransac.batch_hypotheses, m), (cfg.ransac.lo_batch, m))


@full_float32()
def match_pair_deep(img1, img2, cfg: Config, max_kp: int = 4096, params3=None,
                    draws: Optional[Dict[str, torch.Tensor]] = None,
                    generator: Optional[torch.Generator] = None, device=None):
    """Two-view deep matching: returns (H [3,3], n_inliers, n_tentatives,
    n1, n2).

    params3: (AffNet, OriNet, HardNet) modules on `device`; by default the
    weights that `cfg` names (`cnn.nets3`).  draws: optional {"u_sweep":
    [batch, M], "u_lo": [lo_batch, M]} uniforms for the RANSAC stages (see
    `ransac_draw_shapes`); without them the stages draw from
    `generator`."""
    dev = resolve_device(device)
    params3 = cnn.nets3(cfg, dev) if params3 is None else params3
    f1 = extract_deep(img1, cfg, max_kp, params3, device=dev)
    f2 = extract_deep(img2, cfg, max_kp, params3, device=dev)
    ratio = cfg.matching.FGINNThreshold.get("ZMQ", 0.8)
    with record_function("match"):
        t = match_fginn(f1, f2, cfg.matching, ratio, int_exact=False)
    with record_function("duplicate_filter"):
        t = duplicate_filter(t, cfg.filtering.duplicateDist,
                             cfg.filtering.mode, cap=min(2048, 2 * max_kp))
    draws = draws or {}
    with record_function("ransac"):
        H, inl, _, _ = _ransac_h_core(
            t.xy1, t.xy2, t.valid, cfg.ransac.err_threshold ** 2,
            cfg.ransac.batch_hypotheses, cfg.ransac.lo_batch,
            u_sweep=draws.get("u_sweep"), u_lo=draws.get("u_lo"),
            generator=generator)
    return H, inl.sum(), t.count(), f1.count(), f2.count()


def match_pairs_deep(imgs1: Sequence, imgs2: Sequence, cfg: Config,
                     max_kp: int = 4096, params3=None,
                     draws: Optional[Sequence[Dict]] = None,
                     generator: Optional[torch.Generator] = None, device=None):
    """B pairs, one after another (the counterpart of the JAX package's
    lax.map program): per-pair (H [B,3,3], n_inliers [B], n_tent [B],
    n1 [B], n2 [B])."""
    params3 = cnn.nets3(cfg, resolve_device(device)) if params3 is None else params3
    outs = [match_pair_deep(a, b, cfg, max_kp, params3,
                            draws=None if draws is None else draws[i],
                            generator=generator, device=device)
            for i, (a, b) in enumerate(zip(imgs1, imgs2))]
    return tuple(torch.stack(list(col)) for col in zip(*outs))
