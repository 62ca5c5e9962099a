"""The classic two-view matcher ("flagship model"), end to end.

Counterpart of the JAX package's models/flagship.py: detect (octave
loop) -> Baumberg -> orientation -> describe -> FGINN match -> duplicate
filter -> LO-RANSAC-H.  `extract` is the counterpart of `extract_jit`,
`match_pair` of `_match_pair_body` and `match_pairs` of the batched
`lax.map` program.  Everything runs on `device` ("cuda" by default; the
CPU only when asked for), in float32: the entry points turn TF32 off
while they run and restore the caller's setting (`full_float32`).

Stages are marked with torch.profiler.record_function spans (detect,
mip_pyramid, orientation, describe, match, duplicate_filter, ransac),
which cost nothing unless a profiler is recording; chip_smoke.py reads
them for its per-stage breakdown.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from .. import full_float32, resolve_device
from ..config import Config
from ..desc import sift as siftmod
from ..detect import orientation as ori
from ..detect.detector import detect_keypoints
from ..match.matching import duplicate_filter, match_fginn
from ..ops import image as imops
from ..ops import patch_engine as pe
from ..ops.patches import K_SIGMA
from ..types import Features, Keypoints
from ..verify.homography import _ransac_h_core

def _describe_fast(pyr: torch.Tensor, kp: Keypoints, cfg: Config) -> torch.Tensor:
    """RootSIFT description through the mip patch engine."""
    par = cfg.rootsift
    ps = par.PEParam.patchSize
    k = float(2 * int(par.PEParam.mrSize) + 1) / ps
    mask = torch.from_numpy(imops.circular_gauss_mask(ps)).to(pyr.device)
    patches = pe.sample_patches(pyr, kp.xy, kp.A * (k * kp.s)[:, None, None],
                                ps, valid=kp.valid, blend=cfg.mip_aa)
    if par.PEParam.photoNorm:
        patches = imops.photometric_normalize(patches, mask)
    return siftmod.describe_patches(patches, par)


@full_float32()
def extract(img, cfg: Config, max_kp: int, device=None) -> Features:
    """Single-view extraction (identity view): [H,W] image, 0..255 ->
    Features with max_kp * maxAngles padded rows."""
    dev = resolve_device(device)
    img = imops.as_image(img, dev)
    h, w = img.shape
    with record_function("detect"):
        kp = detect_keypoints(img, cfg.hessian, max_kp, cfg.max_octave_cands)
    inside = ((kp.xy[:, 0] > 0) & (kp.xy[:, 0] < w) &
              (kp.xy[:, 1] > 0) & (kp.xy[:, 1] < h))
    kp = kp.with_valid(kp.valid & inside)

    with record_function("mip_pyramid"):
        pyr = pe.build_mip_pyramid(img)
    with record_function("orientation"):
        kp_o = _orient(pyr, kp, cfg, w, h)
    with record_function("describe"):
        desc = _describe_fast(pyr, kp_o, cfg)
        desc = torch.where(kp_o.valid[:, None], desc, 0.0)
    return Features(det=kp_o, reproj=kp_o, desc=desc)


def _orient(pyr: torch.Tensor, kp: Keypoints, cfg: Config, w: int, h: int
            ) -> Keypoints:
    """Dominant orientations: one row per (keypoint, angle), valid where
    the angle exists and the rotated patch stays inside the image."""
    dev = pyr.device
    dom = cfg.domori
    max_angles = dom.maxAngles if dom.maxAngles > 0 else 8
    ps_o = int(dom.PEParam.patchSize)
    k_o = float(2 * int(dom.PEParam.mrSize) + 1) / ps_o
    touch0 = imops.interpolate_check_borders(
        w, h, kp.xy[:, 0], kp.xy[:, 1], kp.A, K_SIGMA * kp.s, K_SIGMA * kp.s)
    live0 = kp.valid & ~touch0
    patches_o = pe.sample_patches(pyr, kp.xy, kp.A * (k_o * kp.s)[:, None, None],
                                  ps_o, mode="fit", valid=live0)
    omask = torch.from_numpy(imops.circular_gauss_mask(ps_o, ps_o / 3.0)).to(dev)
    hist = ori.orientation_histogram(patches_o, omask, False)
    angles, aok = ori.dominant_angles(hist, float(dom.threshold), max_angles)
    A_rot = ori.apply_rotation(kp.A[:, None], angles)        # [N, angles, 2, 2]
    aok = aok & live0[:, None]

    kp_o = Keypoints(
        xy=kp.xy.repeat_interleave(max_angles, dim=0),
        A=A_rot.reshape(-1, 2, 2),
        s=kp.s.repeat_interleave(max_angles),
        response=kp.response.repeat_interleave(max_angles),
        valid=aok.reshape(-1),
    )
    touch = imops.interpolate_check_borders(
        w, h, kp_o.xy[:, 0], kp_o.xy[:, 1], kp_o.A,
        K_SIGMA * kp_o.s, K_SIGMA * kp_o.s)
    return kp_o.with_valid(kp_o.valid & ~touch)


def ransac_draw_shapes(cfg: Config, max_kp: int) -> Tuple[Tuple[int, int],
                                                          Tuple[int, int]]:
    """Shapes of the two RANSAC uniforms `match_pair` consumes:
    ((batch_hypotheses, M), (lo_batch, M)) with M the tentative capacity
    after the duplicate filter's cap."""
    max_angles = cfg.domori.maxAngles if cfg.domori.maxAngles > 0 else 8
    m = min(min(2048, 2 * max_kp), max_kp * max_angles)
    return ((cfg.ransac.batch_hypotheses, m), (cfg.ransac.lo_batch, m))


@full_float32()
def match_pair(img1, img2, cfg: Config, max_kp: int = 4096,
               draws: Optional[Dict[str, torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None, device=None):
    """Two-view matching: returns (H [3,3], n_inliers, n_tentatives, n1, n2).

    draws: optional {"u_sweep": [batch, M], "u_lo": [lo_batch, M]}
    uniforms for the RANSAC stages (see `ransac_draw_shapes`); without
    them the stages draw from `generator`."""
    dev = resolve_device(device)
    f1 = extract(img1, cfg, max_kp, device=dev)
    f2 = extract(img2, cfg, max_kp, device=dev)
    ratio = cfg.matching.FGINNThreshold.get("RootSIFT", 0.8)
    with record_function("match"):
        t = match_fginn(f1, f2, cfg.matching, ratio, int_exact=True)
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


def match_pairs(imgs1: Sequence, imgs2: Sequence, cfg: Config,
                max_kp: int = 4096, draws: Optional[Sequence[Dict]] = None,
                generator=None, device=None):
    """B pairs, one after another (the counterpart of the JAX package's
    lax.map program): per-pair (H [B,3,3], n_inliers [B], n_tent [B],
    n1 [B], n2 [B]).  generator: one torch.Generator that every pair draws
    from in turn, or a sequence of one per pair."""
    gens = generator if isinstance(generator, (list, tuple)) else \
        [generator] * len(imgs1)
    outs = [match_pair(a, b, cfg, max_kp,
                       draws=None if draws is None else draws[i],
                       generator=gens[i], device=device)
            for i, (a, b) in enumerate(zip(imgs1, imgs2))]
    return tuple(torch.stack(list(col)) for col in zip(*outs))
