# Frozen copy of mods_tpu_torch/synth/atlas.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""All of an escalation step's views packed into one canvas (the atlas).

Counterpart of the JAX package's synth/atlas.py.  The reference extracts
each synthesized view in its own task (imagerepresentation.cpp:692-705);
here every view of a step is warped into one tall canvas, detection,
orientation and description run once over it, and the keypoints go back
to their views.  Views are stacked top to bottom, GAP rows of 128 between
them, the width that of the widest view; keypoints in a gap or in the
padding fail the per-view content box and the centre-inside test in the
original frame (a view's content border is the original image's border).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import Config, ViewSynthParameters
from ..detect import orientation as ori
from ..detect.detector import detect_keypoints
from ..ops import image as imops
from ..ops import patch_engine as pe
from ..pipeline import (K_SIGMA, SIFT_FAMILY, TimeLog, _describe_sift_engine,
                        _use_engine, detector_params)
from ..types import Features, Keypoints
from .vs import ViewGeometry, synth_view_geometry, warp_view

GAP = 96          # rows of 128 between slabs (>= the patch crop window)
ROUND = 64        # canvas sides rounded up to a multiple of this


class AtlasPlan:
    """View geometries, slab offsets and the canvas size."""

    def __init__(self, geoms: List[ViewGeometry], w: int, h: int):
        self.geoms = geoms
        self.y_off: List[int] = []
        y = 0
        wmax = 0
        for g in geoms:
            self.y_off.append(y)
            y += g.h_new + GAP
            wmax = max(wmax, g.w_new)
        self.H = -(-(y - GAP) // ROUND) * ROUND
        self.W = -(-wmax // ROUND) * ROUND
        self.Hs = np.stack([g.H3 for g in geoms])          # [V,3,3]
        self.sizes = np.asarray([[g.w_new, g.h_new] for g in geoms])
        # slab ends (half-way into the gap below) for the view of a row
        self.y_end = np.asarray([o + g.h_new + GAP // 2
                                 for o, g in zip(self.y_off, geoms)])


def plan_step_atlas(w: int, h: int, views: List[ViewSynthParameters]) -> AtlasPlan:
    # vp.phi is in radians (set_vs_pars steps by pi/n)
    return AtlasPlan([synth_view_geometry(w, h, vp.tilt, vp.phi, vp.zoom,
                                          vp.InitSigma, vp.doBlur)
                      for vp in views], w, h)


def build_atlas(img: torch.Tensor, plan: AtlasPlan) -> torch.Tensor:
    """Every view warped, blurred and placed on a canvas of 128."""
    atlas = torch.full((plan.H, plan.W), 128.0, device=img.device)
    for g, y0 in zip(plan.geoms, plan.y_off):
        v = warp_view(img, g)
        atlas[y0:y0 + v.shape[0], :v.shape[1]] = v
    return atlas


def check_borders_box(x1, y1, x2, y2, ofsx, ofsy, A, res_w, res_h):
    """interpolateCheckBorders (helpers.cpp:524-549) against a per-item box
    [x1, x2) x [y1, y2) instead of the whole image."""
    half_w = torch.ceil(res_w / 2.0)
    half_h = torch.ceil(res_h / 2.0)
    cs = torch.stack([torch.stack([-half_w, -half_h], -1),
                      torch.stack([-half_w, +half_h], -1),
                      torch.stack([+half_w, -half_h], -1),
                      torch.stack([+half_w, +half_h], -1)], -2)
    imx = (ofsx[..., None] + cs[..., 0] * A[..., 0, 0, None]
           + cs[..., 1] * A[..., 0, 1, None])
    imy = (ofsy[..., None] + cs[..., 0] * A[..., 1, 0, None]
           + cs[..., 1] * A[..., 1, 1, None])
    bad = ((torch.floor(imx) <= x1[..., None]) |
           (torch.floor(imy) <= y1[..., None]) |
           (torch.ceil(imx) >= (x2[..., None] - 2)) |
           (torch.ceil(imy) >= (y2[..., None] - 2)))
    return bad.any(dim=-1)


def assign_views(kp_xy: torch.Tensor, plan: AtlasPlan):
    """Per-keypoint view index, slab origin row and view size (atlas
    coordinates)."""
    dev = kp_xy.device
    y_end = torch.as_tensor(plan.y_end, dtype=torch.float32, device=dev)
    vid = torch.searchsorted(y_end, kp_xy[:, 1].contiguous(), right=True)
    vid = torch.clamp(vid, 0, len(plan.geoms) - 1)
    y0 = torch.as_tensor(plan.y_off, dtype=torch.float32, device=dev)[vid]
    wh = torch.as_tensor(plan.sizes, dtype=torch.float32, device=dev)[vid]
    return vid, y0, wh


def reproject_batch(kp: Keypoints, vid, y0, Hs: torch.Tensor, orig_w: int,
                    orig_h: int, mr_size, dont_remove: bool) -> Keypoints:
    """ReprojectRegions(AndRemoveTouchBoundary) with a map per keypoint
    (synth-detection.cpp:151-190): atlas -> view -> original frame."""
    xy_view = kp.xy - torch.stack([torch.zeros_like(y0), y0], -1)
    Hp = torch.linalg.inv(Hs)[vid]                  # [N,3,3]
    R = Hp[:, :2, :2]
    xy = torch.einsum("nij,nj->ni", R, xy_view) + Hp[:, :2, 2]
    A_out = torch.einsum("nij,njk->nik", R, kp.A)
    ok = kp.valid & ((xy[:, 0] > 0) & (xy[:, 0] < orig_w) &
                     (xy[:, 1] > 0) & (xy[:, 1] < orig_h))
    if not dont_remove:
        ok = ok & ~imops.interpolate_check_borders(
            orig_w, orig_h, xy[:, 0], xy[:, 1], A_out, mr_size * kp.s,
            mr_size * kp.s)
    return Keypoints(xy, A_out, kp.s, kp.response, ok)


def extract_step_atlas(img: torch.Tensor, cfg: Config, det_name: str,
                       views: List[ViewSynthParameters], orig_w: int,
                       orig_h: int, timelog=None
                       ) -> Tuple[Features, Dict[str, Features]]:
    """SynthDetectDescribeKeypoints for all the views of one step through
    one atlas: a scale-space detector (Hessian-Affine, DoG, Harris-Affine)
    with Baumberg, histogram orientation and the SIFT family on the mip
    engine.  Returns (regions, {descriptor:
    Features}) with `reproj` in the original frame, as extract_view does
    per view."""
    tl = timelog or TimeLog()
    dev = img.device
    h, w = int(img.shape[0]), int(img.shape[1])
    with tl.phase("SynthTime", dev):
        plan = plan_step_atlas(w, h, views)
        atlas = build_atlas(img, plan)

    with tl.phase("DetectTime", dev):
        kp = detect_keypoints(atlas, detector_params(cfg, det_name),
                              max_kp=cfg.max_keypoints,
                              max_octave_cands=cfg.max_octave_cands)
        vid, y0, wh = assign_views(kp.xy, plan)
        # content box: detections in a gap or in the padding end here
        inside = ((kp.xy[:, 0] > 0) & (kp.xy[:, 0] < wh[:, 0]) &
                  (kp.xy[:, 1] > y0) & (kp.xy[:, 1] < y0 + wh[:, 1]))
        kp = kp.with_valid(kp.valid & inside)

    Hs = torch.as_tensor(plan.Hs, dtype=torch.float32, device=dev)
    mr = cfg.rootsift.PEParam.mrSize + 0.01
    kp_rep = reproject_batch(kp, vid, y0, Hs, orig_w, orig_h, mr, dont_remove=True)
    kp_f = kp.with_valid(kp_rep.valid)

    # orientation over the whole atlas (border test against each view's box)
    with tl.phase("OrientTime", dev):
        dom = cfg.domori
        max_angles = dom.maxAngles if dom.maxAngles > 0 else 8
        ps_o = int(dom.PEParam.patchSize)
        k_o = float(2 * int(dom.PEParam.mrSize) + 1) / ps_o
        pyr = pe.build_mip_pyramid(atlas)
        touch0 = check_borders_box(torch.zeros_like(y0), y0, wh[:, 0], y0 + wh[:, 1],
                                   kp_f.xy[:, 0], kp_f.xy[:, 1], kp_f.A,
                                   K_SIGMA * kp_f.s, K_SIGMA * kp_f.s)
        live = kp_f.valid & ~touch0
        patches_o = pe.sample_patches(pyr, kp_f.xy,
                                      kp_f.A * (k_o * kp_f.s)[:, None, None],
                                      ps_o, mode="fit", valid=live)
        omask = torch.from_numpy(imops.circular_gauss_mask(ps_o, ps_o / 3.0)).to(dev)

        def oriented(half: bool) -> Keypoints:
            hist = ori.orientation_histogram(patches_o, omask, half)
            angles, aok = ori.dominant_angles(hist, float(dom.threshold), max_angles)
            rep = lambda t: t.repeat_interleave(max_angles, dim=0)
            return Keypoints(xy=rep(kp_f.xy),
                             A=ori.apply_rotation(kp_f.A[:, None], angles).reshape(-1, 2, 2),
                             s=rep(kp_f.s), response=rep(kp_f.response),
                             valid=(aok & live[:, None]).reshape(-1))

        descs = [d for d in views[0].descriptors if d in SIFT_FAMILY]
        kp_o = oriented(False)
        kp_o_half = oriented(True) if any("Half" in d for d in descs) else None
        vid_o = vid.repeat_interleave(max_angles)
        y0_o = y0.repeat_interleave(max_angles)

    regions = Features(det=kp_f, reproj=kp_rep, desc=torch.zeros((kp_f.n, 1), device=dev))
    by_desc: Dict[str, Features] = {}
    for desc_name in descs:
        with tl.phase("DescTime", dev):
            par = {"RootSIFT": cfg.rootsift, "SIFT": cfg.sift,
                   "HalfRootSIFT": cfg.halfrootsift, "HalfSIFT": cfg.halfsift}[desc_name]
            src = kp_o_half if "Half" in desc_name and kp_o_half is not None else kp_o
            kp_rep2 = reproject_batch(src, vid_o, y0_o, Hs, orig_w, orig_h, K_SIGMA,
                                      dont_remove=False)
            kp_d = src.with_valid(kp_rep2.valid)
            desc = _describe_sift_engine(pyr, kp_d.xy, kp_d.A, kp_d.s, kp_d.valid,
                                         par, blend=cfg.mip_aa)
            by_desc[desc_name] = Features(det=kp_d, reproj=kp_rep2, desc=desc)
    return regions, by_desc


def atlas_eligible(cfg: Config, det_name: str,
                   views: List[ViewSynthParameters], device) -> bool:
    """The atlas covers the classic MODS schedules: a scale-space detector
    without CNN or external stages, the SIFT family, more than one view, on
    the engine route."""
    if det_name not in ("HessianAffine", "DoG", "HarrisAffine") or len(views) < 2:
        return False
    if cfg.domori.addUpRight:
        return False
    if any(d not in SIFT_FAMILY for d in views[0].descriptors):
        return False
    return _use_engine(cfg, device)
