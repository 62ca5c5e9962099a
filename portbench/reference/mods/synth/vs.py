# Frozen copy of mods_tpu_torch/synth/vs.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""View synthesis: the tilt/rotation/zoom schedule and the affine warp.

Counterpart of the JAX package's synth/vs.py (reference
synth-detection.cpp:191-322 SetVSPars and :324-576
GenerateSynthImageCorr / GenerateSynthImageByH).  The schedule and every
view's size and 3x3 map are float64 host math, identical to the JAX
package's; the warps (rotate with a 128 border, anisotropic anti-alias
blur, tilt/zoom scale) run in PyTorch on the image's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import ViewSynthParameters
from ..ops import image as imops

EPS1 = 0.01


def set_vs_pars(scale_set: List[float], tilt_set: List[float], phi_base: float,
                descriptors: List[str], fginn: Dict[str, float],
                dist: Dict[str, float], init_sigma: float, do_blur: bool,
                prev_par: List[ViewSynthParameters]
                ) -> Tuple[List[ViewSynthParameters], List[ViewSynthParameters]]:
    """Expand {scales} x {tilts} x phi steps into view parameters, without
    the views already in `prev_par` (SetVSPars): floor(180*tilt/phi)
    rotations per tilt at pi/n apart; a negative tilt is a vertical tilt
    without rotations.  Returns (new_views, updated_prev_par)."""
    pars_tmp: List[ViewSynthParameters] = []

    def mk(phi, tilt, zoom):
        return ViewSynthParameters(
            tilt=tilt, phi=phi, zoom=zoom, InitSigma=init_sigma,
            doBlur=do_blur, descriptors=list(descriptors),
            FGINNThreshold=dict(fginn), DistanceThreshold=dict(dist))

    if not scale_set or not tilt_set:
        pars_tmp.append(mk(0.0, 0.0, 0.0))
    for zoom in scale_set:
        for tilt in tilt_set:
            if abs(tilt - 1.0) > EPS1:
                n_rot1 = int(math.floor(180.0 * tilt / phi_base))
                if n_rot1 < 0:
                    pars_tmp.append(mk(0.0, -tilt, zoom))
                    n_rot1 = 1
                    delta_phi = 0.0
                else:
                    delta_phi = math.pi / n_rot1
                for r in range(n_rot1):
                    pars_tmp.append(mk(delta_phi * r, tilt, zoom))
            else:
                pars_tmp.append(mk(0.0, tilt, zoom))

    out = [p for p in pars_tmp
           if not any(abs(p.zoom - q.zoom) <= EPS1 and abs(p.tilt - q.tilt) <= EPS1
                      and abs(p.phi - q.phi) <= EPS1 for q in prev_par)]
    return out, list(prev_par) + out


@dataclass
class SynthView:
    """reference SynthImage (structures.hpp:171-183)."""
    pixels: torch.Tensor
    H: np.ndarray                  # 3x3 original -> synth
    tilt: float = 1.0
    phi: float = 0.0               # degrees
    zoom: float = 1.0
    id: int = 0


@dataclass
class ViewGeometry:
    """Host-side warp plan of one synthesized view; identity=True stands
    for the input image itself."""
    identity: bool
    w_new: int = 0
    h_new: int = 0
    H3: Optional[np.ndarray] = None      # 3x3 original -> synth
    Mrot: Optional[np.ndarray] = None    # 2x3 rotation warp
    w_rot: int = 0
    h_rot: int = 0
    Mtz: Optional[np.ndarray] = None     # 2x3 tilt/zoom warp
    sigma_x: float = 0.0
    sigma_y: float = 0.0
    do_blur: bool = False
    tilt: float = 1.0
    phi_deg: float = 0.0
    zoom: float = 1.0


def synth_view_geometry(w: int, h: int, tilt: float, phi: float, zoom: float,
                        init_sigma: float, do_blur: bool) -> ViewGeometry:
    """The shape and matrix math of GenerateSynthImageCorr
    (synth-detection.cpp:324-518), in float64, so that callers (the
    per-view warp and the atlas) know every view's size up front."""
    vertical = tilt < 0
    tilt = abs(tilt)
    zoomed = abs(zoom - 1.0) >= 0.05

    if (abs(tilt - 1.0) <= 0.1) and (abs(phi) <= 0.2) and (abs(zoom - 1.0) <= 0.1):
        return ViewGeometry(identity=True, w_new=w, h_new=h, H3=np.eye(3))

    kV = kH = 1.0
    if zoomed:
        wS1, hS1 = int(w * zoom), int(h * zoom)
        kV = w / wS1
        kH = h / hS1

    cphi, sphi = math.cos(phi), math.sin(phi)
    H3 = np.eye(3)
    if vertical:
        if 0 <= phi < math.pi / 2:
            w_new = math.floor((0.5 + cphi * w + sphi * h) / kH)
            h_new = math.floor((0.5 + sphi * w + cphi * h) / (tilt * kV))
            H3[0] = [cphi / kH, sphi / kH, 0.0]
            H3[1] = [-sphi / (tilt * kV), cphi / (tilt * kV),
                     math.floor(0.5 + sphi * w / (tilt * kV))]
        else:
            w_new = math.floor((0.5 - cphi * w + sphi * h) / kH)
            h_new = math.floor((0.5 + sphi * w - cphi * h) / (tilt * kV))
            d = -math.floor(cphi * w / kH)
            d2 = math.floor(0.5 + (sphi * w - cphi * h) / (tilt * kV))
            H3[0] = [cphi / kH, sphi / kH, d]
            H3[1] = [-sphi / (tilt * kV), cphi / (tilt * kV), d2]
    else:
        if 0 <= phi < math.pi / 2:
            w_new = math.floor((0.5 + cphi * w + sphi * h) / (tilt * kH))
            h_new = math.floor((0.5 + sphi * w + cphi * h) / kV)
            H3[0] = [cphi / (tilt * kH), sphi / (tilt * kH), 0.0]
            H3[1] = [-sphi / kV, cphi / kV, math.floor(0.5 + sphi * w / kV)]
        else:
            w_new = math.floor((0.5 - cphi * w + sphi * h) / (tilt * kH))
            h_new = math.floor((0.5 + sphi * w - cphi * h) / kV)
            d = -math.floor(cphi * w / (tilt * kH))
            d2 = math.floor(0.5 + (sphi * w - cphi * h) / kV)
            H3[0] = [cphi / (tilt * kH), sphi / (tilt * kH), d]
            H3[1] = [-sphi / kV, cphi / kV, d2]

    # anti-alias sigmas (synth-detection.cpp:437-451)
    sigma_aa_2 = init_sigma / (4.0 * zoom) if zoomed else init_sigma / 2.0
    sigma_aa = init_sigma * tilt / (2.0 * zoom)
    sigma_x, sigma_y = ((sigma_aa_2, sigma_aa) if vertical
                        else (sigma_aa, sigma_aa_2))

    # rotation warp at full resolution
    if 0 <= phi < math.pi / 2:
        w_rot = int(math.floor(0.5 + cphi * w + sphi * h))
        h_rot = int(math.floor(0.5 + sphi * w + cphi * h))
        Mrot = np.array([[cphi, sphi, 0.0],
                         [-sphi, cphi, math.floor(0.5 + sphi * w)]])
    else:
        w_rot = int(math.floor(0.5 - cphi * w + sphi * h))
        h_rot = int(math.floor(0.5 + sphi * w - cphi * h))
        Mrot = np.array([[cphi, sphi, -math.floor(cphi * w)],
                         [-sphi, cphi, math.floor(0.5 + (sphi * w - cphi * h))]])
    if vertical:
        Mtz = np.array([[1.0 / kH, 0.0, 0.0], [0.0, 1.0 / (tilt * kV), 0.0]])
    else:
        Mtz = np.array([[1.0 / (tilt * kH), 0.0, 0.0], [0.0, 1.0 / kV, 0.0]])
    return ViewGeometry(identity=False, w_new=int(w_new), h_new=int(h_new),
                        H3=H3, Mrot=Mrot, w_rot=w_rot, h_rot=h_rot, Mtz=Mtz,
                        sigma_x=sigma_x, sigma_y=sigma_y, do_blur=do_blur,
                        tilt=tilt, phi_deg=math.degrees(phi), zoom=zoom)


def warp_view(img: torch.Tensor, g: ViewGeometry) -> torch.Tensor:
    """The two-stage warp of a planned view."""
    if g.identity:
        return img
    rotated = imops.warp_affine(img, g.Mrot, g.h_rot, g.w_rot, fill=128.0)
    if g.do_blur:
        rotated = imops.gaussian_blur_xy(rotated, g.sigma_x, g.sigma_y)
    return imops.warp_affine(rotated, g.Mtz, g.h_new, g.w_new, fill=128.0)


def generate_synth_view(img: torch.Tensor, tilt: float, phi: float, zoom: float,
                        init_sigma: float, do_blur: bool, img_id: int) -> SynthView:
    """Affine-warp simulator (GenerateSynthImageCorr): rotate by phi
    (border 128), blur by InitSigma*tilt/(2*zoom) along the tilt axis,
    then scale by 1/tilt (and zoom); H is the exact composed map."""
    h, w = int(img.shape[0]), int(img.shape[1])
    g = synth_view_geometry(w, h, tilt, phi, zoom, init_sigma, do_blur)
    if g.identity:
        return SynthView(pixels=img, H=np.eye(3), tilt=1.0, phi=0.0,
                         zoom=1.0, id=0)
    return SynthView(pixels=warp_view(img, g), H=g.H3, tilt=g.tilt,
                     phi=g.phi_deg, zoom=g.zoom, id=img_id)
