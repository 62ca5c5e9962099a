"""Annotated output images: DrawMatches / DrawRegions equivalents.

Counterpart of the JAX package's io/draw.py (reference
matching/matching.cpp:1046-2613: side-by-side rendering with
affine-region ellipses, match lines and epipolar lines; per-image ellipse
overlay).  Host-side OpenCV rendering over the port's `Features` and
`Tentatives`: each function takes the tensors to numpy once, at its top,
and draws the same pixels as the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import Features, Tentatives

GREEN = (0, 255, 0)
RED = (0, 0, 255)
BLUE = (255, 0, 0)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_bgr(img) -> np.ndarray:
    img = _np(img)
    if img.ndim == 2:
        u8 = np.clip(img, 0, 255).astype(np.uint8)
        return np.stack([u8, u8, u8], -1).copy()
    return np.clip(img, 0, 255).astype(np.uint8).copy()


def _ellipse_params(A: np.ndarray, s: float):
    """2x2 affine frame * scale -> (axes, angle_deg) of the ellipse
    x^T (A A^T)^-1 x = s^2 (reference saveKP_KM_format SVD convention,
    imagerepresentation.cpp:113-126)."""
    M = A * s
    U, sv, Vt = np.linalg.svd(M)
    angle = np.degrees(np.arctan2(U[1, 0], U[0, 0]))
    return (float(sv[0]), float(sv[1])), angle


def draw_regions(img, feats: Features, scale: float = 3.0,
                 color=GREEN, thickness: int = 1) -> np.ndarray:
    """Ellipse overlay of all valid regions (reference DrawRegions)."""
    import cv2
    out = _to_bgr(img)
    valid = _np(feats.reproj.valid)
    xy = _np(feats.reproj.xy)[valid]
    A = _np(feats.reproj.A)[valid]
    s = _np(feats.reproj.s)[valid]
    for i in range(len(xy)):
        axes, ang = _ellipse_params(A[i], scale * s[i])
        cv2.ellipse(out, (int(round(xy[i, 0])), int(round(xy[i, 1]))),
                    (max(1, int(axes[0])), max(1, int(axes[1]))),
                    ang, 0, 360, color, thickness)
    return out


def _epipolar_line(F: np.ndarray, xy: np.ndarray, w: int, h: int):
    """Clip line l = F [x,y,1] to the image; returns endpoints or None
    (reference GetEpipolarLineF, matching.cpp:144-169)."""
    l = F @ np.array([xy[0], xy[1], 1.0])
    a, b, c = l
    pts = []
    if abs(b) > 1e-12:
        for x in (0.0, float(w - 1)):
            y = -(a * x + c) / b
            if 0 <= y <= h - 1:
                pts.append((x, y))
    if abs(a) > 1e-12:
        for y in (0.0, float(h - 1)):
            x = -(b * y + c) / a
            if 0 <= x <= w - 1:
                pts.append((x, y))
    if len(pts) < 2:
        return None
    return pts[0], pts[1]


def draw_matches(img1, img2, t: Tentatives, H=None, is_f: bool = False,
                 ellipse_scale: float = 3.0, draw_lines: bool = True,
                 sep: int = 8) -> np.ndarray:
    """Side-by-side match rendering (reference DrawMatches): green ellipses
    per endpoint, connecting lines for valid tentatives, and, when `H` is
    an F matrix (`is_f`), blue epipolar lines."""
    import cv2
    b1 = _to_bgr(img1)
    b2 = _to_bgr(img2)
    h = max(b1.shape[0], b2.shape[0])
    w1 = b1.shape[1]
    canvas = np.zeros((h, w1 + sep + b2.shape[1], 3), np.uint8)
    canvas[:b1.shape[0], :w1] = b1
    canvas[:b2.shape[0], w1 + sep:] = b2

    valid = _np(t.valid)
    xy1 = _np(t.xy1)[valid]
    xy2 = _np(t.xy2)[valid]
    A1 = _np(t.A1)[valid]
    A2 = _np(t.A2)[valid]
    s1 = _np(t.s1)[valid]
    s2 = _np(t.s2)[valid]
    off = np.array([w1 + sep, 0.0])

    if H is not None and is_f:
        F = np.asarray(_np(H), np.float64).reshape(3, 3)
        for i in range(len(xy1)):
            seg = _epipolar_line(F, xy1[i], b2.shape[1], b2.shape[0])
            if seg is not None:
                p0 = (int(seg[0][0] + off[0]), int(seg[0][1]))
                p1 = (int(seg[1][0] + off[0]), int(seg[1][1]))
                cv2.line(canvas, p0, p1, BLUE, 1)

    for i in range(len(xy1)):
        ax1, an1 = _ellipse_params(A1[i], ellipse_scale * s1[i])
        ax2, an2 = _ellipse_params(A2[i], ellipse_scale * s2[i])
        c1 = (int(round(xy1[i, 0])), int(round(xy1[i, 1])))
        c2 = (int(round(xy2[i, 0] + off[0])), int(round(xy2[i, 1])))
        cv2.ellipse(canvas, c1, (max(1, int(ax1[0])), max(1, int(ax1[1]))),
                    an1, 0, 360, GREEN, 1)
        cv2.ellipse(canvas, c2, (max(1, int(ax2[0])), max(1, int(ax2[1]))),
                    an2, 0, 360, GREEN, 1)
        if draw_lines:
            cv2.line(canvas, c1, c2, GREEN, 1)
    return canvas
