"""Ellipse-overlap distances and repeatability scoring.

Counterpart of the JAX package's ops/ellipse.py (reference ellipseOverlap
/ ellipseOverlapPrep, synth-detection.cpp:708-779, and the
ellipseOverlapH variants of matching.hpp:170-253): the pairwise ref x test
overlap matrix in a few batched products; the greedy one-to-one
assignment of `repeatability` stays on the host in numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..detect.affine_shape import rectify_up_is_up
from ..types import Keypoints
from .patches import K_SIGMA


def _inv2x2(M: torch.Tensor) -> torch.Tensor:
    det = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    inv = torch.stack([
        torch.stack([M[..., 1, 1], -M[..., 0, 1]], -1),
        torch.stack([-M[..., 1, 0], M[..., 0, 0]], -1)], -2)
    return inv / det[..., None, None]


def ellipse_overlap_matrix(ref: Keypoints, test: Keypoints,
                           max_error: float = 10000.0) -> torch.Tensor:
    """Pairwise overlap distance [n_ref, n_test] (ellipseOverlap,
    synth-detection.cpp:743-779): map both centers into the reference
    ellipse's canonical frame, add the Frobenius shape discrepancy of the
    relative affine.  Invalid rows/cols get +inf."""
    Ainv = _inv2x2(rectify_up_is_up(ref.A) * (K_SIGMA * ref.s)[:, None, None])  # [R,2,2]
    # centers in the canonical frame
    c_ref = torch.einsum("rij,rj->ri", Ainv, ref.xy)            # [R,2]
    c_tst = torch.einsum("rij,tj->rti", Ainv, test.xy)          # [R,T,2]
    dist = ((c_tst - c_ref[:, None, :]) ** 2).sum(-1)           # [R,T]

    B = test.A * (K_SIGMA * test.s)[:, None, None]              # [T,2,2]
    Rel = rectify_up_is_up(torch.einsum("rij,tjk->rtik", Ainv, B))   # [R,T,2,2]
    diff = 0.5 * ((1.0 - Rel[..., 0, 0]) ** 2 + Rel[..., 0, 1] ** 2
                  + Rel[..., 1, 0] ** 2 + (1.0 - Rel[..., 1, 1]) ** 2)
    out = dist + torch.where(dist > max_error, 0.0, diff)
    bad = (~ref.valid[:, None]) | (~test.valid[None, :])
    return torch.where(bad, float("inf"), out)


def reproject_keypoints_h(kp: Keypoints, H) -> Keypoints:
    """Map keypoints through a 3x3 homography (affine part linearized at
    each center) -- benchmark-side reprojection (matching.hpp:170-253)."""
    H = torch.as_tensor(np.asarray(H, np.float32), device=kp.xy.device)
    p = torch.cat([kp.xy, torch.ones_like(kp.xy[:, :1])], -1) @ H.T
    w = torch.where(p[:, 2:].abs() < 1e-12, 1e-12, p[:, 2:])
    xy = p[:, :2] / w
    # local affine (Jacobian) of H at each center:
    # J = (H[:2,:2] - xy_out * H[2,:2]) / w
    J = (H[None, :2, :2] - xy[:, :, None] * H[None, 2:3, :2]) / w[:, None]
    A = J @ kp.A
    # re-split the full frame into unit-det A and scale s
    det = (A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]).abs()
    d = torch.sqrt(torch.clamp(det, min=1e-20))
    return Keypoints(xy=xy, A=A / d[:, None, None], s=kp.s * d,
                     response=kp.response, valid=kp.valid)


def repeatability(ref: Keypoints, test: Keypoints, H,
                  overlap_threshold: float = 0.3):
    """Repeatability under ground-truth H: greedy one-to-one assignment
    of reprojected test regions to reference regions by overlap distance,
    on the host; returns (n_matched, n_ref_valid, n_test_valid)."""
    D = ellipse_overlap_matrix(ref, reproject_keypoints_h(test, H)).cpu().numpy()
    matched = 0
    used = np.zeros(D.shape[1], bool)
    for i in np.argsort(D.min(axis=1)):
        j = int(np.argmin(np.where(used, np.inf, D[i])))
        if np.isfinite(D[i, j]) and D[i, j] <= overlap_threshold:
            matched += 1
            used[j] = True
    return matched, int(ref.valid.sum()), int(test.valid.sum())
