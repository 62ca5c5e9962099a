"""External-command escape hatch: descriptors, orientations and affine
shapes from a program outside the process.

Counterpart of the JAX package's desc/cli_desc.py (reference
"CLIDescriptor", imagerepresentation.cpp:1017-1090, DetectOrientationExt
and DetectAffineShapeExt, synth-detection.cpp:931-1038, 1152-1244): the
patches (ops/patches.extract_patches_host, on the image's device) are
stacked into a column image, written as a BMP, the program is invoked as
`<runfile> <patches.bmp> <out.txt>`, and whitespace-separated numbers are
read back.  Any tool speaking the reference's patch-column protocol plugs
in.  The rounding to bytes and the geometry the tools' numbers feed are
host numpy, as in the JAX package; the keypoints come back as tensors on
the image's device.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
from typing import List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..detect.affine_shape import eigenvalues_2x2, rectify_up_is_up
from ..ops import image as imops
from ..ops import patches as patchops
from ..ops.patches import K_SIGMA
from ..types import Keypoints


def _image(img, device) -> torch.Tensor:
    """img as float32 on `device`, or on its own device when it is a
    tensor and no device is asked for."""
    if device is None and torch.is_tensor(img):
        return img.to(torch.float32)
    return imops.as_image(img, resolve_device(device))


def _column(p: torch.Tensor) -> np.ndarray:
    """[N, P, P] patches -> the (N*P, P) uint8 column image."""
    n, ps = p.shape[0], p.shape[-1]
    return np.clip(np.round(p.cpu().numpy()), 0, 255).astype(np.uint8).reshape(n * ps, ps)


def _run_patch_tool(column: np.ndarray, runfile: str, prefix: str,
                    workdir: Optional[str] = None) -> List[float]:
    """Write the patch column BMP, invoke `<runfile> <bmp> <txt>`, read
    whitespace-separated floats back (the reference's system()+tempfile
    transport, synth-detection.cpp:987-996 / 1176-1185).  A tool that
    exits non-zero raises subprocess.CalledProcessError."""
    import cv2
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        img_fname = os.path.join(td, f"{prefix}.bmp")
        out_fname = os.path.join(td, f"{prefix}.txt")
        if not cv2.imwrite(img_fname, column):
            raise OSError(f"could not write {img_fname}")
        subprocess.run(f"{runfile} {img_fname} {out_fname}", shell=True,
                       check=True)
        with open(out_fname) as fh:
            return [float(t) for t in fh.read().split()]


def describe_with_cli(img, kp: Keypoints, runfile: str,
                      mr_size: float = 5.1962, patch_size: int = 41,
                      photo_norm: bool = True, workdir: Optional[str] = None,
                      device=None) -> torch.Tensor:
    """[kp.n, D] float32 descriptors on the image's device, zero rows for
    invalid keypoints.

    Protocol (imagerepresentation.cpp:1058-1082, the non-hardcoded
    branch): the valid keypoints' patches are stacked into an
    (N*ps, ps) column image; the tool writes `dim` then N*dim floats."""
    img = _image(img, device)
    valid = kp.valid
    n = int(valid.sum())
    if n == 0:
        return torch.zeros((kp.n, 128), device=img.device)
    p = patchops.extract_patches_host(img, kp.xy[valid], kp.A[valid], kp.s[valid],
                                      mr_size, patch_size, photo_norm=photo_norm)
    toks = _run_patch_tool(_column(p), runfile, "CLIDESC", workdir)
    dim = int(toks[0])
    vals = np.asarray(toks[1:1 + n * dim], np.float32).reshape(n, dim)
    out = torch.zeros((kp.n, dim), device=img.device)
    out[valid] = torch.from_numpy(vals).to(img.device)
    return out


def orient_with_cli(img, kp: Keypoints, runfile: str,
                    mr_size: float = 5.1962, patch_size: int = 32,
                    workdir: Optional[str] = None, device=None) -> Keypoints:
    """DetectOrientationExt (synth-detection.cpp:931-1038): one patch per
    keypoint, the tool emits one angle per patch, A <- A . R(-angle).
    Keypoints whose K_SIGMA patch touches the border are dropped (the
    reference never appends them)."""
    img = _image(img, device)
    h, w = img.shape
    touch = imops.interpolate_check_borders(w, h, kp.xy[:, 0], kp.xy[:, 1], kp.A,
                                            K_SIGMA * kp.s, K_SIGMA * kp.s)
    ok = kp.valid & ~touch
    # one un-smoothed interpolation at A * (pis / patchSize) * s: the Ext
    # path has no two-stage anti-aliasing (synth-detection.cpp:976-985)
    p = patchops.extract_patches_host(img, kp.xy, kp.A, kp.s, mr_size, patch_size,
                                      photo_norm=False, fast=True)
    p = torch.where(ok[:, None, None], p, 0.0)
    vals = _run_patch_tool(_column(p), runfile, "CLIORIDET", workdir)
    n = kp.n
    angles = np.zeros(n, np.float32)
    angles[:min(n, len(vals))] = np.asarray(vals[:n], np.float32)
    A = kp.A.cpu().numpy()
    ci = np.cos(-angles)
    si = np.sin(-angles)
    a11 = A[:, 0, 0] * ci - A[:, 0, 1] * si
    a12 = A[:, 0, 0] * si + A[:, 0, 1] * ci
    a21 = A[:, 1, 0] * ci - A[:, 1, 1] * si
    a22 = A[:, 1, 0] * si + A[:, 1, 1] * ci
    An = np.stack([np.stack([a11, a12], -1), np.stack([a21, a22], -1)], -2)
    return Keypoints(kp.xy, torch.from_numpy(An).to(img.device), kp.s,
                     kp.response, ok)


def affine_shape_with_cli(img, kp: Keypoints, runfile: str,
                          mr_size: float = 5.1962, patch_size: int = 41,
                          workdir: Optional[str] = None, device=None) -> Keypoints:
    """DetectAffineShapeExt (synth-detection.cpp:1152-1244): the tool
    emits (a11 a12 a21 a22) per patch; the shape is rectified up-is-up,
    gated to anisotropy <= 6 and border-checked, and the scale multiplied
    by s1 as the reference computes it."""
    img = _image(img, device)
    dev = img.device
    h, w = img.shape
    ps = patch_size + 1 if patch_size % 2 == 0 else patch_size
    n = kp.n
    p = patchops.extract_patches_host(img, kp.xy, kp.A, kp.s, mr_size, ps,
                                      photo_norm=False)
    p = torch.where(kp.valid[:, None, None], p, 0.0)
    vals = _run_patch_tool(_column(p), runfile, "CLI_AFFDET", workdir)
    quads = np.zeros((n, 4), np.float32)
    got = min(n, len(vals) // 4)
    quads[:got] = np.asarray(vals[:got * 4], np.float32).reshape(got, 4)
    a11, a12, a21, a22 = quads.T
    # the reference computes s1 = sqrt|a11*a22 - a11*a21|
    # (synth-detection.cpp:1197); kept as it is for parity with the JAX
    # package, though a12*a21 was almost certainly intended
    s1 = np.sqrt(np.abs(a11 * a22 - a11 * a21))
    An = np.stack([np.stack([a11, a12], -1), np.stack([a21, a22], -1)], -2)
    Aj = rectify_up_is_up(torch.from_numpy(An).to(dev))
    oke, l1, l2 = eigenvalues_2x2(Aj[:, 0, 0], Aj[:, 0, 1], Aj[:, 1, 0], Aj[:, 1, 1])
    aniso = oke & (l1 / l2 <= 6.0) & (l2 / l1 <= 6.0)
    s = kp.s.cpu().numpy()
    extent = torch.from_numpy(s1 * mr_size * s).to(dev)
    touch = imops.interpolate_check_borders(w, h, kp.xy[:, 0], kp.xy[:, 1], Aj,
                                            extent, extent)
    ok = kp.valid & aniso & ~touch
    return Keypoints(kp.xy, Aj, torch.from_numpy(s * s1).to(dev), kp.response, ok)
