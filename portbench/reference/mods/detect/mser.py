# Frozen copy of mods_tpu_torch/detect/mser.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""MSER: the host component tree, frames on the caller's device.

The component tree is sequential, pointer-chasing host code (the
reference's CMP margin-stability MSER, detectors/mser/**), and host code
in the port as well.  The reference keeps its own copy of the C++ source
(portbench/reference/native/mser.cpp) and builds it with g++ at its first
call, never at import, into <checkout>/.pbcache/reference_build/ (named by
the hash of the source and flags; git-ignored), and loads it through
ctypes.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import MSERParams
from ..types import Keypoints

_REF = Path(__file__).resolve().parents[2]          # portbench/reference/
SOURCE = _REF / "native" / "mser.cpp"
BUILD_DIR = _REF.parents[1] / ".pbcache" / "reference_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
_lib: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """Compile the reference's mser.cpp with g++ into BUILD_DIR; reuse the
    library when it already exists."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                         ).hexdigest()[:16]
    lib = BUILD_DIR / f"libmser_{tag}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.mser_detect.restype = ctypes.c_int
        lib.mser_detect.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_double, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int]
        _lib = lib
    return _lib


def detect_mser(img, par: MSERParams, max_regions: int = 4096,
                device=None) -> Keypoints:
    """[H,W] image (numpy or tensor, 0..255) -> padded Keypoints of both
    polarities, on `device` (the image's device when it is a tensor, else
    the CPU).

    reference: DetectMSERs (detectors/mser/extrema/extrema.cpp:92-193)
    with CMP margin-stability semantics: FixedTh uses min_margin as the
    tree-level threshold; the other modes build with threshold 1.0 and cut
    the margin-ranked list (prepareKeysForExport, extrema.cpp:24-90).  The
    pixels are clipped to 0..255 and truncated to uint8."""
    if isinstance(img, torch.Tensor):
        device = img.device if device is None else device
        img = img.detach().cpu().numpy()
    device = torch.device("cpu") if device is None else torch.device(device)
    lib = _library()
    u8 = np.ascontiguousarray(np.clip(img, 0, 255), dtype=np.uint8)
    h, w = u8.shape
    # the reference's max_size excludes the 1 px processing frame
    max_size = int(par.max_area * (w - 2) * (h - 2))
    min_margin = float(par.min_margin) if par.detector_mode == "FixedTh" else 1.0
    out = np.zeros((max_regions, 8), np.float64)
    n = lib.mser_detect(
        u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        int(par.min_size), max_size, min_margin, 2,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_regions)
    if par.detector_mode in ("FixedRegNumber", "RegNumber"):
        n = min(n, par.reg_number)
    elif par.detector_mode == "RelativeRegNumber":
        n = min(n, int(n * par.rel_threshold) if par.rel_threshold > 1
                else int(np.floor(n * max(par.rel_threshold, 0.0))) or n)
    elif par.detector_mode == "NotLessThanRegions":
        # margin >= min_margin wins unless fewer than reg_number
        # (extrema.cpp:67-81)
        n_th = int(np.sum(out[:n, 7] >= par.min_margin))
        n = min(n, max(n_th, min(par.reg_number, n)))
    rows = np.zeros((max_regions, 8), np.float32)
    rows[:n] = out[:n]
    t = torch.from_numpy(rows).to(device)
    return Keypoints(xy=t[:, 0:2].contiguous(), A=t[:, 2:6].reshape(-1, 2, 2),
                     s=t[:, 6].contiguous(), response=t[:, 7].contiguous(),
                     valid=torch.arange(max_regions, device=device) < n)
