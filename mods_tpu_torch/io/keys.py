"""Feature files in the reference's interchange formats.

Counterpart of the JAX package's io/keys.py; the files are the same byte
for byte.

 - npz: {"xy" Nx2 f64, "scales" Nx1, "responses" Nx1, "A" Nx4,
   "descs" NxD uint8} (reference imagerepresentation.cpp:1257-1316
   SaveRegionsNPZ / :1355-1513 PreLoadRegionsNPZ)
 - Mikolajczyk/OxAff text: "x y a b c d0..dD" ellipse rows
   (saveKP_KM_format, imagerepresentation.cpp:113-126)
 - "Michal" text: "x y s a11 a12 a21 a22 sub_type response d0..dD"
   (saveKPMichal, imagerepresentation.cpp:128-135)
 - matches, H, the native hierarchical region store, the benchmark
   exports and the ReadAffs pseudo-detector's files.

Writers take the port's `Features` on any device; loaders return them on
`device` (CUDA unless the caller asks for another).  Everything between
the file and the tensors is numpy on the host.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..types import Features, Keypoints

K_SIGMA_3S3 = 3.0 * math.sqrt(3.0)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _features(xy, A, s, response, desc, device) -> Features:
    """Features with det == reproj, every row valid, on `device`."""
    dev = resolve_device(device)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    kp = Keypoints(xy=f(xy), A=f(A), s=f(s), response=f(response),
                   valid=torch.ones(len(s), dtype=torch.bool, device=dev))
    return Features(det=kp, reproj=kp, desc=f(desc))


def _rectify_np(A: np.ndarray) -> np.ndarray:
    """rectifyAffineTransformationUpIsUp (helpers.cpp:380-389), numpy."""
    a, b = A[:, 0, 0], A[:, 0, 1]
    c, d = A[:, 1, 0], A[:, 1, 1]
    det = np.sqrt(np.abs(a * d - b * c))
    b2a2 = np.sqrt(b * b + a * a)
    out = np.zeros_like(A)
    out[:, 0, 0] = b2a2 / det
    out[:, 1, 0] = (d * b + c * a) / (b2a2 * det)
    out[:, 1, 1] = det / b2a2
    return out


def features_dense(f: Features) -> Dict[str, np.ndarray]:
    """The valid rows on the host: the original frame's xy, A, s (f64), the
    detection's response (f64) and the descriptors as stored."""
    v = _np(f.valid)
    f64 = lambda t: _np(t).astype(np.float64)[v]
    return dict(xy=f64(f.reproj.xy), A=f64(f.reproj.A), s=f64(f.reproj.s),
                response=f64(f.det.response), desc=_np(f.desc)[v])


def _g(values) -> str:
    return " ".join(f"{v:g}" for v in values)


def save_npz(fname: str, feats: Features) -> None:
    d = features_dense(feats)
    n = len(d["s"])
    np.savez(fname if fname.endswith(".npz") else fname + ".npz",
             xy=d["xy"].reshape(n, 2),
             scales=d["s"].reshape(n, 1),
             responses=d["response"].reshape(n, 1),
             A=d["A"].reshape(n, 4),
             descs=np.clip(d["desc"], 0, 255).astype(np.uint8))


def load_npz(fname: str, device=None) -> Features:
    """reference PreLoadRegionsNPZ (imagerepresentation.cpp:1355-1513)."""
    z = np.load(fname)
    xy = np.asarray(z["xy"], np.float32).reshape(-1, 2)
    n = xy.shape[0]
    s = np.asarray(z["scales"], np.float32).reshape(-1)
    resp = (np.asarray(z["responses"], np.float32).reshape(-1)
            if "responses" in z else np.full(n, 100.0, np.float32))
    A = (np.asarray(z["A"], np.float32).reshape(-1, 2, 2) if "A" in z
         else np.tile(np.eye(2, dtype=np.float32)[None], (n, 1, 1)))
    desc = (np.asarray(z["descs"], np.float32) if "descs" in z
            else np.zeros((n, 128), np.float32))
    return _features(xy, A, s, resp, desc, device)


def save_oxaff(fname: str, feats: Features) -> None:
    """Mikolajczyk 'x y a b c' ellipse format + descriptor values: header
    descriptor_dim then keypoint count; ellipse [a b; b c] with x' E x = 1
    over the 3*sqrt(3)*s measurement region (saveKP_KM_format,
    imagerepresentation.cpp:113-126)."""
    d = features_dense(feats)
    n = len(d["s"])
    A = d["A"]
    sc = d["s"] * np.sqrt(np.abs(np.linalg.det(A))) * K_SIGMA_3S3
    U, w, _ = np.linalg.svd(_rectify_np(A))
    winv = 1.0 / (w ** 2 * sc[:, None] ** 2)
    E = np.einsum("nij,nj,nkj->nik", U, winv, U)
    with open(fname, "w") as fh:
        fh.write(f"{d['desc'].shape[1]}\n{n}\n")
        for i in range(n):
            row = [d["xy"][i, 0], d["xy"][i, 1], E[i, 0, 0], E[i, 0, 1], E[i, 1, 1]]
            fh.write(_g(row + d["desc"][i].tolist()) + "\n")


def load_oxaff(fname: str, device=None) -> Features:
    """ReadKPsMik (synth-detection.cpp:1451-1496): ellipse -> (s, A)."""
    with open(fname) as fh:
        dim = int(float(fh.readline().strip()))
        n = int(float(fh.readline().strip()))
        xy = np.zeros((n, 2), np.float32)
        A = np.zeros((n, 2, 2), np.float32)
        s = np.zeros(n, np.float32)
        desc = np.zeros((n, dim), np.float32)
        for i in range(n):
            vals = [float(t) for t in fh.readline().split()]
            x, y, a, b, c = vals[:5]
            desc[i] = vals[5:5 + dim]
            xy[i] = (x, y)
            wE, VE = np.linalg.eigh(np.array([[a, b], [b, c]]))
            # E = V diag(w) V^T; shape matrix M = E^{-1/2}, s = det^{1/4}
            Minv_sq = VE @ np.diag(1.0 / np.sqrt(np.maximum(wE, 1e-12))) @ VE.T
            det = np.sqrt(np.abs(np.linalg.det(Minv_sq)))
            s[i] = np.sqrt(det) / K_SIGMA_3S3
            A[i] = Minv_sq / np.sqrt(det)
    return _features(xy, A, s, np.full(n, 100.0), desc, device)


def save_michal(fname: str, feats: Features) -> None:
    """saveKPMichal text format (imagerepresentation.cpp:128-135)."""
    d = features_dense(feats)
    n = len(d["s"])
    A = d["A"]
    s2 = d["s"] * np.sqrt(np.abs(np.linalg.det(A))) * K_SIGMA_3S3
    Ar = _rectify_np(A)
    with open(fname, "w") as fh:
        fh.write(f"{d['desc'].shape[1]}\n{n}\n")
        for i in range(n):
            row = [d["xy"][i, 0], d["xy"][i, 1], s2[i],
                   Ar[i, 0, 0], Ar[i, 0, 1], Ar[i, 1, 0], Ar[i, 1, 1],
                   0, d["response"][i]]
            fh.write(_g(row + d["desc"][i].tolist()) + "\n")


def load_michal(fname: str, device=None) -> Features:
    """Inverse of save_michal (rows 'x y s a11 a12 a21 a22 sub_type
    response d...')."""
    with open(fname) as fh:
        dim = int(float(fh.readline().strip()))
        n = int(float(fh.readline().strip()))
        xy = np.zeros((n, 2), np.float32)
        A = np.zeros((n, 2, 2), np.float32)
        s = np.zeros(n, np.float32)
        resp = np.zeros(n, np.float32)
        desc = np.zeros((n, dim), np.float32)
        for i in range(n):
            vals = [float(t) for t in fh.readline().split()]
            xy[i] = vals[0:2]
            A[i] = [[vals[3], vals[4]], [vals[5], vals[6]]]
            resp[i] = vals[8]
            desc[i] = vals[9:9 + dim]
            # the stored scale bakes in sqrt(det A)*3*sqrt(3) (save_michal)
            det = np.sqrt(np.abs(A[i, 0, 0] * A[i, 1, 1] - A[i, 0, 1] * A[i, 1, 0]))
            s[i] = vals[2] / max(det * K_SIGMA_3S3, 1e-12)
    return _features(xy, A, s, resp, desc, device)


def write_matches(fname: str, xy1: np.ndarray, xy2: np.ndarray,
                  ratios: Optional[np.ndarray] = None) -> None:
    """WriteMatchings plain variant (matching.cpp:2609-2613):
    'x1 y1 x2 y2 [ratio]' rows."""
    with open(fname, "w") as fh:
        fh.write(f"{len(xy1)}\n")
        for i in range(len(xy1)):
            row = [xy1[i, 0], xy1[i, 1], xy2[i, 0], xy2[i, 1]]
            if ratios is not None:
                row.append(ratios[i])
            fh.write(_g(row) + "\n")


def write_matches_csv(fname: str, xy1: np.ndarray, xy2: np.ndarray,
                      fginn_ratio: np.ndarray,
                      snn_ratio: Optional[np.ndarray] = None,
                      detector: str = "HessianAffine",
                      descriptor: str = "RootSIFT",
                      is_correct: Optional[np.ndarray] = None) -> None:
    """WriteMatchings writeWithRatios variant (matching.cpp:2596-2608): CSV
    with header 'x1,y1,x2,y2,FGINN_ratio,SNN_ratio,detector,descriptor,
    is_correct'."""
    with open(fname, "w") as fh:
        fh.write("x1,y1,x2,y2,FGINN_ratio,SNN_ratio,detector,descriptor,"
                 "is_correct \n")
        for i in range(len(xy1)):
            snn = snn_ratio[i] if snn_ratio is not None else fginn_ratio[i]
            corr = int(is_correct[i]) if is_correct is not None else 0
            fh.write(f"{xy1[i, 0]:g},{xy1[i, 1]:g},{xy2[i, 0]:g},"
                     f"{xy2[i, 1]:g},{fginn_ratio[i]:g},{snn:g},"
                     f"{detector},{descriptor},{corr}\n")


def write_h(fname: str, H: np.ndarray) -> None:
    """WriteH (matching.cpp:2681-2689)."""
    H = np.asarray(H).reshape(3, 3)
    with open(fname, "w") as fh:
        for r in range(3):
            fh.write(_g(H[r]) + "\n")


def read_h(fname: str) -> np.ndarray:
    vals = []
    with open(fname) as fh:
        for line in fh:
            vals += [float(t) for t in line.split()]
    return np.asarray(vals[:9], np.float64).reshape(3, 3)


# --------------------------------------------------------------------------- #
# The native hierarchical region store
# --------------------------------------------------------------------------- #
def save_regions_native(fname: str, store: Dict[str, Dict[str, Features]]) -> None:
    """Native hierarchical keys format (reference SaveRegions,
    imagerepresentation.cpp:1219-1255):

        <n_detectors>
        <detector> <n_descriptor_maps>
        <descriptor> <n_regions>
        <desc_dim>                      (only when n_regions > 0)
        x y s a11 a12 a21 a22 <dim> <values...>   (the original frame)
    """
    with open(fname, "w") as fh:
        fh.write(f"{len(store)}\n")
        for det, dmap in store.items():
            fh.write(f"{det} {len(dmap)}\n")
            for desc_name, f in dmap.items():
                d = features_dense(f)
                n = len(d["s"])
                dim = d["desc"].shape[1] if n and desc_name != "None" else 0
                fh.write(f"{desc_name} {n}\n")
                if n > 0:
                    fh.write(f"{dim}\n")
                for i in range(n):
                    A = d["A"][i]
                    fh.write(_g([d["xy"][i, 0], d["xy"][i, 1], d["s"][i],
                                 A[0, 0], A[0, 1], A[1, 0], A[1, 1]]))
                    fh.write(f" {dim} ")
                    if dim:
                        fh.write(_g(d["desc"][i][:dim]))
                    fh.write(" \n")


def load_regions_native(fname: str, device=None) -> Dict[str, Dict[str, Features]]:
    """Parse the native hierarchical format (reference LoadRegions,
    imagerepresentation.cpp:1318-1354): {det: {desc: Features}} with det ==
    reproj (only the original frame is stored)."""
    out: Dict[str, Dict[str, Features]] = {}
    with open(fname) as fh:
        toks = fh.read().split("\n")
    pos = 0

    def line():
        nonlocal pos
        while pos < len(toks) and not toks[pos].strip():
            pos += 1
        pos += 1
        return toks[pos - 1].strip()

    for _ in range(int(line())):
        name, n_maps = line().rsplit(" ", 1)
        dmap: Dict[str, Features] = {}
        for _ in range(int(n_maps)):
            dname, n_reg = line().rsplit(" ", 1)
            n = int(n_reg)
            dim = int(line()) if n > 0 else 0
            xy = np.zeros((n, 2), np.float32)
            A = np.zeros((n, 2, 2), np.float32)
            s = np.zeros(n, np.float32)
            desc = np.zeros((n, max(dim, 1)), np.float32)
            for i in range(n):
                vals = line().split()
                xy[i] = (float(vals[0]), float(vals[1]))
                s[i] = float(vals[2])
                A[i] = ((float(vals[3]), float(vals[4])),
                        (float(vals[5]), float(vals[6])))
                d = int(float(vals[7]))
                if d:
                    desc[i, :d] = [float(v) for v in vals[8:8 + d]]
            dmap[dname] = _features(xy, A, s, np.zeros(n), desc, device)
        out[name] = dmap
    return out


def save_regions_native_ext(fname: str, store: Dict[str, Dict[str, Features]],
                            img_id: int = 1) -> None:
    """The extended native format that the reference's LoadRegions/loadAR
    parses (imagerepresentation.cpp:237-253; the reference's own
    SaveRegions output is not loadable by its LoadRegions):

        id img_id img_reproj_id parent_id
        [det_kp:    x y a11 a12 a21 a22 pyramid_scale octave s sub_type]
        [reproj_kp: same 10 fields]
        <dim> <values...>
    """
    with open(fname, "w") as fh:
        fh.write(f"{len(store)}\n")
        for det, dmap in store.items():
            fh.write(f"{det} {len(dmap)}\n")
            for desc_name, f in dmap.items():
                d = features_dense(f)
                n = len(d["s"])
                dim = d["desc"].shape[1] if n and desc_name != "None" else 0
                fh.write(f"{desc_name} {n}\n")
                fh.write(f"{dim}\n")
                for i in range(n):
                    A = d["A"][i]
                    kp = [d["xy"][i, 0], d["xy"][i, 1],
                          A[0, 0], A[0, 1], A[1, 0], A[1, 1],
                          d["s"][i], 0, d["s"][i], 0]
                    fh.write(_g([i, img_id, 0, 0] + kp + kp + [dim]))
                    if dim:
                        fh.write(" " + _g(d["desc"][i][:dim]))
                    fh.write("\n")


# --------------------------------------------------------------------------- #
# Benchmark exports (the OxAff evaluation protocol's files)
# --------------------------------------------------------------------------- #
def _dense_both_frames(f: Features):
    """The valid rows in both frames: (reproj fields, det fields)."""
    v = _np(f.valid)
    return [tuple(_np(t).astype(np.float64)[v] for t in (kp.xy, kp.A, kp.s))
            for kp in (f.reproj, f.det)]


def save_regions_benchmark(store: Dict[str, Dict[str, Features]],
                           fname1: str, fname2: str) -> None:
    """reference SaveRegionsBenchmark (imagerepresentation.cpp:1556-1603):
    fname1 gets the original frame's lines, fname2 the detection frame's,
    each `x y s a11 a12 a21 a22` (saveKPBench, :109-111), count first.
    Exports the "None" sets (the detections without descriptors)."""
    rows1, rows2 = [], []
    for dmap in store.values():
        f = dmap.get("None")
        if f is None:
            continue
        for ff in (f if isinstance(f, list) else [f]):
            (rxy, rA, rs), (dxy, dA, ds) = _dense_both_frames(ff)
            for i in range(len(rs)):
                rows1.append((rxy[i, 0], rxy[i, 1], rs[i], rA[i, 0, 0],
                              rA[i, 0, 1], rA[i, 1, 0], rA[i, 1, 1]))
                rows2.append((dxy[i, 0], dxy[i, 1], ds[i], dA[i, 0, 0],
                              dA[i, 0, 1], dA[i, 1, 0], dA[i, 1, 1]))
    with open(fname1, "w") as f1, open(fname2, "w") as f2:
        f1.write(f"{len(rows1)}\n")
        f2.write(f"{len(rows2)}\n")
        for r in rows1:
            f1.write(_g(r) + "\n")
        for r in rows2:
            f2.write(_g(r) + "\n")


def save_descriptors_benchmark(store: Dict[str, Dict[str, Features]],
                               fname: str) -> None:
    """reference SaveDescriptorsBenchmark (imagerepresentation.cpp:1515-1554):
    one descriptor a line, of every set but "None" (the JAX package's
    per-map loop, not the reference's over-reading nested loop)."""
    with open(fname, "w") as fh:
        for dmap in store.values():
            for desc_name, f in dmap.items():
                if desc_name == "None":
                    continue
                for ff in (f if isinstance(f, list) else [f]):
                    for row in features_dense(ff)["desc"]:
                        fh.write(_g(row) + "\n")


# --------------------------------------------------------------------------- #
# ReadAffs: the pseudo-detector's keypoints from a file
# --------------------------------------------------------------------------- #
def load_affs_text(fname: str, device=None) -> Features:
    """reference ReadAffs text format (imagerepresentation.cpp:746-770):
    the count, then `x y s a11 a12 a21 a22` a line; response 100."""
    with open(fname) as fh:
        toks = fh.read().split()
    n = int(toks[0])
    vals = np.asarray([float(t) for t in toks[1:1 + 7 * n]], np.float64).reshape(n, 7)
    return _features(vals[:, :2], vals[:, 3:7].reshape(n, 2, 2), vals[:, 2],
                     np.full(n, 100.0), np.zeros((n, 128)), device)


def load_affs(fname: str, device=None) -> Features:
    """ReadAffs (imagerepresentation.cpp:741-771): .npz as
    PreLoadRegionsNPZ reads it, text otherwise."""
    if fname.endswith(".npz"):
        return load_npz(fname, device)
    return load_affs_text(fname, device)
