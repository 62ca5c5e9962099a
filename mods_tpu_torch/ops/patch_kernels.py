"""Patch resampling and Baumberg kernels: CUDA wrappers + plain versions.

Counterparts of the four Pallas kernels of the JAX package's
ops/pallas_patch.py.  Each wrapper below takes its plain PyTorch version
for tensors on the CPU, and for CUDA tensors launches its kernel from
csrc/patch_kernels.cu or raises; nothing falls back.  `LAUNCHES` counts
the kernel launches of each wrapper (plain-version calls do not count),
those of ops/octave_extrema.py's wrapper too (five a call), whose kernels
the same library holds.

| wrapper          | replaces (pallas_patch.py)            | CUDA entry   |
| ---------------- | ------------------------------------- | ------------ |
| dma_baumberg     | dma_baumberg / _dma_baumberg_kernel   | baumberg_pyr |
| dma_hat_resample | dma_hat_resample / _dma_resample_kernel | resample_pyr |
| baumberg_windows | baumberg_pallas / _baumberg_kernel    | baumberg_win |
| hat_resample     | hat_resample / _resample_kernel       | resample_win |

What bounds them on the card, and what the design does about it:

- Resample is bound by bytes on paper: each output sample is 4 gathered
  reads and ~40 float operations, and the [n, P, P] output dominates the
  traffic (220 MB at P=41, n=32768; a launch of dead rows runs at the
  card's write rate).  What a live keypoint costs on the card is
  instructions issued and the latency of its chain (read the row, plan,
  copy, sample).  Both resamplers therefore give one small block to
  one keypoint, so that many are resident in different phases: one warp
  reads the keypoint's row and plans it (its box, `footprint_boxes`),
  the block stages the box into shared memory with coalesced cp.async
  copies (16 bytes wide where the source's rows allow it), a thread owns
  a patch column and walks over rows with taps from shared memory, the
  window test is left out of the loop where the patch's extreme
  positions pass it, and the output leaves as coalesced streaming
  stores.  Dead rows and patches that miss their window are zero-filled
  without touching the source; a box larger than the staging buffer
  takes its taps from global memory in the same kernel.  The two differ
  in the window source only: dma_hat_resample reads a [L,H,W] stack in
  place (x taps first, a live column), hat_resample precropped windows
  (y taps first, no live column).  A window is contiguous and read once,
  so there staging pays for wide patches only: `win_stage_floats` gives
  patches narrower than `WIN_STAGE_MIN_P` no buffer, and their taps come
  from global memory in the same kernel.  Neither builds hat matrices
  (the TPU built those only to feed its MXU).
- Baumberg is bound by latency: a chain of up to max_iter dependent
  iterations per keypoint, a few KB read and 20 bytes written; a launch
  lasts as long as its slowest keypoints.  In dma_baumberg one warp runs
  one keypoint: a lane samples 12 of the 19x19 positions (unrolled, their
  taps in flight together), the patch lives in the warp's slab of shared
  memory for the gradient, the three SMM sums are reduced by xor
  shuffles in a fixed order, and every lane computes the 2x2 update
  itself, so the loop has no block-wide barrier and no thread waits on
  another's serial section.  Blocks hold two warps, so a keypoint that
  is accepted or rejected early frees its place.  baumberg_windows runs
  the small octaves, a few hundred keypoints a launch, where the launch
  is one keypoint's chain and what counts is the length of one
  iteration: four warps share a keypoint (3 samples a thread, their taps
  read outside any branch so that the loads overlap), each warp reduces
  its sums by the same butterfly, the warps' totals meet in shared
  memory, and every thread runs the update: two barriers an iteration,
  no serial thread.

The kernels are built with nvcc at first use into mods_tpu_torch/_build/
(see `build_library`), from the sources in this repository alone.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

DMA_WIN_Y = 112
DMA_WIN_X = 256
# staging buffer of one resample_pyr block, in floats (24 KB: nine blocks
# an SM); a patch whose box is larger takes its taps from global memory
STAGE_FLOATS = 6144
# hat_resample stages a patch's box from this patch width on; narrower
# patches take their taps from global memory (timed at P 19, 25, 31, 41)
WIN_STAGE_MIN_P = 32

LAUNCHES = {"dma_baumberg": 0, "dma_hat_resample": 0,
            "baumberg_windows": 0, "hat_resample": 0, "octave_extrema": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------- #
# Build and bind
# --------------------------------------------------------------------------- #
_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "patch_kernels.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_library() -> Path:
    """Compile csrc/patch_kernels.cu into a shared library named by the
    hash of its source and NVCC_FLAGS; reuse it when it already exists.
    nvcc's own output is printed when there is any."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libpatch_kernels_{tag}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
        if (res.stdout + res.stderr).strip():
            print(res.stdout + res.stderr)
        os.replace(tmp, lib)
    return lib


def bind_library(path: Path):
    """Load a built library and declare its entries' argument types."""
    lib = ctypes.CDLL(str(path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.resample_pyr.argtypes = [P, I, I, P, P, P, P, I, I, I, I, I, I, I, P, P]
    lib.resample_win.argtypes = [P, I, P, I, I, I, I, P, P]
    lib.baumberg_pyr.argtypes = [P, I, I, P, P, P, P, I, P, I, I, F, I, I, I,
                                 P, P, P]
    lib.baumberg_win.argtypes = [P, I, P, I, P, I, I, F, I, P, P, P]
    lib.octave_extrema.argtypes = [P, I, I, I, I, F, F, F, F, P, I, *[P] * 14]
    for fn in (lib.resample_pyr, lib.resample_win, lib.baumberg_pyr,
               lib.baumberg_win, lib.octave_extrema):
        fn.restype = ctypes.c_int
    return lib


def _library():
    global _lib
    if _lib is None:
        _lib = bind_library(build_library())
    return _lib


def _on_cpu(*ts) -> bool:
    """True when every tensor lies on the CPU (take the plain version);
    False when every one lies on a CUDA device (launch the kernel)."""
    if all(t.device.type == "cpu" for t in ts):
        return True
    dev = ts[0].device
    if not all(t.device == dev for t in ts) or dev.type != "cuda":
        raise ValueError("kernel inputs must all lie on one CUDA device, "
                         f"or all on the CPU; got {[str(t.device) for t in ts]}")
    return False


def _check(t: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} with {ndim} dims, "
                         f"got {t.dtype} {tuple(t.shape)}")


def _launch(fn, device: torch.device, *args) -> None:
    """Call a C entry with `device` current (restored afterwards)."""
    with torch.cuda.device(device):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel launch failed with error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --------------------------------------------------------------------------- #
# Window origins
# --------------------------------------------------------------------------- #
def dma_window_origins(cx, cy, lw, lh):
    """Aligned (8, 128) window origins covering (cx, cy) +- 52 px, clipped
    to the level extent (lw, lh); floor division as in the JAX package."""
    oy = torch.div(torch.floor(cy).to(torch.int32) - 52, 8,
                   rounding_mode="floor") * 8
    ox = torch.div(torch.floor(cx).to(torch.int32) - 52, 128,
                   rounding_mode="floor") * 128
    oy = torch.minimum(torch.clamp(oy, min=0),
                       torch.clamp(lh - DMA_WIN_Y, min=0).to(torch.int32))
    ox = torch.minimum(torch.clamp(ox, min=0),
                       torch.clamp(lw - DMA_WIN_X, min=0).to(torch.int32))
    return oy, ox


# --------------------------------------------------------------------------- #
# Plain versions (the CPU path; on the card only for comparisons)
# --------------------------------------------------------------------------- #
def _pyr_fetch(stack, lev, oy, ox):
    lev, oy, ox = lev.long()[:, None], oy.long()[:, None], ox.long()[:, None]
    return lambda yi, xi: stack[lev, oy + yi, ox + xi]


def _win_fetch(wins):
    k = torch.arange(wins.shape[0], device=wins.device)[:, None]
    return lambda yi, xi: wins[k, yi, xi]


def _footprint(px, py, ox, oy, lw, lh, WY: int, WX: int):
    """Which window-local [n, S] positions are sampled (inside the level
    and the window: the test of pallas_patch.py:88-90, 425-428), their
    floors, and the top-left taps, clamped into the window for rejected
    samples so that a gather stays in bounds."""
    gx = px + ox[:, None]
    gy = py + oy[:, None]
    inb = ((gx >= 0.0) & (gy >= 0.0) &
           (torch.floor(gx) < lw[:, None] - 1.0) &
           (torch.floor(gy) < lh[:, None] - 1.0) &
           (px >= 0.0) & (py >= 0.0) & (px < WX - 1.0) & (py < WY - 1.0))
    fx0 = torch.floor(px)
    fy0 = torch.floor(py)
    x0 = torch.nan_to_num(fx0, nan=0.0).clamp(0, WX - 2).long()
    y0 = torch.nan_to_num(fy0, nan=0.0).clamp(0, WY - 2).long()
    return inb, fx0, fy0, x0, y0


def _sample(fetch, px, py, ox, oy, lw, lh, WY: int, WX: int, x_first: bool):
    """Exact 4-tap bilinear at window-local [n, S] positions, zero where
    `_footprint` rejects the sample."""
    inb, fx0, fy0, x0, y0 = _footprint(px, py, ox, oy, lw, lh, WY, WX)
    wx0 = 1.0 - torch.abs(px - fx0)
    wx1 = 1.0 - torch.abs(px - (fx0 + 1.0))
    wy0 = 1.0 - torch.abs(py - fy0)
    wy1 = 1.0 - torch.abs(py - (fy0 + 1.0))
    v00, v01 = fetch(y0, x0), fetch(y0, x0 + 1)
    v10, v11 = fetch(y0 + 1, x0), fetch(y0 + 1, x0 + 1)
    if x_first:
        val = (wx0 * v00 + wx1 * v01) * wy0 + (wx0 * v10 + wx1 * v11) * wy1
    else:
        val = (wy0 * v00 + wy1 * v10) * wx0 + (wy0 * v01 + wy1 * v11) * wx1
    return torch.where(inb, val, 0.0)


def _grid(P: int, device):
    c = float(P // 2)
    f = torch.arange(P * P, device=device)
    jg = (f // P).to(torch.float32) - c      # row (y)
    ig = (f % P).to(torch.float32) - c       # col (x)
    return ig[None, :], jg[None, :]


def _plain_resample(fetch, params, P: int, WY: int, WX: int, x_first: bool):
    ig, jg = _grid(P, params.device)
    pr = params
    px = pr[:, 0:1] + ig * pr[:, 2:3] + jg * pr[:, 3:4]
    py = pr[:, 1:2] + ig * pr[:, 4:5] + jg * pr[:, 5:6]
    out = _sample(fetch, px, py, pr[:, 6], pr[:, 7], pr[:, 8], pr[:, 9],
                  WY, WX, x_first)
    return out.reshape(-1, P, P)


def footprint_boxes(params, ox, P: int, WY: int, WX: int, aligned: bool):
    """The box of its window that the resample kernels stage for each
    keypoint, computed as they compute it.  params [n, >=6] (cxl cyl a00
    a01 a10 a11 ...), ox [n] int window origins in the source's row (0 for
    precropped windows, with WY = WX = the window's width), `aligned`
    whether the source allows 16-byte copies (its row a multiple of 4
    floats and its base on a 16-byte line).  Returns window-local (xlo, xhi, ylo, yhi) [n] int64,
    inclusive, and `empty` [n] bool: an empty box admits no sample (the
    kernel zero-fills).  A box of at most as many floats as the staging
    buffer, (xhi - xlo + 1) * (yhi - ylo + 1), is staged in shared memory;
    a larger one is read in place.

    Sample positions are monotone in the patch row and in the patch
    column, also after float rounding, so the floors of the four corners
    bound the floors of every sample; the taps of an admitted sample are
    floor(p) and floor(p) + 1 with 0 <= p < W - 1."""
    c = float(P // 2)
    lo, hi = -c, float(P - 1) - c
    inf = float("inf")

    def corner_range(c0, a, b):
        corners = torch.stack([c0 + lo * a + lo * b, c0 + hi * a + lo * b,
                               c0 + lo * a + hi * b, c0 + hi * a + hi * b])
        pmin = torch.floor(torch.nan_to_num(corners, nan=inf, posinf=inf,
                                            neginf=-inf).amin(0))
        pmax = torch.floor(torch.nan_to_num(corners, nan=-inf, posinf=inf,
                                            neginf=-inf).amax(0))
        # an axis whose corners are all NaN keeps the whole window
        none = torch.isnan(corners).all(0)
        return (torch.where(none, -inf, pmin), torch.where(none, inf, pmax))

    xmin, xmax = corner_range(params[:, 0], params[:, 2], params[:, 3])
    ymin, ymax = corner_range(params[:, 1], params[:, 4], params[:, 5])
    xlo = xmin.clamp(0.0, float(WX)).long()
    xhi = (xmax + 1.0).clamp(-1.0, WX - 1.0).long()
    ylo = ymin.clamp(0.0, float(WY)).long()
    yhi = (ymax + 1.0).clamp(-1.0, WY - 1.0).long()
    empty = (xhi < xlo) | (yhi < ylo)
    if aligned:
        oxl = ox.long()
        xlo = xlo - ((oxl + xlo) & 3)
        xhi = xhi + ((4 - ((oxl + xhi + 1) & 3)) & 3)
    return xlo, xhi, ylo, yhi, empty


def plain_dma_hat_resample(pyr, lev, oy, ox, params, P: int):
    out = _plain_resample(_pyr_fetch(pyr, lev, oy, ox), params, P,
                          DMA_WIN_Y, DMA_WIN_X, True)
    if params.shape[1] > 10:
        out = torch.where((params[:, 10] > 0.5)[:, None, None], out, 0.0)
    return out


def plain_hat_resample(wins, params, P: int):
    W = wins.shape[-1]
    return _plain_resample(_win_fetch(wins), params, P, W, W, False)


def _plain_baumberg(fetch, params, mask, ws: int, max_iter: int, conv: float,
                    WY: int, WX: int, x_first: bool, trace=None):
    """The Baumberg SMM iteration of pallas_patch.py:204-275, vectorized
    over keypoints with per-keypoint done masks.  When `trace` is a list,
    each iteration appends its sample positions and live rows
    (px [n, ws*ws], py, live [n]), which is what a kernel that leaves its
    loop per keypoint samples."""
    # imported here: detect/affine_shape.py imports this module
    from ..detect.affine_shape import eigenvalues_2x2, inv_sqrt_2x2
    n = params.shape[0]
    dev = params.device
    ig, jg = _grid(ws, dev)
    n_mask = float(ws * ws)
    m = mask.reshape(1, ws, ws)
    cxl, cyl, ratio = params[:, 0:1], params[:, 1:2], params[:, 2:3]
    ox, oy, lw, lh = params[:, 4], params[:, 5], params[:, 6], params[:, 7]
    one = torch.ones(n, device=dev)
    zero = torch.zeros(n, device=dev)
    u11, u12, u21, u22 = one, zero, zero, one
    o11, o12, o21, o22 = one, zero, zero, one
    ratio_bef = zero
    done = ~(params[:, 3] > 0.5)
    ok = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(max_iter):
        if bool(done.all()):
            break
        a00 = u11[:, None] * ratio
        a01 = u12[:, None] * ratio
        a10 = u21[:, None] * ratio
        a11 = u22[:, None] * ratio
        px = cxl + ig * a00 + jg * a01
        py = cyl + ig * a10 + jg * a11
        if trace is not None:
            trace.append((px, py, ~done))
        img = _sample(fetch, px, py, ox, oy, lw, lh, WY, WX,
                      x_first).reshape(n, ws, ws)
        gx = torch.cat([img[:, :, 1:2] - img[:, :, 0:1],
                        img[:, :, 2:] - img[:, :, :-2],
                        img[:, :, -1:] - img[:, :, -2:-1]], dim=2)
        gy = torch.cat([img[:, 1:2, :] - img[:, 0:1, :],
                        img[:, 2:, :] - img[:, :-2, :],
                        img[:, -1:, :] - img[:, -2:-1, :]], dim=1)
        a = (gx * gx * m).sum(dim=(1, 2)) / n_mask
        b = (gx * gy * m).sum(dim=(1, 2)) / n_mask
        cc = (gy * gy * m).sum(dim=(1, 2)) / n_mask
        na, nb, nc, l1, l2 = inv_sqrt_2x2(a, b, cc)
        nan_bad = ~(torch.isfinite(na) & torch.isfinite(nb) & torch.isfinite(nc))
        ratio_act = 1.0 - l2 / l1
        v11 = na * u11 + nb * u21
        v12 = na * u12 + nb * u22
        v21 = nb * u11 + nc * u21
        v22 = nb * u12 + nc * u22
        eok, e1, e2 = eigenvalues_2x2(v11, v12, v21, v22)
        aniso_bad = (~eok) | (e1 / e2 > 6.0) | (e2 / e1 > 6.0)
        converged = (ratio_act < conv) & (ratio_bef < conv)
        accept_now = (~done) & (~nan_bad) & (~aniso_bad) & converged
        reject_now = (~done) & (nan_bad | aniso_bad)
        o11 = torch.where(accept_now, v11, o11)
        o12 = torch.where(accept_now, v12, o12)
        o21 = torch.where(accept_now, v21, o21)
        o22 = torch.where(accept_now, v22, o22)
        ok = ok | accept_now
        u11 = torch.where(done, u11, v11)
        u12 = torch.where(done, u12, v12)
        u21 = torch.where(done, u21, v21)
        u22 = torch.where(done, u22, v22)
        ratio_bef = torch.where(done, ratio_bef, ratio_act)
        done = done | accept_now | reject_now
    U = torch.stack([o11, o12, o21, o22], dim=-1).reshape(n, 2, 2)
    return U, ok


def plain_dma_baumberg(stack, lev, oy, ox, params, mask, ws: int,
                       max_iter: int, conv: float, trace=None):
    return _plain_baumberg(_pyr_fetch(stack, lev, oy, ox), params, mask, ws,
                           max_iter, conv, DMA_WIN_Y, DMA_WIN_X, True, trace)


def plain_baumberg_windows(wins, params, mask, ws: int, max_iter: int,
                           conv: float, trace=None):
    W = wins.shape[-1]
    return _plain_baumberg(_win_fetch(wins), params, mask, ws, max_iter, conv,
                           W, W, False, trace)


# --------------------------------------------------------------------------- #
# Wrappers
# --------------------------------------------------------------------------- #
def _check_pyr_args(stack, lev, oy, ox, params, min_cols):
    n = lev.shape[0]
    _check(stack, "stack", torch.float32, 3)
    for t, name in ((lev, "lev"), (oy, "oy"), (ox, "ox")):
        _check(t, name, torch.int32, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name}: want {n} rows, got {t.shape[0]}")
    _check(params, "params", torch.float32, 2)
    if params.shape[0] != n or params.shape[1] < min_cols:
        raise ValueError(f"params: want [{n}, >={min_cols}], got "
                         f"{tuple(params.shape)}")
    if stack.shape[1] < DMA_WIN_Y or stack.shape[2] < DMA_WIN_X:
        raise ValueError(f"stack {tuple(stack.shape)} smaller than the "
                         f"{DMA_WIN_Y}x{DMA_WIN_X} window")


def dma_hat_resample(pyr, lev, oy, ox, params, P: int):
    """pyr [L,H,W] + per-keypoint level / aligned window origin (oy, ox)
    + params [n, 10 or 11] (cxl cyl a00 a01 a10 a11 ox oy lw lh [live])
    -> patches [n, P, P].  Replaces pallas_patch.dma_hat_resample."""
    if _on_cpu(pyr, lev, oy, ox, params):
        return plain_dma_hat_resample(pyr, lev, oy, ox, params, P)
    if P < 1:
        raise ValueError(f"P {P}: want P >= 1")
    _check_pyr_args(pyr, lev, oy, ox, params, 10)
    n = lev.shape[0]
    out = torch.empty((n, P, P), dtype=torch.float32, device=pyr.device)
    live_col = 10 if params.shape[1] > 10 else -1
    _launch(_library().resample_pyr, pyr.device, pyr.data_ptr(), pyr.shape[1],
            pyr.shape[2], lev.data_ptr(), oy.data_ptr(), ox.data_ptr(),
            params.data_ptr(), params.shape[1], live_col, n, P, DMA_WIN_Y,
            DMA_WIN_X, STAGE_FLOATS, out.data_ptr(), _stream(pyr))
    LAUNCHES["dma_hat_resample"] += 1
    return out


def win_stage_floats(P: int) -> int:
    """The staging buffer hat_resample gives a block for patches of width
    P, in floats (0: taps from global memory).  A precropped window is
    contiguous and read once, so copying its box first pays only where a
    patch has many samples to a box: from WIN_STAGE_MIN_P."""
    return STAGE_FLOATS if P >= WIN_STAGE_MIN_P else 0


def _launch_resample_win(wins, params, P: int, stage_floats: int):
    """resample_win with a staging buffer of `stage_floats` floats a block."""
    _check(wins, "wins", torch.float32, 3)
    _check(params, "params", torch.float32, 2)
    n, W = wins.shape[0], wins.shape[-1]
    if params.shape[0] != n or params.shape[1] < 10 or wins.shape[1] != W:
        raise ValueError(f"wins {tuple(wins.shape)} / params "
                         f"{tuple(params.shape)} do not match")
    if P < 1 or W < 2:
        raise ValueError(f"P {P}, window width {W}: want P >= 1 and windows "
                         "of at least 2x2")
    out = torch.empty((n, P, P), dtype=torch.float32, device=wins.device)
    _launch(_library().resample_win, wins.device, wins.data_ptr(), W,
            params.data_ptr(), params.shape[1], n, P, stage_floats,
            out.data_ptr(), _stream(wins))
    return out


def hat_resample(wins, params, P: int):
    """wins [n, W, W] + params [n, >=10] -> patches [n, P, P].
    Replaces pallas_patch.hat_resample."""
    if _on_cpu(wins, params):
        return plain_hat_resample(wins, params, P)
    out = _launch_resample_win(wins, params, P, win_stage_floats(P))
    LAUNCHES["hat_resample"] += 1
    return out


def _baumberg_out(n, device):
    return (torch.empty((n, 2, 2), dtype=torch.float32, device=device),
            torch.empty((n,), dtype=torch.bool, device=device))


def _check_mask(mask, ws):
    _check(mask, "mask", torch.float32, 2)
    if tuple(mask.shape) != (ws, ws) or not 2 <= ws <= 32:
        raise ValueError(f"mask {tuple(mask.shape)} / ws {ws}: want "
                         "[ws, ws] with 2 <= ws <= 32")


def dma_baumberg(stack, lev, oy, ox, params, mask, ws: int, max_iter: int,
                 conv: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """stack [L,H,W] + per-keypoint level / aligned origin + params [n, 8]
    (cxl cyl ratio valid ox oy lw lh) + mask [ws, ws] -> (U [n,2,2], ok [n]).
    Replaces pallas_patch.dma_baumberg."""
    if _on_cpu(stack, lev, oy, ox, params, mask):
        return plain_dma_baumberg(stack, lev, oy, ox, params, mask, ws,
                                  max_iter, conv)
    _check_pyr_args(stack, lev, oy, ox, params, 8)
    _check_mask(mask, ws)
    n = lev.shape[0]
    U, ok = _baumberg_out(n, stack.device)
    _launch(_library().baumberg_pyr, stack.device, stack.data_ptr(),
            stack.shape[1], stack.shape[2], lev.data_ptr(), oy.data_ptr(),
            ox.data_ptr(), params.data_ptr(), params.shape[1], mask.data_ptr(),
            ws, max_iter, float(conv), n, DMA_WIN_Y, DMA_WIN_X, U.data_ptr(),
            ok.data_ptr(), _stream(stack))
    LAUNCHES["dma_baumberg"] += 1
    return U, ok


def baumberg_windows(wins, params, mask, ws: int, max_iter: int,
                     conv: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """wins [n, W, W] + params [n, 8] + mask [ws, ws] -> (U, ok).
    Replaces pallas_patch.baumberg_pallas."""
    if _on_cpu(wins, params, mask):
        return plain_baumberg_windows(wins, params, mask, ws, max_iter, conv)
    _check(wins, "wins", torch.float32, 3)
    _check(params, "params", torch.float32, 2)
    _check_mask(mask, ws)
    n, W = wins.shape[0], wins.shape[-1]
    if params.shape[0] != n or params.shape[1] < 8 or wins.shape[1] != W:
        raise ValueError(f"wins {tuple(wins.shape)} / params "
                         f"{tuple(params.shape)} do not match")
    if W < 2:
        raise ValueError(f"window width {W}: want windows of at least 2x2")
    U, ok = _baumberg_out(n, wins.device)
    _launch(_library().baumberg_win, wins.device, wins.data_ptr(), W,
            params.data_ptr(), params.shape[1], mask.data_ptr(), ws, max_iter,
            float(conv), n, U.data_ptr(), ok.data_ptr(), _stream(wins))
    LAUNCHES["baumberg_windows"] += 1
    return U, ok
