"""One octave's extrema search, localization and duplicate map, in one call.

`octave_extrema` returns what detect/pyramid.py's find_extrema ->
localize -> dedup_octave_map chain returns for an octave's [L,H,W]
response stack.  CPU tensors take that chain itself, unchanged (the plain
version); CUDA tensors launch the five kernels of csrc/patch_kernels.cu
(`octave_extrema` entry: mark and count, scan, scatter, localize and
claim, keep) on the current stream, or raise; nothing falls back.

Eagerly the chain makes about 900 small launches an octave, whatever the
octave's size, and torch.nonzero makes the host wait for the device once
an octave; the device work behind them is one read of the stack and a
few hundred flops a candidate.  The kernels make five launches and no
host read: the number of extrema stays on the device.  They keep the
plain version's results bit for bit on the card: the scan order and the
cap, NaN anywhere among the 27 values making no extremum, the rows and
columns wrapping as torch.roll does, localize's float expressions in its
order with one rounding per ATen op, padded slots at flat index 0, and
the first accepted candidate in scan order keeping its cell.
"""
from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from ..config import PyramidParams
from ..detect import pyramid as pyr
from . import patch_kernels as pk

TILE = 1024          # cells of a tile of the mark and scatter kernels (kExtTile)
MAX_LEVELS = 32      # levels an octave may have (kExtMaxLevels)
LAUNCHES_PER_CALL = 5


def plain_octave_extrema(resp: torch.Tensor, par: PyramidParams, max_cands: int,
                         sigmas: List[float]):
    """The plain version: find_extrema -> localize -> dedup_octave_map."""
    lev, r0, c0, cand_valid, n_ext = pyr.find_extrema(resp, par, max_cands)
    # localize does not read the blur stack
    okp, r, c = pyr.localize(resp, None, lev, r0, c0, cand_valid, par, sigmas)
    return okp, r, c, pyr.dedup_octave_map(r, c, okp.valid, resp.shape[-1]), n_ext


def octave_extrema(resp: torch.Tensor, par: PyramidParams, max_cands: int,
                   sigmas: List[float]):
    """resp [L,H,W] float32, the octave's sigmas [L] -> (OctaveKeypoints
    with localize's valid, final r, final c, valid after the duplicate
    map, n_extrema), k = min(max_cands, (L-2)*H*W) rows each.  n_extrema
    is an int on the CPU and a 0-d int32 tensor on the card."""
    if pk._on_cpu(resp):
        return plain_octave_extrema(resp, par, max_cands, sigmas)
    pk._check(resp, "resp", torch.float32, 3)
    L, H, W = resp.shape
    if not 3 <= L <= MAX_LEVELS or len(sigmas) != L or H < 1 or W < 1:
        raise ValueError(f"resp {tuple(resp.shape)} with {len(sigmas)} sigmas: want "
                         f"3..{MAX_LEVELS} levels, one sigma each")
    if L * H * W > 2 ** 31 - 1 - TILE:
        raise ValueError(f"resp {tuple(resp.shape)}: more cells than int32 indexes")
    n = (L - 2) * H * W
    k = min(max_cands, n)
    if k < 1:
        raise ValueError(f"max_cands {max_cands}: want at least 1")
    n_words, n_tiles = -(-n // 32), -(-n // TILE)
    dev = resp.device
    ints = torch.empty(4 * k + 1 + n_words + n_tiles + H * W, dtype=torch.int32,
                       device=dev)
    level, r, c, idx = (ints[i * k:(i + 1) * k] for i in range(4))
    n_ext = ints[4 * k]
    words = ints[4 * k + 1:4 * k + 1 + n_words]
    tiles = ints[4 * k + 1 + n_words:4 * k + 1 + n_words + n_tiles]
    cell_map = ints[4 * k + 1 + n_words + n_tiles:]
    floats = torch.empty(4 * k, dtype=torch.float32, device=dev)
    rc, scale, response = floats[:2 * k].view(k, 2), floats[2 * k:3 * k], floats[3 * k:]
    flags = torch.empty(2 * k, dtype=torch.bool, device=dev)
    valid, kept = flags[:k], flags[k:]
    # the kernels compare in float32, as ATen does with a Python scalar
    pos_th, edge_th, final_th = pyr.thresholds(par)
    # ATen divides a CUDA tensor by a CPU scalar as a product with its
    # float reciprocal
    inv_scales = float(np.float32(1.0) / np.float32(par.numberOfScales))
    sig = (ctypes.c_float * L)(*sigmas)
    pk._launch(pk._library().octave_extrema, dev, resp.data_ptr(), L, H, W,
               par.border, pos_th, edge_th, final_th, inv_scales, sig, k,
               words.data_ptr(), tiles.data_ptr(), n_ext.data_ptr(), idx.data_ptr(),
               cell_map.data_ptr(), rc.data_ptr(), level.data_ptr(), scale.data_ptr(),
               response.data_ptr(), valid.data_ptr(), r.data_ptr(), c.data_ptr(),
               kept.data_ptr(), pk._stream(resp))
    pk.LAUNCHES["octave_extrema"] += LAUNCHES_PER_CALL
    okp = pyr.OctaveKeypoints(rc=rc, level=level, scale=scale, response=response,
                              valid=valid)
    return okp, r, c, kept, n_ext
