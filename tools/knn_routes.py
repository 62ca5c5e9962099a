#!/usr/bin/env python3
"""Times the port's two exact kNN routes against each other on one card.

    python3 tools/knn_routes.py [--sizes 32768 65536 131072] [--device cuda]

`match.matching._knn` works through 4096 query rows at a time against the
whole database; `match.matching.knn_streaming` takes every query row
against 8192 database rows at a time and merges a running top-k.  Both
give the same lists, ties lower index first.  For each size N (an N x N
problem) the script makes SIFT-like integer descriptors (128 values in
0..255, zero rows where a row is padding) with the valid-row counts of
the paths that send that size, runs the two routes in turns (dense,
streamed, streamed, dense) with TF32 off, as match_fginn runs them, and
prints one JSON line per size: each route's device ms (between two CUDA
events, the mean of its two runs), its peak of allocated memory above
what the inputs hold, and whether the two routes' outputs are equal.
The first line is the card's name and power limit from nvidia-smi.

Valid rows per size, of the paths that send it (chip_smoke.py): 32768,
the flagship 640x800 pair (7253 and 7365 of 4096 x 8 rows); 65536, MODS
step 0 (14411 and 1445 of 8192 x 8); 131072, MODS step 1 (26200 and
6580 of the two view sets' 16 x 8192 rows).
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = HERE   # the repository root in place of this script's directory

from mods_tpu_torch import full_float32, resolve_device  # noqa: E402
from mods_tpu_torch.match import matching  # noqa: E402

VALID = {32768: (7253, 7365), 65536: (14411, 1445), 131072: (26200, 6580)}
K = 50   # MatchPars().knn


def descriptors(rng, n, n_valid, device):
    d = np.zeros((n, 128), np.float32)
    d[:n_valid] = rng.integers(0, 256, (n_valid, 128))
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    perm = rng.permutation(n)    # padding spread through the rows, as views interleave it
    return (torch.from_numpy(d[perm]).to(device),
            torch.from_numpy(valid[perm]).to(device))


def run(fn, device):
    """(device ms, peak bytes allocated above the start, output) of one call."""
    if device.type != "cuda":
        out = fn()
        return None, None, out
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), torch.cuda.max_memory_allocated() - base, out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=sorted(VALID))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()[0]
        print(f"card: {smi}")
    rng = np.random.default_rng(0)
    for n in args.sizes:
        v1, v2 = VALID.get(n, (n // 4, n // 4))
        d1, _ = descriptors(rng, n, v1, device)
        d2, valid2 = descriptors(rng, n, v2, device)
        routes = {
            "dense": lambda: matching._knn(d1, d2, valid2, K, True),
            "streamed": lambda: matching.knn_streaming(d1, d2, valid2, K, 8192, True),
        }
        with full_float32():
            routes["dense"]()       # warm: cuBLAS handles, allocator
            ms = {r: [] for r in routes}
            peak, outs = {}, {}
            for r in ("dense", "streamed", "streamed", "dense"):
                t, p, outs[r] = run(routes[r], device)
                ms[r].append(t)
                peak[r] = p
        equal = all(torch.equal(a, b) for a, b in zip(outs["dense"], outs["streamed"]))
        row = dict(n=n, valid=[v1, v2], k=K, equal=equal)
        for r in routes:
            row[f"{r}_ms"] = None if ms[r][0] is None else sum(ms[r]) / 2
            row[f"{r}_runs_ms"] = ms[r]
            row[f"{r}_peak_gb"] = None if peak[r] is None else peak[r] / 1e9
        print(json.dumps(row))
        if not equal:
            return 1
        del d1, d2, valid2, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())
