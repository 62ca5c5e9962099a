#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (a workload of BENCHMARK.json) names a configuration
(configs/<config>.json) and a traffic mix (traffic/<traffic>.json).  Set-up
makes the mix's pool of pairs from the seed, builds the configuration, and
matches one pair of the pool to warm up.  The window then matches the pool's
pairs one after another with `mods_tpu_torch.twoview.match_images` on the
card (a closed loop with one client), for `--seconds`, and on until the
pool has been cycled a whole number of times: every pool pair weighs
alike in the rate.  With --trace 1 the window runs
under torch.profiler and the line holds the cell's per-layer metrics
(metrics/<name>.py), else its end-to-end metrics.  Once the window has
closed, one pair that it finished, drawn from the seed, is matched by the
plain reference (reference/) with the same configuration and RANSAC draws,
and the numbers that limits/<workload>.json names decide `correct`.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device (and with --trace 1 breakdown), and last `checks`:
each compared number beside its limit, which also end standard error."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

PB = Path(__file__).resolve().parent
ROOT = PB.parent
for _p in (ROOT, PB):            # the program's package, then the harness's
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

# top-level module names that may not be loaded in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "mods_tpu")
SPANS = ("SynthTime", "DetectTime", "OrientTime", "DescTime", "MatchTime",
         "MiscTime", "RANSACTime")
WINDOW_SPAN = "portbench.window"


def set_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX; and no opt-in to random CNN weights, which
    would let a missing weights file pass unseen."""
    cache = ROOT / ".pbcache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("MODS_TPU_ALLOW_RANDOM_CNN", None)


def forbidden_modules():
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def pair_record(res, ms: float) -> dict:
    tl = res.timelog
    return dict(ms=ms, per_step=[dict(d) for d in res.per_step],
                timelog={k: float(getattr(tl, k)) for k in SPANS})


def run_cell(spec: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, trace: bool, device, metrics: list,
             match_fn=None, t_start: float = T_START) -> dict:
    """One run of the cell.  `metrics`: the BENCHMARK.json entries it
    reports (end-to-end without trace, per-layer with it).  `match_fn`
    replaces the program's match_images (tests plant faults with it)."""
    import numpy as np
    import torch

    from pbcore import compare, spec as pbspec
    from pbcore.draws import PairDraws
    from pbcore.pairs import pool_seeds, sampled_index
    from pbcore.portcfg import build_config

    from mods_tpu_torch import config as pcfg
    from mods_tpu_torch.twoview import match_images
    import reference

    match_fn = match_fn or match_images
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    cfg = build_config(pcfg, spec)
    gen = pbspec.generator(traffic["generator"])
    pool = [gen.make(traffic["params"], s) for s in pool_seeds(seed, int(traffic["pool"]))]
    ver = spec.get("ver_type", "LORANSAC")

    def one(i):
        img1, img2, _ = pool[i]
        return match_fn(img1, img2, cfg, device=device, ver_type=ver,
                        draws=PairDraws(seed, i, device))

    one(0)                      # warm-up: one pair of the cell's own shape
    sync()
    setup_s = time.perf_counter() - t_start

    pairs, last, failed, attempted = [], {}, 0, 0
    prof = None
    with contextlib.ExitStack() as window:
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function
            prof = window.enter_context(
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            window.enter_context(record_function(WINDOW_SPAN))
        t0 = time.perf_counter()
        t_end = t0
        while time.perf_counter() - t0 < seconds or attempted % len(pool):
            i = attempted % len(pool)
            attempted += 1
            ts = time.perf_counter()
            try:
                res = one(i)
                sync()
            except Exception:             # a pair that raises has failed
                failed += 1
                print(f"pair {attempted - 1} (pool {i}) failed:\n{traceback.format_exc()}",
                      file=sys.stderr)
                continue
            t_end = time.perf_counter()
            pairs.append(pair_record(res, (t_end - ts) * 1e3))
            last[i] = res                 # the newest answer of each pool pair
            del res
    window_s = t_end - t0
    print("pair ms: " + " ".join(f"{p['ms']:.1f}" for p in pairs), file=sys.stderr)
    reduced = None
    if prof is not None and cuda:
        from pbcore.trace import reduce_profile
        reduced = reduce_profile(prof, SPANS, WINDOW_SPAN)
    del prof
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    # the answer judged: one pool pair that the window finished, drawn from
    # the seed; then the program's state goes before the reference runs
    done = sorted(last)
    nums, rows, correct = {}, [], False
    if done:
        k = done[sampled_index(seed, len(done))]
        prog = compare.summarize(last[k], spec["descriptor"])
        last.clear()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        img1, img2, H_true = pool[k]
        try:
            ref = compare.summarize(reference.match_pair(
                img1, img2, spec, PairDraws(seed, k, device), device),
                spec["descriptor"])
        except Exception:                 # no reference answer: not correct
            print(f"the reference failed:\n{traceback.format_exc()}", file=sys.stderr)
        else:
            nums = compare.numbers(prog, ref, H_true, *img1.shape, ver_type=ver)
            correct, rows = compare.judge(nums, limits["limits"])
    correct = bool(correct and failed == 0 and pairs)

    record = dict(pairs=pairs, trace=reduced, spec=spec)
    values = {}
    if not trace:
        lat = [p["ms"] for p in pairs]
        e2e = dict(pairs_per_s=len(pairs) / window_s if window_s > 0 else None,
                   pair_ms_p90=float(np.percentile(lat, 90)) if lat else None,
                   setup_s=setup_s)
        for m in metrics:
            values[m["name"]] = e2e[m["name"]]
    else:
        for m in metrics:
            values[m["name"]] = pbspec.metric(m["name"]).read(record)
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics={m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                        for m in metrics if values[m["name"]] is not None},
               device=dict(platform="gpu" if cuda else device.type,
                           kind=torch.cuda.get_device_name(device) if cuda else "cpu",
                           count=1, memory_peak_bytes=peak))
    if cuda:
        out["device"]["power_limit"] = power_limit()
    if reduced is not None:
        out["device"]["busy_s"] = reduced["busy_s"]
        out["device"]["window_s"] = reduced["window_s"]
        out["breakdown"] = dict(device_ops=reduced["device_ops"],
                                idle_gaps=reduced["idle_gaps"])
    out["numbers"] = nums
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_env()

    from pbcore import spec as pbspec
    bench = pbspec.load_benchmark()
    wl = pbspec.workload(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    kind = "per_layer" if args.trace else "end_to_end"
    out = run_cell(pbspec.config(bench, wl["config"]), pbspec.traffic(wl["traffic"]),
                   pbspec.limits(wl["name"]), args.seed, args.seconds, bool(args.trace),
                   "cuda:0", pbspec.cell_metrics(bench, wl["name"], kind))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules that may not load were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
