#!/usr/bin/env python3
"""The readings that a cell's limits for `correct` are set from.

    python3 portbench/readings.py --workload <name> --seeds 11,12,... [--control 3]

For each seed: the cell's pool of pairs, as run.py makes it; the program
(mods_tpu_torch.twoview.match_images on the card) on every pool pair,
reporting each pair's steps, inliers and corner error against the true H;
the plain reference on the pair that run.py would judge for that seed,
and the numbers of pbcore.compare, program against reference (the lower
readings).  On the first `--control` seeds also the control: the
reference computed one precision below the configuration's float32 (TF32
on for matmuls and convolutions), held against the reference in the same
way (the upper readings).  One JSON line a seed on standard output, and a
summary of each number's largest program reading and smallest control
reading at the end.  The benchmark's own runs do not run this."""
import argparse
import json
import sys
import time
from pathlib import Path

PB = Path(__file__).resolve().parent
if str(PB) not in sys.path:
    sys.path.insert(0, str(PB))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control", type=int, default=3,
                    help="the control on this many of the first seeds")
    args = ap.parse_args(argv)

    import run
    run.set_env()
    import torch

    from pbcore import compare, spec as pbspec
    from pbcore.draws import PairDraws
    from pbcore.pairs import corner_error, pool_seeds, sampled_index
    from pbcore.portcfg import build_config
    from mods_tpu_torch import config as pcfg
    from mods_tpu_torch.twoview import match_images
    import reference

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    bench = pbspec.load_benchmark()
    wl = pbspec.workload(bench, args.workload)
    spec = pbspec.config(bench, wl["config"])
    traffic = pbspec.traffic(wl["traffic"])
    gen = pbspec.generator(traffic["generator"])
    cfg = build_config(pcfg, spec)
    ver = spec.get("ver_type", "LORANSAC")
    # warm-up, as run.py's set-up: the first call of a process is not judged
    w1, w2, _ = gen.make(traffic["params"], pool_seeds(0, 1)[0])
    match_images(w1, w2, cfg, device=dev, ver_type=ver, draws=PairDraws(0, 0, dev))
    torch.cuda.synchronize(dev)
    lows, highs = [], []
    for si, seed in enumerate(int(s) for s in args.seeds.split(",")):
        pool = [gen.make(traffic["params"], s) for s in pool_seeds(seed, int(traffic["pool"]))]
        k = sampled_index(seed, len(pool))
        line = dict(seed=seed, judged=k, pool=[])
        prog = None
        for i, (img1, img2, H_true) in enumerate(pool):
            t = time.perf_counter()
            res = match_images(img1, img2, cfg, device=dev, ver_type=ver,
                               draws=PairDraws(seed, i, dev))
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t) * 1e3
            line["pool"].append(dict(steps=res.steps_done, inliers=res.inliers,
                                     step0_inliers=res.per_step[0]["inliers"],
                                     corner_px=corner_error(res.H, H_true, *img1.shape),
                                     ms=ms))
            if i == k:
                prog = compare.summarize(res, spec["descriptor"])
            del res
        torch.cuda.empty_cache()
        img1, img2, H_true = pool[k]
        t = time.perf_counter()
        ref = compare.summarize(reference.match_pair(
            img1, img2, spec, PairDraws(seed, k, dev), dev), spec["descriptor"])
        line["reference_s"] = time.perf_counter() - t
        line["program"] = compare.numbers(prog, ref, H_true, *img1.shape,
                                          ver_type=ver)
        lows.append(line["program"])
        if si < args.control:
            t = time.perf_counter()
            ctl = compare.summarize(reference.match_pair(
                img1, img2, spec, PairDraws(seed, k, dev), dev, tf32=True),
                spec["descriptor"])
            line["control_s"] = time.perf_counter() - t
            line["control"] = compare.numbers(ctl, ref, H_true, *img1.shape,
                                              ver_type=ver)
            highs.append(line["control"])
        print(json.dumps(line), flush=True)
    summary = {n: dict(lower=max(r[n] for r in lows),
                       upper=min(r[n] for r in highs) if highs else None)
               for n in lows[0]}
    print(json.dumps(dict(workload=args.workload, device=torch.cuda.get_device_name(dev),
                          power_limit=run.power_limit(), summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
