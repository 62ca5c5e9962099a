"""Train HardNet from synthesized patch pairs and save the weights.

    python -m mods_tpu_torch.tools.train_hardnet [--pairs 300000]
        [--steps 20000] [--batch 1024] [--lr 3e-3] [--images 128]
        [--mode mix|pipeline|jitter] [--seed 0] [--out weights/HardNetPS.npz]
        [--device cuda|cpu] [--data-cache-dir DIR] [--resume CKPT.npz]
        [--cache PAIRS.npz ...] [--chunk 200]

The public HardNet recipe (hardest-in-batch triplet margin loss, Mishchuk
et al. 2017; desc/train.py) on patch pairs of desc/data.py:
  jitter   -- analytic frame jitter around detections (generate_pairs)
  pipeline -- correspondences of the deep pipeline (Hessian + AffNet +
              OriNet) across homography-warped views (generate_pairs_pipeline)
  mix      -- both (default).
The graf pair is never among the base images.  Generated pairs are cached
under --data-cache-dir (the system's temporary directory by default) by a
key of every generation input; --cache names pair files to use instead
(np.savez(a=, p=, i=), the JAX package's trainer's format), their id
spaces offset apart.

The pairs live on the device as uint8; each step draws its batch on the
device from a generator seeded with seed + 7.  Every --chunk steps the
held-out pairs (split by source keypoint) are scored (val accuracy, FPR at
95 % TPR) and the weights written to OUT.best.npz (best FPR so far) and
OUT.last.npz; every 2000 steps to OUT.s{step}.npz; at the end to OUT
(np.savez appends the ".npz", as with the JAX package's trainer).
--device defaults to the CUDA card; without one only --device cpu runs.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..desc import data as D
from ..desc import train as T

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pairs", type=int, default=300000)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--images", type=int, default=128)
    ap.add_argument("--mode", default="mix", choices=("mix", "pipeline", "jitter"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "weights", "HardNetPS.npz"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--data-cache-dir", default=tempfile.gettempdir())
    ap.add_argument("--eval-every", type=int, default=1000,
                    help="unused, as in the JAX package's trainer: validation "
                         "runs every --chunk steps")
    ap.add_argument("--resume", default="", help="npz checkpoint to continue from")
    ap.add_argument("--cache", action="append", default=[],
                    help="explicit pair-cache npz file(s); skips generation and "
                         "concatenates (id namespaces are offset per file)")
    ap.add_argument("--chunk", type=int, default=200,
                    help="steps between two validations and checkpoints")
    return ap.parse_args(argv)


def cache_path(args) -> str:
    """The generated pairs' cache file: keyed on every generation input."""
    key = hashlib.sha1(
        f"v3|{args.mode}|{args.pairs}|{args.images}|{args.seed}".encode()
    ).hexdigest()[:12]
    return os.path.join(args.data_cache_dir, f"hardnet_pairs_{key}.npz")


def load_caches(paths: List[str]):
    """(anchors, positives, ids) of pair files concatenated, the ids of
    file k offset by k * 4e9 so that equal ids of two files never alias."""
    aa, pp, ii = [], [], []
    for k, c in enumerate(paths):
        z = np.load(c)
        aa.append(z["a"])
        pp.append(z["p"])
        ii.append(z["i"].astype(np.int64) + k * 4_000_000_000)
        print(f"loaded {len(aa[-1])} pairs from {c}", flush=True)
    return np.concatenate(aa), np.concatenate(pp), np.concatenate(ii)


def generate(args, device):
    """Pairs of --mode (mix: half pipeline pairs from --seed, half jitter
    pairs from --seed + 1, the jitter ids offset by 1e9), cached."""
    t0 = time.time()
    parts = []
    if args.mode in ("mix", "pipeline"):
        n = args.pairs if args.mode == "pipeline" else args.pairs // 2
        parts.append(D.generate_pairs_pipeline(n, seed=args.seed, n_images=args.images,
                                               device=device))
        print(f"pipeline pairs: {len(parts[-1][0])} ({time.time() - t0:.0f}s)",
              flush=True)
    if args.mode in ("mix", "jitter"):
        n = args.pairs if args.mode == "jitter" else args.pairs // 2
        parts.append(D.generate_pairs(n, seed=args.seed + 1, n_images=args.images,
                                      include_graf=False, device=device))
        print(f"jitter pairs: {len(parts[-1][0])} ({time.time() - t0:.0f}s)",
              flush=True)
    anchors = np.concatenate([a for a, _, _ in parts])
    positives = np.concatenate([p for _, p, _ in parts])
    ids = np.concatenate([i + k * 1_000_000_000 for k, (_, _, i) in enumerate(parts)])
    print(f"generated {len(anchors)} pairs in {time.time() - t0:.0f}s", flush=True)
    np.savez(cache_path(args), a=anchors, p=positives, i=ids)
    return anchors, positives, ids


def resume_from(net: T.TrainableHardNet, path: str) -> None:
    """The weights and running statistics of a `features.N.*` checkpoint
    in place of the net's."""
    from ..desc.cnn import layers_from_state
    layers = layers_from_state(dict(np.load(path)))
    with torch.no_grad():
        for idx, p in layers.items():
            if idx == "whiten":
                continue
            if "weight" in p:
                getattr(net, f"w{idx}").copy_(torch.from_numpy(p["weight"]))
            if "running_mean" in p:
                getattr(net, f"bn{idx}_mean").copy_(torch.from_numpy(p["running_mean"]))
                getattr(net, f"bn{idx}_var").copy_(torch.from_numpy(p["running_var"]))


def as_uint8(x: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.clip(np.round(x), 0, 255).astype(np.uint8)).to(dev)


def train(net: T.TrainableHardNet, anchors, positives, ids, steps: int, batch: int,
          lr: float, chunk: int, seed: int, out: str,
          log: Callable = print) -> List[Dict]:
    """Train `net` in place on the pairs (numpy; split by source keypoint,
    the training rows rounded to uint8 on the net's device) with Adam
    under the cosine schedule over `steps`, BatchNorm on batch statistics;
    runs whole chunks until at least `steps` steps are done.  After each
    chunk: validation and checkpoints (out + ".best.npz", ".last.npz",
    every 2000 steps ".s{step}.npz").  Returns one dict a chunk: step, the chunk's mean
    loss, val accuracy, FPR at 95 % TPR, and the seconds of the chunk's
    steps (host clock after a synchronize on a CUDA device)."""
    dev = next(net.parameters()).device
    val_sel, tr_sel = T.split_by_keypoint(ids)
    val_a = torch.from_numpy(np.asarray(anchors[val_sel], np.float32)).to(dev)
    val_p = torch.from_numpy(np.asarray(positives[val_sel], np.float32)).to(dev)
    val_i = torch.from_numpy(ids[val_sel]).to(dev)
    tr_a, tr_p = as_uint8(anchors[tr_sel], dev), as_uint8(positives[tr_sel], dev)
    tr_i = torch.from_numpy(ids[tr_sel]).to(dev)
    ntr = len(tr_sel)
    log(f"train {ntr} val {len(val_sel)} pairs")
    opt, sched = T.cosine_adam(net, lr, steps)
    step = T.make_train_step(opt, train_bn=True, scheduler=sched)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    history, best_fpr, i, last_tag = [], float("inf"), 0, 0
    t_start = time.time()
    while i < steps:
        sync()
        t0 = time.perf_counter()
        losses = []
        for _ in range(chunk):
            sel = torch.randint(0, ntr, (batch,), generator=gen, device=dev)
            losses.append(step(net, tr_a[sel].float(), tr_p[sel].float(), tr_i[sel]))
        sync()
        train_s = time.perf_counter() - t0
        i += chunk
        loss = float(torch.stack(losses).mean())
        acc, fpr = T.fpr95(net, val_a, val_p, val_i)
        history.append(dict(step=i, loss=loss, val_acc=acc, fpr95=fpr, train_s=train_s))
        log(f"step {i:6d} loss {loss:.4f} val_acc {acc:.4f} fpr95 {fpr:.4f} "
            f"({time.time() - t_start:.0f}s)")
        if fpr < best_fpr:
            best_fpr = fpr
            T.save_hardnet_npz(net, out + ".best")
        T.save_hardnet_npz(net, out + ".last")
        if i - last_tag >= 2000:
            # step-tagged checkpoints: model selection happens after training
            last_tag = i
            T.save_hardnet_npz(net, out + f".s{i}")
    return history


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.cache:
        anchors, positives, ids = load_caches(args.cache)
    elif os.path.exists(cache_path(args)):
        z = np.load(cache_path(args))
        anchors, positives, ids = z["a"], z["p"], z["i"]
        print(f"loaded {len(anchors)} cached pairs from {cache_path(args)}", flush=True)
    else:
        anchors, positives, ids = generate(args, dev)
    net = T.init_hardnet_params(torch.Generator().manual_seed(42), dev)
    if args.resume:
        resume_from(net, args.resume)
        print(f"resumed from {args.resume}", flush=True)
    history = train(net, anchors, positives, ids, args.steps, args.batch, args.lr,
                    args.chunk, args.seed, args.out,
                    log=lambda s: print(s, flush=True))
    T.save_hardnet_npz(net, args.out)
    best = min(h["fpr95"] for h in history)
    print(f"saved {args.out} (best fpr95 {best:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
