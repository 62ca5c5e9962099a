#!/usr/bin/env python3
"""Holds parallel/mesh.py across ranks to what one rank computes.

    python3 tools/mesh_check.py [--device cuda|cpu] [--timeout 600]

Spawns four ranks, one a card (NCCL through
parallel.distributed.init_distributed on a free localhost port), or four
CPU processes with gloo under --device cpu.  On a 2 x 2 mesh ("data" x
"model") sharded_knn of 8192 queries against 65,536 database rows (seeded
integers 0..255, 128 wide, k 50; the database split in two blocks over
"model") must equal the dense match.matching._knn on one rank, distances
and indices.  On a 4 x 1 mesh batch_match_sharded of 4 warp pairs (one a
rank, Config() at 4096 keypoints, each pair's generator seeded with its
index) must equal models/flagship.match_pairs on rank 0 with the same
per-pair generators: H within 1e-5, counts equal.  On the same 4 x 1 mesh
desc/train.make_sharded_train_step takes one step on 1024 seeded pairs
with duplicate ids (train_check): every rank's loss and weights equal, the
loss, gradients and weights those of one rank's step on the whole batch
(train_check's tolerances).  Every rank checks that it holds the whole
result.  Under --device cpu the sizes shrink (512 x 4096, 96x128 pairs at
256 keypoints, 32 pairs).

Prints the cards' names and power limits from nvidia-smi (on the card),
then one JSON line; exits non-zero on a mismatch, a failed rank, or a rank
still running after --timeout seconds (which is then killed).
"""
import argparse
import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = HERE   # the repository root in place of this script's directory

RANKS = 4


def sizes(device):
    if device == "cuda":
        return dict(queries=8192, rows=65536, h=640, w=800, max_kp=4096, train_batch=1024)
    return dict(queries=512, rows=4096, h=96, w=128, max_kp=256, train_batch=32)


def train_batch(n):
    """n seeded 32x32 pairs (crops of a textured image, the positive with
    noise) and their ids, half as many as rows: duplicates."""
    from mods_tpu_torch.testing import textured_image
    rng = np.random.default_rng(43)
    img = textured_image(512, 512, 43)
    oy, ox = rng.integers(0, 480, n), rng.integers(0, 480, n)
    r = np.arange(32)
    a = img[oy[:, None, None] + r[None, :, None], ox[:, None, None] + r[None, None, :]]
    p = np.clip(a + rng.normal(0, 6, a.shape), 0, 255)
    return (a.astype(np.float32), p.astype(np.float32),
            rng.integers(0, n // 2, n).astype(np.int64))


def grad_errs(net, ref):
    """Per weight tensor: max |grad - ref's| over ref's largest |entry|."""
    return {k: float((w.grad.double() - ref[k].grad.double()).abs().max()
                     / ref[k].grad.double().abs().max()) for k, w in net.named_parameters()}


def train_check(rank, device, dev, sz, out):
    """desc/train.make_sharded_train_step on a RANKS x 1 mesh (one Adam step
    under the cosine schedule of 1e-3 over 10 steps, eval-mode BN) on
    train_batch pairs that every rank passes; rank 0 also takes the
    one-process step on the whole batch in float32 and float64.  The loss
    is the global batch's: within 1e-5 relative of the one-process loss;
    each weight gradient within 1e-4 (of its tensor's largest entry) of
    float64's, or within twice the one-process float32 gradient's error
    there; the weights after the step within 3e-4 of the one-process
    step's on at least 99.5 % of the entries and 2e-3 on all (Adam moves an
    entry whose gradient is rounding noise by up to its rate either way)."""
    import torch
    from mods_tpu_torch.desc import train as T
    from mods_tpu_torch.parallel.mesh import make_mesh
    a, p, ids = (torch.from_numpy(x).to(dev) for x in train_batch(sz["train_batch"]))
    params = T.init_hardnet_params(torch.Generator().manual_seed(0), "cpu").params()
    net = T.from_jax_params(params, dev)
    opt, sched = T.cosine_adam(net, 1e-3, 10)
    step = T.make_sharded_train_step(make_mesh(RANKS, 1, device=device), opt, sched)
    t0 = time.perf_counter()
    loss = float(step(net, a, p, ids))
    out["train_ms"] = (time.perf_counter() - t0) * 1e3
    w = torch.cat([v.flatten() for v in net.state_dict().values()])
    out.update(train_loss=loss, train_weights_sum=float(w.double().abs().sum()))
    if rank != 0:
        return
    refs = {}
    for dt in (torch.float32, torch.float64):
        ref = T.from_jax_params(params, dev).to(dt)
        o, sc = T.cosine_adam(ref, 1e-3, 10)
        l1 = float(T.make_train_step(o, scheduler=sc)(ref, a.to(dt), p.to(dt), ids))
        refs[dt] = ref, l1
    (r32, l32), (r64, _) = refs[torch.float32], refs[torch.float64]
    g64 = dict(r64.named_parameters())
    sharded_64, one_64 = grad_errs(net, g64), grad_errs(r32, g64)
    d = {k: (v - dict(r32.named_parameters())[k]).detach().abs()
         for k, v in net.named_parameters()}
    far = sum(int((x > 3e-4).sum()) for x in d.values())
    total = sum(x.numel() for x in d.values())
    out.update(one_process_loss=l32, train_grad_vs_float64=sharded_64,
               one_process_grad_vs_float64=one_64,
               train_weights_far=far, train_weights_total=total,
               train_weights_max_diff=max(float(x.max()) for x in d.values()),
               train_ok=bool(abs(loss - l32) <= 1e-5 * abs(l32)
                             and all(sharded_64[k] <= max(1e-4, 2 * one_64[k])
                                     for k in one_64)
                             and far <= 0.005 * total
                             and max(float(x.max()) for x in d.values()) <= 2e-3))


def rank_main(rank, port, device, out_dir):
    import torch
    import torch.distributed as dist
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.match.matching import _knn
    from mods_tpu_torch.models import flagship
    from mods_tpu_torch.parallel.distributed import init_distributed
    from mods_tpu_torch.parallel.mesh import batch_match_sharded, make_mesh, sharded_knn
    from mods_tpu_torch.testing import warp_pair
    if device == "cpu":
        torch.set_num_threads(1)
    init_distributed(f"127.0.0.1:{port}", RANKS, rank, device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" \
        else torch.device("cpu")
    sz = sizes(device)
    out = dict(rank=rank, device=str(dev))
    try:
        rng = np.random.default_rng(41)
        q = torch.from_numpy(rng.integers(0, 256, (sz["queries"], 128)).astype(np.float32))
        db = torch.from_numpy(rng.integers(0, 256, (sz["rows"], 128)).astype(np.float32))
        t0 = time.perf_counter()
        d, idx = sharded_knn(make_mesh(2, 2, device=device), q.to(dev), db.to(dev), 50)
        out["knn_ms"] = (time.perf_counter() - t0) * 1e3
        dd, di = _knn(q.to(dev), db.to(dev),
                      torch.ones(sz["rows"], dtype=torch.bool, device=dev), 50, False)
        out["knn_equal"] = bool(torch.equal(d, dd) and torch.equal(idx, di))

        cfg = Config()
        cfg.max_octave_cands = sz["max_kp"]
        pairs = [warp_pair(sz["h"], sz["w"], 11 + i) for i in range(RANKS)]
        imgs1 = np.stack([p[0] for p in pairs])
        imgs2 = np.stack([p[1] for p in pairs])
        t0 = time.perf_counter()
        H, inl, tent = batch_match_sharded(make_mesh(RANKS, 1, device=device), cfg,
                                           imgs1, imgs2, max_kp=sz["max_kp"])
        out["batch_ms"] = (time.perf_counter() - t0) * 1e3
        out.update(inliers=inl.tolist(), tentatives=tent.tolist())
        train_check(rank, device, dev, sz, out)
        if rank == 0:
            gens = [torch.Generator(device=dev).manual_seed(i) for i in range(RANKS)]
            Hr, inlr, tentr, _, _ = flagship.match_pairs(imgs1, imgs2, cfg, sz["max_kp"],
                                                         generator=gens, device=dev)
            out.update(ref_inliers=inlr.tolist(), ref_tentatives=tentr.tolist(),
                       H_max_abs_err=float((H - Hr.float()).abs().max()))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args()
    import torch
    if args.device == "cuda":
        if torch.cuda.device_count() < RANKS:
            print(f"mesh_check: needs {RANKS} cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
        from mods_tpu_torch.ops import patch_kernels as pk
        pk.build_library()      # once, before the ranks load it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=rank_main, args=(r, port, args.device, out_dir))
                 for r in range(RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(1.0, args.timeout - (time.perf_counter() - t0)))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        codes = [p.exitcode for p in procs]
        ranks = []
        for r in range(RANKS):
            if codes[r] == 0:
                with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
    r0 = ranks[0] if ranks and ranks[0]["rank"] == 0 else {}
    ok = (not hung and codes == [0] * RANKS
          and all(r["knn_equal"] for r in ranks)
          and all(r["inliers"] == r0["inliers"] and r["tentatives"] == r0["tentatives"]
                  for r in ranks)
          and r0.get("inliers") == r0.get("ref_inliers")
          and r0.get("tentatives") == r0.get("ref_tentatives")
          and r0.get("H_max_abs_err", 1.0) <= 1e-5
          and all(r["train_loss"] == r0["train_loss"]
                  and r["train_weights_sum"] == r0["train_weights_sum"] for r in ranks)
          and r0.get("train_ok", False))
    print(json.dumps(dict(ok=ok, device=args.device, ranks_hung=hung, exit_codes=codes,
                          sizes=sizes(args.device), ranks=ranks)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
