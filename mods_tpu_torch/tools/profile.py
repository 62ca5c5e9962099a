"""The port's stage profiler: the classic flagship's stages one by one,
each timed on its device.

    python -m mods_tpu_torch.tools.profile (--img1 IMG1 --img2 IMG2 | --size HxW)
        [--max-kp 4096] [--reps 5] [--kernels] [--deep]
        [--config config.ini] [--iters iters.ini] [--device cuda|cpu]

Sections:
  default    -- the classic flagship (models/flagship.py): detect /
                extract (detect + orientation + description) /
                match_fginn / duplicate_filter / ransac_h / the full
                match_pair
  --kernels  -- its building blocks: gaussian blur, half_image, the mip
                pyramid, octave 0's blur and response stack, find_extrema,
                and patch_engine.sample_patches at 41 and 32 px for
                --max-kp random frames
  --deep     -- the deep path's: the mip pyramid, CNN patches at 32 px,
                and the HardNet, AffNet and OriNet forwards on them (a net
                whose weights are missing is skipped; AffNet and OriNet
                run at seeded random weights under
                MODS_TPU_ALLOW_RANDOM_CNN)

Each stage runs once to warm up, then --reps times: on the card between
two CUDA events after a synchronize, on the CPU by the host clock; the
mean is printed in ms.  The pair is --img1 / --img2, or with --size the
synthetic warp pair testing.warp_pair(H, W, 1).  --max-kp sets the
keypoint cap and cfg.max_octave_cands.  Without INIs the classic sections
take Config() and the deep one testing.deep_config() (tools/common.py).
The header names the device and, on the card, its name and its power
limit as nvidia-smi reads it.  --device defaults to the CUDA card;
without one only --device cpu runs.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import Callable

import numpy as np
import torch

from .. import full_float32, resolve_device
from ..desc import cnn
from ..detect import pyramid as pyr
from ..detect.detector import detect_keypoints
from ..match.matching import duplicate_filter, match_fginn
from ..models import flagship
from ..ops import image as imops
from ..ops import patch_engine as pe
from ..ops.image import as_image
from ..testing import warp_pair
from ..verify.homography import _ransac_h_core
from . import common


def stage_timer(dev: torch.device, reps: int) -> Callable:
    """timeit(name, fn, *args): runs fn(*args) once, then `reps` times
    timed, prints the mean ms under `name` and returns the last output."""
    def timeit(name, fn, *args):
        out = fn(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                out = fn(*args)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                out = fn(*args)
            ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"{name:34s} {ms:9.2f} ms", flush=True)
        return out
    return timeit


def device_line(dev: torch.device) -> str:
    """The device, and on the card its name and power limit."""
    if dev.type != "cuda":
        return f"device={dev}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    return f"device={dev} ({torch.cuda.get_device_name(dev)}; nvidia-smi: {smi})"


def random_frames(n: int, h: int, w: int, dev: torch.device):
    """n seeded positions 40 px or more inside the image (40..600 on a
    640x800 image) with identity shapes."""
    hi = max(41.0, min(h, w) - 40.0)
    xy = np.random.default_rng(0).uniform(40, hi, (n, 2)).astype(np.float32)
    return (torch.from_numpy(xy).to(dev),
            torch.eye(2, device=dev).expand(n, 2, 2).contiguous())


@full_float32()
def profile(img1: np.ndarray, img2: np.ndarray, args, dev: torch.device) -> None:
    """The sections that `args` asks for, on the pair's device copies."""
    timeit = stage_timer(dev, args.reps)
    cfg = common.tool_config(args)
    cfg.max_octave_cands = max_kp = args.max_kp
    i1, i2 = as_image(img1, dev), as_image(img2, dev)
    h, w = i1.shape
    gen = common.ransac_generator(cfg, dev)
    print(f"{device_line(dev)} image={tuple(i1.shape)} max_kp={max_kp}", flush=True)

    kp = timeit("detect (all octaves)", lambda im: detect_keypoints(
        im, cfg.hessian, max_kp, cfg.max_octave_cands), i1)
    print(f"{'':34s} n_kp={int(kp.valid.sum())}")
    extract = lambda im: flagship.extract(im, cfg, max_kp, device=dev)
    f1 = timeit("extract (det+ori+desc)", extract, i1)
    f2 = extract(i2)
    t = timeit("match_fginn", lambda a, b: match_fginn(a, b, cfg.matching, 0.8,
                                                       int_exact=True), f1, f2)
    td = timeit("duplicate_filter", lambda tt: duplicate_filter(
        tt, cfg.filtering.duplicateDist, cfg.filtering.mode, cap=2048), t)
    timeit("ransac_h", lambda tt: _ransac_h_core(
        tt.xy1, tt.xy2, tt.valid, cfg.ransac.err_threshold ** 2,
        cfg.ransac.batch_hypotheses, cfg.ransac.lo_batch, generator=gen), td)
    timeit("FULL match_pair", lambda a, b: flagship.match_pair(
        a, b, cfg, max_kp, generator=gen, device=dev), i1, i2)

    if args.kernels:
        print("-- kernels --")
        timeit("gaussian_blur sigma=1.6", lambda im: imops.gaussian_blur(im, 1.6), i1)
        timeit("half_image", imops.half_image, i1)
        timeit("build_mip_pyramid", pe.build_mip_pyramid, i1)
        par = cfg.hessian.pyramid
        resp = timeit("build_octave 0 (blur+resp)",
                      lambda im: pyr.build_octave(im, par, par.initialSigma)[1], i1)
        timeit("find_extrema (NMS+compact)",
               lambda r: pyr.find_extrema(r, par, max_kp)[3], resp)
        pyrm = pe.build_mip_pyramid(i1)
        xy, A = random_frames(max_kp, h, w, dev)
        for P in (41, 32):
            timeit(f"sample_patches {P}px x{max_kp}", lambda: pe.sample_patches(
                pyrm, xy, 2.0 * A, P, blend="blend"))

    if args.deep:
        dcfg = common.tool_config(args, deep=True)
        print("-- deep --")
        pyrm = timeit("mip_pyramid", pe.build_mip_pyramid, i1)
        n = max_kp
        xy, A = random_frames(n, h, w, dev)
        s = torch.from_numpy(np.random.default_rng(0).uniform(2, 8, n)
                             .astype(np.float32)).to(dev)
        v = torch.ones(n, dtype=torch.bool, device=dev)
        patches = timeit(f"cnn patches 32px x{n}", lambda: cnn.cnn_patches(
            pyrm, xy, A, s, v, dcfg.hardnet.mrSize, 32, blend="blend"))
        for which in ("hardnet", "affnet", "orinet"):
            try:
                net = cnn.get_net(dcfg, which, dev)
            except FileNotFoundError:
                print(f"{which}: weights missing, skipped")
                continue
            timeit(f"{which}_forward x{n}", net, patches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    common.add_inputs(ap, pair_required=False)
    ap.add_argument("--size", default=None,
                    help="HxW: the synthetic warp pair in place of --img1 / --img2")
    ap.add_argument("--max-kp", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--deep", action="store_true")
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args(argv)
    if args.size is not None and (args.img1 or args.img2):
        ap.error("give --img1 and --img2, or --size, not both")
    if args.size is None and not (args.img1 and args.img2):
        ap.error("give --img1 and --img2, or --size HxW")
    dev = resolve_device(args.device)
    if args.size is not None:
        h, w = (int(x) for x in args.size.lower().split("x"))
        img1, img2, _ = warp_pair(h, w, 1)
    else:
        img1, img2 = common.load_pair(args)
    profile(img1, img2, args, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
