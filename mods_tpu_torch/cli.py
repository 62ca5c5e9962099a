"""Command-line apps mirroring the reference binaries, on the port.

  python -m mods_tpu_torch.cli mods <img1> <img2> <out1> <out2> <k1> <k2> \\
      <matchings> <log> [ver_type] [gt_h] [config.ini] [iters.ini] \\
      [--clahe] [--mask] [--pre-extracted] [--device cuda|cpu]
      -- two-view matching (reference mods.cpp:49-544 CLI)

  python -m mods_tpu_torch.cli extract <img> <out.npz|out.txt> \\
      [config.ini] [iters.ini] [--benchmark-out[=PREFIX]] [--device cuda|cpu]
      -- single-image extraction (reference extract_features.cpp)

  python -m mods_tpu_torch.cli extract_batch <image_list> <output_list> \\
      [config.ini] [iters.ini] [--shard I/N] [--device cuda|cpu]
      -- batch extraction with skip-if-exists resume
      (reference extract_features_batch.cpp:56-162); --shard takes the
      strided share I of N of the list (parallel/distributed.shard_list)

Without config.ini the configuration is Config(); without iters.ini the
schedule is one Hessian-Affine RootSIFT step on the identity view (the
shape of the reference's iters_HessianSIFT.ini).  A named INI that does
not exist raises FileNotFoundError.  --device defaults to the CUDA card;
without one, only --device cpu runs.
"""
from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import resolve_device
from .config import Config, detector_step, load_config, load_iters
from .io import keys
from .io.logs import write_log, write_time_log
from .ops.image import as_image, rgb_to_gray
from .parallel.distributed import shard_list
from .pipeline import ViewFeatures, extract_view
from .twoview import TwoViewResult, _concat_features, match_images
from .types import Features, Keypoints


def load_cli_config(cfg_path: Optional[str] = None,
                    iters_path: Optional[str] = None) -> Config:
    """The commands' configuration: the config INI over Config(), the
    iters INI's schedule or one Hessian-Affine RootSIFT step on the
    identity view."""
    cfg = load_config(cfg_path) if cfg_path else Config()
    if iters_path:
        cfg.iters, cfg.matching.maxSteps, cfg.matching.minMatches = load_iters(iters_path)
    else:
        cfg.iters = [detector_step(["HessianAffine"], [1.0], 360.0)]
    return cfg


def _pop_option(argv: List[str], name: str) -> Optional[str]:
    """Remove `name=VALUE` or `name VALUE` from argv; the value or None."""
    for i, a in enumerate(argv):
        if a.startswith(name + "="):
            del argv[i]
            return a.split("=", 1)[1]
        if a == name:
            if i + 1 == len(argv):
                raise ValueError(f"{name} needs a value")
            value = argv[i + 1]
            del argv[i:i + 2]
            return value
    return None


def _split_flags(argv: List[str], known) -> Tuple[set, List[str]]:
    flags = {a for a in argv if a.startswith("--")}
    unknown = flags - set(known)
    if unknown:
        raise ValueError(f"unknown options {sorted(unknown)}")
    return flags, [a for a in argv if not a.startswith("--")]


def load_gray(path: str) -> np.ndarray:
    """An image file as float32 gray in 0..255: the mean of its channels
    (`ops/image.rgb_to_gray`), as the reference reads it."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return rgb_to_gray(img)


# --------------------------------------------------------------------------- #
# mods
# --------------------------------------------------------------------------- #
@dataclass
class ModsOutputs:
    """The text files of a `mods` run; an empty path writes nothing."""
    k1: str = "k1.txt"
    k2: str = "k2.txt"
    matchings: str = "matches.txt"
    log: str = "log.txt"


def _print_summary(r: TwoViewResult, total: float) -> None:
    print(f"{r.tentatives} tentatives found.")
    print(f"{r.unique_tentatives} unique tentatives left")
    print(f"{r.inliers} RANSAC correspondences got")
    print(f"Done in {r.steps_done} iterations")
    print("Image1: regions descriptors | Image2: regions descriptors")
    print(f"{r.regions1} {r.descriptors1} | {r.regions2} {r.descriptors2}")
    print("True matches | unique tentatives")
    ratio = 100.0 * r.inlier_ratio
    print(f"{r.inliers} | {r.unique_tentatives} | {ratio:.1f}%  1st geom inc")
    tl = r.timelog
    print("Timings: Synth|Detect|Orient|Desc|Match|RANSAC|Misc|Total")
    print(f"{tl.SynthTime:.3g} {tl.DetectTime:.3g} {tl.OrientTime:.3g} "
          f"{tl.DescTime:.3g} {tl.MatchTime:.3g} {tl.RANSACTime:.3g} "
          f"{tl.MiscTime:.3g} {total:.3g}")


def write_mods_outputs(r: TwoViewResult, outputs: ModsOutputs, ver_type: str,
                       total: float) -> None:
    """The text outputs of `mods`: `<log>.h` (the model), the matchings
    file (the final inliers: 'x1 y1 x2 y2 ratio' rows) and its `.csv`,
    the k1 / k2 native key files of every detector and descriptor, the
    log (the reference's WriteLog line and a JSON record) and
    `<log>.time`."""
    if r.H is not None:
        keys.write_h(outputs.log + ".h", r.H)
    if r.final is not None and outputs.matchings:
        t = r.final.tentatives
        v = t.valid.cpu().numpy()
        xy1, xy2 = t.xy1.cpu().numpy()[v], t.xy2.cpu().numpy()[v]
        ratio = t.ratio.cpu().numpy()[v]
        keys.write_matches(outputs.matchings, xy1, xy2, ratio)
        # the CSV variant with FGINN / SNN ratios (WriteMatchings
        # writeWithRatios, matching.cpp:2596-2608)
        keys.write_matches_csv(outputs.matchings + ".csv", xy1, xy2, ratio)
    # SaveRegions in the native hierarchical format (mods.cpp:404-420)
    for rep, path in ((r.rep1, outputs.k1), (r.rep2, outputs.k2)):
        if rep is None or not path:
            continue
        keys.save_regions_native(path, {
            det: {dn: _concat_features(fl) for dn, fl in dmap.items() if fl}
            for det, dmap in rep.store.items()})
    with open(outputs.log, "w") as fh:
        # the reference's WriteLog line (io_mods.cpp:10-67) and a JSON record
        write_log(r, ver_type, total, fh)
        fh.write(json.dumps(dict(
            tentatives=r.tentatives, unique=r.unique_tentatives,
            inliers=r.inliers, inlier_ratio=r.inlier_ratio,
            regions1=r.regions1, regions2=r.regions2,
            descriptors1=r.descriptors1, descriptors2=r.descriptors2,
            steps=r.steps_done, total_time_s=total)) + "\n")
    with open(outputs.log + ".time", "w") as fh:
        write_time_log(r.timelog, total, fh)


def run_mods(img1, img2, cfg: Config, outputs: ModsOutputs,
             ver_type: str = "LORANSAC", H_gt: Optional[np.ndarray] = None,
             pre_extracted: Optional[Tuple[Features, Features]] = None,
             device=None, draws=None,
             generator: Optional[torch.Generator] = None) -> TwoViewResult:
    """The `mods` command below its image files: twoview.match_images on
    the loaded images (on the card unless the caller asks for the CPU),
    traced so that the time log holds each phase's device work, the
    summary on standard output, and every text output
    (`write_mods_outputs`).  Returns the TwoViewResult."""
    t0 = time.perf_counter()
    r = match_images(img1, img2, cfg, H_gt=H_gt, ver_type=ver_type,
                     pre_extracted=pre_extracted, device=device, draws=draws,
                     generator=generator, trace=True)
    total = time.perf_counter() - t0
    _print_summary(r, total)
    write_mods_outputs(r, outputs, ver_type, total)
    return r


def _load_features(path: str, device) -> Features:
    return keys.load_npz(path, device) if path.endswith(".npz") else \
        keys.load_oxaff(path, device)


def cmd_mods(argv) -> int:
    argv = list(argv)
    dev = resolve_device(_pop_option(argv, "--device"))
    flags, pos = _split_flags(argv, ("--clahe", "--mask", "--pre-extracted"))
    if len(pos) < 2:
        print(__doc__)
        return 1
    img1p, img2p = pos[:2]
    out = pos[2:]
    arg = lambda i, default: out[i] if len(out) > i else default
    out_img1, out_img2 = arg(0, ""), arg(1, "")
    outputs = ModsOutputs(arg(2, "k1.txt"), arg(3, "k2.txt"),
                          arg(4, "matches.txt"), arg(5, "log.txt"))
    ver_type = arg(6, "LORANSAC")
    gt_h_path = arg(7, "")
    cfg = load_cli_config(arg(8, None), arg(9, None))
    if "--pre-extracted" in flags:
        # the image arguments are saved feature files; one step
        # (read_pre_extracted, mods.cpp:197-229)
        pre = (_load_features(img1p, dev), _load_features(img2p, dev))
        img1 = img2 = np.zeros((16, 16), np.float32)
    else:
        pre = None
        img1, img2 = load_gray(img1p), load_gray(img2p)
        if "--clahe" in flags:           # mods.cpp:133-181
            import cv2
            clahe = cv2.createCLAHE(clipLimit=4.0, tileGridSize=(8, 8))
            img1, img2 = (clahe.apply(np.clip(im, 0, 255).astype(np.uint8))
                          .astype(np.float32) for im in (img1, img2))
        if "--mask" in flags:            # mods-with-mask.cpp:109-198
            import cv2
            for p, im in ((img1p, img1), (img2p, img2)):
                mp = os.path.splitext(p)[0] + "_mask.png"
                m = cv2.imread(mp, cv2.IMREAD_GRAYSCALE) if os.path.exists(mp) else None
                if m is not None and m.shape == im.shape:
                    im[m == 0] = 0.0
    H_gt = keys.read_h(gt_h_path) if gt_h_path and os.path.exists(gt_h_path) else None
    r = run_mods(img1, img2, cfg, outputs, ver_type, H_gt, pre, dev)
    if r.final is not None and (out_img1 or out_img2):
        import cv2
        from .io.draw import draw_matches, draw_regions
        t = r.final.tentatives
        if out_img1:
            cv2.imwrite(out_img1, draw_matches(img1, img2, t, H=r.H,
                                               is_f=ver_type in ("LORANSACF", "ORSA")))
        if out_img2:
            # the matched regions drawn on image 2 (the reference's out2)
            kp2 = Keypoints(xy=t.xy2, A=t.A2, s=t.s2,
                            response=torch.zeros(t.m, device=t.xy2.device),
                            valid=t.valid)
            f2 = Features(det=kp2, reproj=kp2, desc=torch.zeros((t.m, 1)))
            cv2.imwrite(out_img2, draw_regions(img2, f2))
    return 0


# --------------------------------------------------------------------------- #
# extract, extract_batch
# --------------------------------------------------------------------------- #
def _extract_one(img: np.ndarray, cfg: Config, device) -> ViewFeatures:
    """The first detector of the schedule's first step on the identity
    view, with its descriptors (Hessian-Affine RootSIFT without a
    schedule)."""
    h, w = img.shape
    det, descs = "HessianAffine", ["RootSIFT"]
    if cfg.iters:
        det = next(iter(cfg.iters[0].detectors))
        descs = cfg.iters[0].detectors[det]["descriptors"]
    return extract_view(as_image(img, device), np.eye(3), w, h, cfg, det, descs)


def _save(path: str, f: Features) -> None:
    if path.endswith(".npz"):
        keys.save_npz(path, f)
    else:
        keys.save_oxaff(path, f)


def cmd_extract(argv) -> int:
    argv = list(argv)
    dev = resolve_device(_pop_option(argv, "--device"))
    bench_prefix = None
    for a in list(argv):
        if a == "--benchmark-out" or a.startswith("--benchmark-out="):
            argv.remove(a)
            bench_prefix = a.split("=", 1)[1] if "=" in a else "bench"
    _, pos = _split_flags(argv, ())
    if len(pos) < 2:
        print(__doc__)
        return 1
    img_p, out_p = pos[:2]
    cfg = load_cli_config(pos[2] if len(pos) > 2 else None,
                          pos[3] if len(pos) > 3 else None)
    vf = _extract_one(load_gray(img_p), cfg, dev)
    f = next(iter(vf.by_desc.values()))
    _save(out_p, f)
    if bench_prefix:
        # the OxAff evaluation-protocol splits (SaveRegionsBenchmark /
        # SaveDescriptorsBenchmark, imagerepresentation.cpp:1515-1603)
        store = {"Det": {"None": [vf.regions],
                         **{k: [v] for k, v in vf.by_desc.items()}}}
        keys.save_regions_benchmark(store, bench_prefix + ".reproj_kp",
                                    bench_prefix + ".det_kp")
        keys.save_descriptors_benchmark(store, bench_prefix + ".desc")
        print(f"benchmark splits -> {bench_prefix}.{{reproj_kp,det_kp,desc}}")
    print(f"{int(f.count())} descriptors -> {out_p}")
    return 0


def cmd_extract_batch(argv) -> int:
    """Batch extraction with skip-if-exists resume
    (reference extract_features_batch.cpp:104-116).  `--shard I/N` keeps
    this process to a strided share of the list: the multi-process
    data-parallel mode (the resume makes re-running a failed share
    idempotent)."""
    argv = list(argv)
    dev = resolve_device(_pop_option(argv, "--device"))
    shard = _pop_option(argv, "--shard")
    pid, nproc = (int(x) for x in shard.split("/")) if shard else (0, 1)
    if not 0 <= pid < nproc:
        raise ValueError(f"--shard {shard}: want I/N with 0 <= I < N")
    _, pos = _split_flags(argv, ())
    if len(pos) < 2:
        print(__doc__)
        return 1
    cfg = load_cli_config(pos[2] if len(pos) > 2 else None,
                          pos[3] if len(pos) > 3 else None)
    with open(pos[0]) as fh:
        imgs = [line.strip() for line in fh if line.strip()]
    with open(pos[1]) as fh:
        outs = [line.strip() for line in fh if line.strip()]
    n_done = 0
    for img_p, out_p in shard_list(list(zip(imgs, outs)), pid, nproc):
        if os.path.exists(out_p) and os.path.getsize(out_p) > 0:
            print(f"skip {out_p} (exists)")
            continue
        f = next(iter(_extract_one(load_gray(img_p), cfg, dev).by_desc.values()))
        _save(out_p, f)
        n_done += 1
        print(f"{img_p}: {int(f.count())} descriptors -> {out_p}")
    print(f"done: {n_done} images")
    return 0


COMMANDS = {"mods": cmd_mods, "extract": cmd_extract,
            "extract_batch": cmd_extract_batch}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] not in COMMANDS:
        print(__doc__)
        return 1
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    sys.exit(main())
