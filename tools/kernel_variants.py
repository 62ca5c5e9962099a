#!/usr/bin/env python3
"""Times build variants of the port's CUDA patch kernels on one card.

    python3 tools/kernel_variants.py [--sass FILE]

Builds mods_tpu_torch/csrc/patch_kernels.cu once per set of -D tunables
(all nvcc runs started together), prints what `-Xptxas -v` says of the
default build (registers, shared memory, spills), writes its SASS to
FILE when asked (with the toolkit's cuobjdump), and for every variant
times dma_hat_resample (P=19, n=4096 and P=41, n=32768, over
several staging-buffer sizes; 0 = every tap from global memory) or
dma_baumberg (n=4096) on chip_smoke.py's inputs: device ms from a CUDA
graph of 20 launches (`chip_smoke.device_ms`).  The default build is also
timed against the first designs, with every row live, a fifth of the rows
live (as the main path has them) and none, and with Baumberg cut to 2, 4
and 8 iterations (what its slowest keypoints' chains cost).  Every
variant's output is first held against the default build's, bit for bit.
Prints one JSON object per line; needs a CUDA card and nvcc.
"""
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = HERE   # the repository root in place of this script's directory

VARIANTS = {
    "default": (),
    "resample 256 threads": ("-DRESAMPLE_THREADS=256",),
    "resample 64 threads": ("-DRESAMPLE_THREADS=64",),
    "baumberg 1 warp a block": ("-DBAUMBERG_WARPS=1",),
    "baumberg 4 warps a block": ("-DBAUMBERG_WARPS=4",),
    "baumberg unroll 4": ("-DBAUMBERG_UNROLL=4",),
    "baumberg unroll 1": ("-DBAUMBERG_UNROLL=1",),
}
STAGE_SIZES = (0, 4096, 6144, 8192, 10240)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mods_tpu_torch.ops import image as imops
    from mods_tpu_torch.ops import patch_engine as pe
    from mods_tpu_torch.ops import patch_kernels as pk
    from mods_tpu_torch.testing import textured_image

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi}))
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        verbose = pool.submit(pk.build_library, ("-Xptxas", "-v"))
        paths = dict(zip(VARIANTS, pool.map(pk.build_library, VARIANTS.values())))
        verbose.result()
    if "--sass" in sys.argv:
        sass = sys.argv[sys.argv.index("--sass") + 1]
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        os.makedirs(os.path.dirname(os.path.abspath(sass)), exist_ok=True)
        with open(sass, "w") as f:
            subprocess.run([cuobjdump, "-sass", str(paths["default"])], stdout=f,
                           check=True)

    dev = torch.device("cuda")
    img = torch.from_numpy(textured_image(640, 800, 11)).to(dev)
    pyr = pe.build_mip_pyramid(img).contiguous()
    resample = {P: cs.resample_inputs(pk, pe, pyr, n, P, 100 + P)
                for P, n in ((19, 4096), (41, 32768))}
    stack = cs.blur_stack(torch, imops, textured_image, 640, 800)
    baum = cs.baumberg_case(torch, pk, pe, imops, "dma_baumberg", stack, 4096,
                            19, 640)

    def run_resample(P, live_share=None):
        lev, oy, ox, params = resample[P]
        if live_share is not None:
            params = params.clone()
            params[:, 10] = (torch.arange(len(lev), device=dev)
                             < live_share * len(lev)).float()
        return lambda: pk.dma_hat_resample(pyr, lev, oy, ox, params, P)

    want = None
    for name, path in paths.items():
        pk._lib = pk.bind_library(path)
        got = [run_resample(19)(), run_resample(41)(), *baum.run()]
        torch.cuda.synchronize()
        if want is None:
            want = got
        same = all(bool((a == b).all()) for a, b in zip(got, want))
        row = {"variant": name, "flags": list(VARIANTS[name]),
               "same_bits_as_default": same}
        if name.startswith(("default", "resample")):
            row["resample_P19_ms"] = cs.device_ms(run_resample(19))
            row["resample_P41_ms"] = cs.device_ms(run_resample(41))
        if name.startswith(("default", "baumberg")):
            row["baumberg_ms"] = cs.device_ms(baum.run)
        if name == "default":
            row["resample_P41_first_design_ms"] = cs.device_ms(
                lambda: pk.first_dma_hat_resample(pyr, *resample[41], 41))
            row["baumberg_first_design_ms"] = cs.device_ms(baum.first)
            # the longest keypoint's chain against the card's throughput
            for iters in (2, 4, 8):
                short = cs.baumberg_case(torch, pk, pe, imops, "dma_baumberg",
                                         stack, 4096, 19, 640, max_iter=iters)
                row[f"baumberg_max_iter_{iters}_ms"] = cs.device_ms(short.run)
            for share in (1.0, 0.22, 0.0):
                row[f"resample_P41_live_{share}_ms"] = cs.device_ms(
                    run_resample(41, share))
        if name.startswith(("default", "resample")):
            keep = pk.STAGE_FLOATS
            for size in STAGE_SIZES:
                pk.STAGE_FLOATS = size
                row[f"resample_P41_stage_{size}_ms"] = cs.device_ms(run_resample(41))
                row[f"resample_P19_stage_{size}_ms"] = cs.device_ms(run_resample(19))
            pk.STAGE_FLOATS = keep
        print(json.dumps(row))
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
