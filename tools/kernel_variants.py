#!/usr/bin/env python3
"""Times build variants of the port's CUDA patch kernels on one card.

    python3 tools/kernel_variants.py [--sass FILE]

Builds mods_tpu_torch/csrc/patch_kernels.cu once per set of -D tunables
(all nvcc runs started together), prints what `-Xptxas -v` says of the
default build (registers, shared memory, spills), writes its SASS to
FILE when asked (with the toolkit's cuobjdump), and for every variant
times on chip_smoke.py's inputs, as device ms from a CUDA graph of 20
launches (`chip_smoke.device_ms`):

- dma_hat_resample (P=19, n=4096 and P=41, n=32768) and hat_resample
  (P=19, n=4096 and P=41, n=2048 and 32768), over several staging-buffer
  sizes (0 = every tap from global memory);
- dma_baumberg (n=4096) and baumberg_windows (n=128 ... 32768),
  BAUMBERG_WIN_WARPS = 1, 2, 4 and 12 among the variants; the
  BAUMBERG_WIN_WARP build adds the warp-per-keypoint body on windows,
  which nothing else builds, and times it at the same counts.

The default build is also timed against the first designs, with every
row live, a fifth of the rows live (as the main path has them) and none,
with Baumberg cut to 2, 4 and 8 iterations (what the slowest keypoints'
chains cost), and hat_resample staged and unstaged at patch widths 19,
25, 31 and 41 (where staging starts to pay on windows).  The
BAUMBERG_CLOCKS build prints the clocks one iteration spends in each
phase (sampling, first barrier, products and butterfly, second barrier,
update, third barrier), for the body of a few warps per keypoint and for
the first design, averaged over all blocks' iterations as thread 0 sees
them.

Every variant's output is first held against the default build's, bit
for bit; a variant that changes BAUMBERG_WIN_WARPS adds baumberg_windows'
sums in another order, so its output there is held to the agreement
chip_smoke.py asks of a kernel against its plain version.  Prints one
JSON object per line; needs a CUDA card and nvcc.
"""
import ctypes
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
    "baumberg_win 1 warp a keypoint": ("-DBAUMBERG_WIN_WARPS=1",),
    "baumberg_win 2 warps a keypoint": ("-DBAUMBERG_WIN_WARPS=2",),
    "baumberg_win 12 warps a keypoint": ("-DBAUMBERG_WIN_WARPS=12",),
    "baumberg clocks": ("-DBAUMBERG_CLOCKS",),
    "baumberg warp body on windows": ("-DBAUMBERG_WIN_WARP",),
}
STAGE_SIZES = (0, 4096, 6144, 8192, 10240)
WIN_STAGE_SIZES = (0, 2048, 4096, 6144, 9216)
WIN_COUNTS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
# patch widths over which hat_resample is timed staged and unstaged
WIN_WIDTHS = (19, 25, 31, 41)
PHASES = ("sampling", "barrier_a", "products", "barrier_b", "update", "barrier_c")


def phase_clocks(path, run):
    """Mean clocks of each phase of one iteration of `run`'s kernel, read
    from the BAUMBERG_CLOCKS build at `path`."""
    import torch
    lib = ctypes.CDLL(str(path))
    lib.baumberg_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.baumberg_clocks.restype = ctypes.c_int
    sums = (ctypes.c_ulonglong * (len(PHASES) + 1))()

    def read():
        torch.cuda.synchronize()
        err = lib.baumberg_clocks(ctypes.cast(sums, ctypes.c_void_p), 1)
        if err != 0:
            raise RuntimeError(f"baumberg_clocks failed with error {err}")
        return list(sums)

    run()      # warm
    read()     # and zero
    run()
    *clocks, iterations = read()
    out = {p: c / max(iterations, 1) for p, c in zip(PHASES, clocks)}
    out["iterations"] = iterations
    out["clocks_per_iteration"] = sum(clocks) / max(iterations, 1)
    return out


def warp_body_on_windows(pk, path, c, n):
    """baumberg_win_warp of the BAUMBERG_WIN_WARP build at `path` on the
    case `c`: held to the agreement chip_smoke.py asks of a kernel against
    the plain version, bit-equal repeats, and its device ms."""
    import torch
    import chip_smoke as cs
    entry = ctypes.CDLL(str(path)).baumberg_win_warp
    entry.argtypes, entry.restype = pk._library().baumberg_win.argtypes, ctypes.c_int
    run = lambda: pk._launch_baumberg_win(entry, *c.args)
    (U, ok), (U2, ok2), (U_ref, ok_ref) = run(), run(), c.plain()
    torch.cuda.synchronize()
    cs.held_to_plain(c, f"baumberg_win_warp n={n}", U, ok, U_ref, ok_ref)
    cs.check(bool((U2 == U).all()) and bool((ok2 == ok).all()),
             f"baumberg_win_warp n={n}: two runs differ")
    return cs.device_ms(run)


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
    pyr_n = pe.build_mip_pyramid(img[:, :240].contiguous()).contiguous()
    windows = {(P, n): cs.window_resample_inputs(torch, pk, pe, pyr_n, n, P, 200 + P)
               for P, n in ((19, 4096), (41, 2048), (41, 32768))}
    by_width = {P: cs.window_resample_inputs(torch, pk, pe, pyr_n, 4096, P, 300 + P)
                for P in WIN_WIDTHS}
    stack = cs.blur_stack(torch, imops, textured_image, 640, 800)
    baum = cs.baumberg_case(torch, pk, pe, imops, "dma_baumberg", stack, 4096,
                            19, 640)
    stacks = {1024: cs.blur_stack(torch, imops, textured_image, 160, 200),
              4096: cs.blur_stack(torch, imops, textured_image, 640, 240)}

    def win_case(n, max_iter=16):
        s = stacks[4096 if n > 1024 else 1024]
        return cs.baumberg_case(torch, pk, pe, imops, "baumberg_windows", s, n,
                                19, s.shape[1], max_iter=max_iter)

    baum_win = {n: win_case(n) for n in WIN_COUNTS}

    def run_resample(P, live_share=None):
        lev, oy, ox, params = resample[P]
        if live_share is not None:
            params = params.clone()
            params[:, 10] = (torch.arange(len(lev), device=dev)
                             < live_share * len(lev)).float()
        return lambda: pk.dma_hat_resample(pyr, lev, oy, ox, params, P)

    def run_windows(key, stage_floats=None):
        wins, params = windows[key]
        if stage_floats is None:
            return lambda: pk.hat_resample(wins, params, key[0])
        return lambda: cs.hat_resample_staged(pk, wins, params, key[0],
                                              stage_floats)

    want = None
    for name, path in paths.items():
        pk._lib = pk.bind_library(path)
        got = [run_resample(19)(), run_resample(41)(), *baum.run(),
               *[run_windows(k)() for k in windows]]
        got_win = baum_win[1024].run()
        torch.cuda.synchronize()
        if want is None:
            want, want_win = got, got_win
        same = all(bool((a == b).all()) for a, b in zip(got, want))
        if name.startswith("baumberg_win"):
            # another number of warps adds the sums in another order
            agree, err = cs.baumberg_agreement(*got_win, *want_win,
                                               baum_win[1024].valid)
            same = same and agree >= 0.995 and err <= 1e-3
        else:
            same = same and all(bool((a == b).all())
                                for a, b in zip(got_win, want_win))
        row = {"variant": name, "flags": list(VARIANTS[name]),
               "same_bits_as_default": same}
        if name.startswith(("default", "resample")):
            row["resample_P19_ms"] = cs.device_ms(run_resample(19))
            row["resample_P41_ms"] = cs.device_ms(run_resample(41))
            for (P, n) in windows:
                row[f"resample_win_P{P}_n{n}_ms"] = cs.device_ms(run_windows((P, n)))
        if name.startswith(("default", "baumberg ")):
            row["baumberg_ms"] = cs.device_ms(baum.run)
        if name.startswith(("default", "baumberg")):
            for n, c in baum_win.items():
                row[f"baumberg_win_n{n}_ms"] = cs.device_ms(c.run)
        if name == "baumberg warp body on windows":
            for n, c in baum_win.items():
                row[f"baumberg_win_warp_n{n}_ms"] = warp_body_on_windows(
                    pk, path, c, n)
        if name == "baumberg clocks":
            for n in (128, 1024):
                c = baum_win[n]
                row[f"clocks_baumberg_win_n{n}"] = phase_clocks(path, c.run)
                row[f"clocks_first_design_n{n}"] = phase_clocks(path, c.first)
        if name == "default":
            row["resample_P41_first_design_ms"] = cs.device_ms(
                lambda: pk.first_dma_hat_resample(pyr, *resample[41], 41))
            row["baumberg_first_design_ms"] = cs.device_ms(baum.first)
            for n, c in baum_win.items():
                row[f"baumberg_win_first_design_n{n}_ms"] = cs.device_ms(c.first)
            # the longest keypoint's chain against the card's throughput
            for iters in (2, 4, 8):
                short = cs.baumberg_case(torch, pk, pe, imops, "dma_baumberg",
                                         stack, 4096, 19, 640, max_iter=iters)
                row[f"baumberg_max_iter_{iters}_ms"] = cs.device_ms(short.run)
                for n in (128, 1024):
                    short = win_case(n, iters)
                    row[f"baumberg_win_n{n}_max_iter_{iters}_ms"] = cs.device_ms(
                        short.run)
                    row[f"baumberg_win_first_design_n{n}_max_iter_{iters}_ms"] = (
                        cs.device_ms(short.first))
            # where staging starts to pay on windows, by patch width
            for P, (wins, params) in by_width.items():
                for label, size in (("unstaged", 0), ("staged", pk.STAGE_FLOATS)):
                    row[f"resample_win_P{P}_n4096_{label}_ms"] = cs.device_ms(
                        lambda: cs.hat_resample_staged(pk, wins, params, P, size))
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
            for size in WIN_STAGE_SIZES:
                for (P, n) in windows:
                    row[f"resample_win_P{P}_n{n}_stage_{size}_ms"] = cs.device_ms(
                        run_windows((P, n), size))
        print(json.dumps(row))
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
