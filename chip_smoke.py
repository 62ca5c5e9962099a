#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the CUDA kernels
   from mods_tpu_torch/csrc with nvcc;
1b. holds octave_extrema (ops/octave_extrema.py: an octave's extrema
   search, localization and duplicate map as five kernels) against its
   plain version on the card, on every row: the six Hessian octaves of a
   640x800 image, octave 0 of the two atlas canvases of the wide MODS
   step, DoG and iiDoG on a view with black corners (NaN), Harris, more
   extrema than the cap, border 0; integers and flags equal, rc and
   response bit for bit, scale within 2 ulp, no synchronizing call under
   torch.cuda.set_sync_debug_mode("error"); times it (a CUDA graph of 20
   calls) beside the plain chain and its wrapper's host time; then one
   traced MODS loop on the 640x800 pair tilted by 5, where every octave
   goes through the kernels, five launches and at most six device
   kernels under DetectTime.extrema an octave;
2. holds each of the four patch kernels against its plain PyTorch version
   on the card, at the shapes of the main paths, and times both (and
   torch.nn.functional.grid_sample for the two resamplers, as a yardstick
   the port never calls); each kernel's bound counts the bytes and
   operations its data needs (the 32-byte sectors its taps touch).  The
   resamplers are also timed without their staging buffer (`ms_unstaged`);
   baumberg_windows and hat_resample at every keypoint count and window
   width that the pairs below launch them at.
   Each is held against its plain version on the cases its paths could
   get wrong: level and window borders and corners, patches larger than
   the staging buffer or off their window, dead and invalid rows, odd
   counts, every pyramid level, sources that allow no 16-byte copies,
   narrow windows, a patch wider than a block, NaN and infinite steps,
   Baumberg patch widths other than 19, and bit-equal repeats;
3. runs match_pair on a 640x800 pair warped by a known homography: the
   run must launch dma_baumberg, dma_hat_resample and baumberg_windows,
   and recover the homography within 2 px at the corners; then times 5
   pairs after 2 warm-ups and traces one more with torch.profiler (per
   stage host and device ms, device busy share; the profiler's table goes
   to standard error);
4. does the same (without the trace) on a 640x240 pair, whose width is
   under the DMA window's: every octave and every patch goes through
   baumberg_windows and hat_resample, at up to 4096 and 32768 keypoints a
   launch, and dma_baumberg and dma_hat_resample must not launch;
5. runs the 96x128 rolled pair, which must launch baumberg_windows and
   hat_resample;
6. runs a 256x320 warp pair on the card and on the CPU with the same
   RANSAC uniforms, and compares the counts;
7. runs the MODS loop (twoview.match_images, the two-step schedule of
   testing.mods_schedule) on a 640x800 pair tilted by 5 at Config()
   defaults: step 0 must stay under minMatches, step 1 (15 synthesized
   views through one atlas a side) reach it, H within 2 px at the corners;
   times 3 runs after 1 warm-up and traces one (per TimeLog phase);
8. runs the same schedule on a 128x160 tilted pair on the card and on the
   CPU with the same RANSAC uniforms, and compares the counts;
9. runs the MODS loop with every detector of the MODS schedules
   (testing.mods_all_detectors_schedule with mods_detectors_config: step 0
   MSER on the identity view, step 1 Hessian-Affine, DoG and Harris-Affine
   at tilts 1, 2, 4, one atlas a detector) on the 640x800 pair tilted by 8:
   step 0 under minMatches, the final step at least, H within 2 px, every
   detector > 0 regions on both images, no plain kernel version reached on
   the card; times 3 runs after 1 warm-up and traces one; then the same
   schedule on a 128x160 pair tilted by 3, card against CPU with the same
   RANSAC uniforms (each detector's counts too);
10. runs the epipolar verifiers (DEGENSAC loransac_f, orsa_filter) on the
   committed graf tentatives on the card and on the CPU with the same
   uniforms: inliers within 5 %, ORSA's decision equal; host and device
   ms of each;
11. runs the MODS loop with ver_type LORANSACF, then ORSA, on a 640x800
   pair of two planes at different depths (`testing.two_plane_pair`, a
   known F): at least 15 inliers, at least 8 on each plane, the true
   correspondences within 2 px of F's epipolar lines; times 3 runs of
   each after 1 warm-up and traces one of each;
12. runs HardNet, AffNet and OriNet (desc/cnn.py) on 8192 seeded 32x32
   patches on the card and on the CPU: error, ms per call, FLOP bound;
   HardNet at its committed weights, AffNet and OriNet at seeded random
   weights (their files are not in the repository; the opt-in
   MODS_TPU_ALLOW_RANDOM_CNN is set for them), each net's source printed;
13. runs match_images with HardNet as the descriptor of the classic
   detector on a 640x800 warp pair (one identity step): at least 15
   inliers, H within 2 px; times 3 runs after 1 warm-up and traces one;
   then, with no threshold, the two-step HardNet schedule on the tilted
   640x800 pair at 2048 keypoints;
14. runs the deep flagship (models/deep.match_pair_deep, testing.deep_config,
   8192 keypoints) on a 640x800 warp pair: B2 at P 32 three times a view,
   no Baumberg kernel; times 5 pairs after 2 warm-ups and traces one;
15. runs the deep flagship on a 256x320 pair and a HardNet step on a
   128x160 pair (B4 at P 32) on the card and on the CPU with the same
   RANSAC uniforms, and compares the counts;
16. runs the entry points users run, in a temporary directory: the `mods`
   command (cli.py) on PNG files of the 640x800 MODS pair with the MODS
   schedule from an iters INI (its .h, matchings, k1 / k2 and log files
   parse back to the result; run_mods equals match_images with the same
   draws; its median of 3 beside the MODS phase's match_images median:
   the command's I/O cost, and each I/O part once), `extract` and
   `extract_batch --shard 0/2` and `1/2` (the second skips its output);
   the three ZMQ daemons (serve/zmq_server.py) on free localhost ports
   with 8192 patches a
   head (each reply equals the net's forward; ms through the daemon
   beside the forward; a dead port raises); a one-process NCCL group with
   parallel/mesh.py's sharded_knn (equal to the dense kNN) and
   batch_match_sharded on 4 640x800 pairs (equal to match_pairs with the
   same per-pair generators); extract_view with the external affine-shape,
   orientation and descriptor commands (a mock tool);
   every kernel shape that a path launches and the kernel phase has no
   row for gets a row on the path's own arguments (`rows_for_launches`),
   and every launch must have one (`check_shapes_timed`);
17. trains the descriptor (train_phase): jitter pairs on 8 512x512 base
   images (desc/data.generate_pairs: B1, B2, B3 launch, B4 does not, no
   plain kernel version reached), pipeline pairs on 2 images x 2 views
   (generate_pairs_pipeline, AffNet / OriNet random: B2), one training
   step card against CPU (and float64), 200 steps of HardNet at batch 1024
   (tools/train_hardnet.train: the loss must fall; ms a step beside its
   FLOP bound), and the saved file reloaded into the inference HardNet;
18. runs the repository's tools (tools_phase) as a user runs them, each a
   `python -m mods_tpu_torch.tools.<name>` process on the 640x800 warp
   pair written as PNG files: golden_run (its counts equal match_images
   in this process with the same draws), eval_deep (the committed HardNet
   and the checkpoint trained above), export_native (its files parse back
   to its counts), diag_deep, diag_deep_ab and profile (every stage of its
   three sections timed); then profile.main in this process, which must
   launch dma_baumberg, dma_hat_resample and baumberg_windows;
19. prints an "octave_extrema" line after 1b, then a "pair_640x800", a "pair_640x240", a MODS, an every-detector MODS, an
   "f_verifiers_graf", a "mods_f_640x800", a "cnn_forwards", a
   "hardnet_640x800", a "deep_640x800", a "cli_640x800", a "serve", a
   "parallel", an "external_commands_640x800", a "train_hardnet", a
   "tools_640x800" and a "kernels" JSON line, the nvidia-smi line, and last {"ok": true,
   "device": {...}}.

Any failed check raises, so the script exits non-zero; it exits 2 without
a CUDA device.  It imports nothing of JAX.
"""
import bisect
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# float operations counted from the kernel source.  Resample, per output
# sample of a live row: position 8, window test 2; and per sample the test
# admits: tent weights 8, bilinear 9
RESAMPLE_TEST_FLOPS = 10
RESAMPLE_TAP_FLOPS = 17
# Baumberg, per patch sample and iteration: step matrix 4, position and
# test 10, gradient 2, SMM products 5, sums 3 (plus the 17 tap operations
# of each admitted sample); and ~60 per keypoint and iteration for the
# 2x2 update
BAUMBERG_SAMPLE_FLOPS = 24
BAUMBERG_STEP_FLOPS = 60
SECTOR = 32   # bytes: the smallest access of the card's memory


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def event_ms(fn, reps):
    """Mean ms of `reps` calls of `fn` between two CUDA events after one
    warm call: the host's work is timed too (used for the plain versions,
    whose host-side loops a graph cannot hold)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20):
    """Device ms of one call of `fn`: `reps` calls captured in one CUDA
    graph, replayed once warm and once between two CUDA events, so the
    host's launch overhead is not in the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Footprint:
    """The distinct 32-byte sectors of one source tensor that a kernel's
    admitted bilinear samples touch (4 taps each): the bytes the function
    must read of it.  `flat(y, x)` maps window-local tap rows and columns
    [n, S] to flat element indices of the source."""

    def __init__(self, pk, src, flat, WY, WX):
        import torch
        self.pk, self.flat, self.WY, self.WX = pk, flat, WY, WX
        self.occ = torch.zeros((src.numel() * src.element_size() + SECTOR - 1)
                               // SECTOR, dtype=torch.bool, device=src.device)
        self.per_sector = SECTOR // src.element_size()
        self.admitted = 0

    def add(self, px, py, live, ox, oy, lw, lh):
        inb, _, _, x0, y0 = self.pk._footprint(px, py, ox, oy, lw, lh,
                                               self.WY, self.WX)
        inb = inb & live[:, None]
        self.admitted += int(inb.sum())
        for dy in (0, 1):
            for dx in (0, 1):
                self.occ[self.flat(y0 + dy, x0 + dx)[inb] // self.per_sector] = True

    @property
    def nbytes(self):
        return int(self.occ.sum()) * SECTOR


def pyr_flat(stack, lev, oy, ox):
    _, H, W = stack.shape
    lev, oy, ox = lev.long()[:, None], oy.long()[:, None], ox.long()[:, None]
    return lambda y, x: (lev * H + oy + y) * W + ox + x


def win_flat(wins):
    import torch
    n, Wn, _ = wins.shape
    k = torch.arange(n, device=wins.device)[:, None]
    return lambda y, x: (k * Wn + y) * Wn + x


def bound_ms(nbytes, flops):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


STAGES = ("detect", "mip_pyramid", "orientation", "describe", "match",
          "duplicate_filter", "ransac")
# the MODS loop's spans: its TimeLog phases
MODS_STAGES = ("SynthTime", "DetectTime", "OrientTime", "DescTime", "MatchTime",
               "MiscTime", "RANSACTime")


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _ms(v):
    return "not measured" if v is None else f"{v:.1f}"


def span_device_ms(dev_events, stages):
    """Device ms of the work under each span in `stages`: the summed
    durations of the device's own events (kernels, copies, fills) that lie
    inside the span's extent on the device (its `gpu_user_annotation`),
    repeated spans of a name merged first.  The extent itself also holds
    the device's idle gaps, so it is not the work.  None for a span that
    left no extent on the device."""
    work = sorted((e.time_range.start, e.time_range.end)
                  for e in dev_events if not e.is_user_annotation)
    starts = [s for s, _ in work]
    out = {}
    for name in stages:
        extents = _merged((a.time_range.start, a.time_range.end) for a in dev_events
                          if a.is_user_annotation and a.name == name)
        if not extents:
            out[name] = None
            continue
        us = 0
        for lo, hi in extents:
            for s, e in work[bisect.bisect_left(starts, lo):]:
                if s >= hi:
                    break
                if e <= hi:
                    us += e - s
        out[name] = us / 1e3
    return out


def stage_profile(torch, run, stages=STAGES, table=True):
    """One traced run of `run`: host ms of each record_function span in
    `stages` and the device ms of the work under it (`span_device_ms`),
    the device's busy time against the wall time, the kernels with the
    most device time and the operators with the most host time of their
    own.  The spans' device ms add up to at most the busy
    time.  With `table`, the key_averages table goes to standard error."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    busy = sum(e.device_time_total for e in dev_events
               if not e.is_user_annotation) / 1e3
    under = span_device_ms(dev_events, stages)
    check(sum(v for v in under.values() if v) <= busy * (1 + 1e-6) + 1e-3,
          f"spans' device ms {under} exceed the busy {busy:.3f} ms")
    avg = prof.key_averages()
    stages = {e.key: dict(host_ms=e.cpu_time_total / 1e3, device_ms=under[e.key])
              for e in avg if e.key in stages and e.device_type != cuda}
    top = sorted((e for e in avg if e.device_type == cuda
                  and not e.is_user_annotation),
                 key=lambda e: e.device_time_total, reverse=True)[:8]
    kernels = [dict(name=e.key[:90], calls=e.count,
                    device_ms=e.device_time_total / 1e3) for e in top]
    host = sorted((e for e in avg if e.device_type != cuda and e.key not in stages),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    host_ops = [dict(name=e.key[:90], calls=e.count, self_host_ms=e.self_cpu_time_total / 1e3)
                for e in host]
    if table:
        print(avg.table(sort_by="self_device_time_total", row_limit=40),
              file=sys.stderr)
    return dict(wall_ms=wall, device_busy_ms=busy,
                device_busy_share=busy / wall, stages=stages,
                top_device_kernels=kernels, top_host_ops=host_ops)


# --------------------------------------------------------------------------- #
# kernel inputs at the main path's shapes
# --------------------------------------------------------------------------- #
def _affines(rng, n, max_extent):
    th = rng.uniform(-np.pi, np.pi, n)
    an = rng.uniform(1.0, 3.0, n)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    D = np.zeros((n, 2, 2))
    D[:, 0, 0] = an
    D[:, 1, 1] = 1.0 / an
    A = R @ D
    sc = rng.uniform(0.05, 1.0, n) * max_extent / np.abs(A).sum(-1).max(-1)
    return (A * sc[:, None, None]).astype(np.float32)


def _positions(rng, n, H, W):
    """n positions over [0, W) x [0, H) (extents scalar or per position),
    n // 64 of them on the left or right border and as many on the top or
    bottom one."""
    W = np.broadcast_to(np.asarray(W, np.float32), (n,))
    H = np.broadcast_to(np.asarray(H, np.float32), (n,))
    x = (rng.uniform(0, 1, n) * W).astype(np.float32)
    y = (rng.uniform(0, 1, n) * H).astype(np.float32)
    k = n // 64
    x[:k] = np.where(rng.uniform(0, 1, k) < 0.5, 0.5, W[:k] - 1.5)
    y[k:2 * k] = np.where(rng.uniform(0, 1, k) < 0.5, 0.5, H[k:2 * k] - 1.5)
    return x, y


def resample_args(pk, pe, pyr, lev, x, y, A, live):
    """DMA resample arguments on the pyramid `pyr` from numpy arrays:
    levels, positions in level pixels, step matrices and live flags."""
    import torch
    dev = pyr.device
    _, H, W = pyr.shape
    lev = np.asarray(lev, np.int32)
    sp = np.asarray(pe._LEVEL_SPACING, np.float32)[lev]
    lw = (W / sp).astype(np.int32)
    lh = (H / sp).astype(np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x, y, A = (np.asarray(a, np.float32) for a in (x, y, A))
    oy, ox = pk.dma_window_origins(t(x), t(y), t(lw), t(lh))
    params = torch.stack([t(x) - ox, t(y) - oy, t(A[:, 0, 0]), t(A[:, 0, 1]),
                          t(A[:, 1, 0]), t(A[:, 1, 1]), ox.float(), oy.float(),
                          t(lw).float(), t(lh).float(),
                          t(np.asarray(live, np.float32))], -1).contiguous()
    return t(lev), oy.contiguous(), ox.contiguous(), params


def level_extents(pe, pyr, lev):
    _, H, W = pyr.shape
    sp = np.asarray(pe._LEVEL_SPACING, np.float32)[lev]
    return (H / sp).astype(np.int32), (W / sp).astype(np.int32)


def resample_inputs(pk, pe, pyr, n, P, seed):
    """Main-path-like DMA resample arguments on the pyramid `pyr`."""
    rng = np.random.default_rng(seed)
    lev = rng.integers(0, pyr.shape[0], n).astype(np.int32)
    lh, lw = level_extents(pe, pyr, lev)
    x, y = _positions(rng, n, lh, lw)
    A = _affines(rng, n, 46.0 / (P // 2))
    live = (rng.uniform(0, 1, n) > 0.2).astype(np.float32)
    return resample_args(pk, pe, pyr, lev, x, y, A, live)


def box_areas(pk, params, ox, P, aligned):
    """Floats in the box that dma_hat_resample stages for each keypoint,
    and which boxes are empty."""
    xlo, xhi, ylo, yhi, empty = pk.footprint_boxes(
        params, ox, P, pk.DMA_WIN_Y, pk.DMA_WIN_X, aligned)
    return (xhi - xlo + 1) * (yhi - ylo + 1), empty


def resample_edge_cases(torch, pk, pe, pyr):
    """dma_hat_resample against its plain version, max error 0, on the
    cases its paths could get wrong.  Returns the cases' names."""
    L = pyr.shape[0]
    aligned = pyr.shape[2] % 4 == 0 and pyr.data_ptr() % 16 == 0
    cases = {}

    def case(name, P, lev, x, y, A, live=None, want_direct=False):
        live = np.ones(len(lev)) if live is None else live
        cases[name] = (P, resample_args(pk, pe, pyr, lev, x, y, A, live),
                       want_direct)

    # every border and corner of one level of each spacing, and just outside
    rng = np.random.default_rng(77)
    for l in (0, 7, 11, 15, 19):
        lh, lw = (int(v[0]) for v in level_extents(pe, pyr, np.array([l])))
        xs = np.array([0.5, lw - 1.5, lw / 2, lw / 2, 0.5, lw - 1.5, 0.0,
                       lw - 1.0, -3.0, lw + 5.0, lw / 2, 0.5], np.float32)
        ys = np.array([lh / 2, lh / 2, 0.5, lh - 1.5, 0.5, lh - 1.5, 0.0,
                       lh - 1.0, -3.0, lh / 2, lh + 5.0, lh - 1.5], np.float32)
        n = len(xs)
        case(f"borders of level {l}", 41, np.full(n, l), xs, ys,
             _affines(rng, n, 40.0 / 20))
    # patches larger than the staging buffer, among ones that fit
    n = 64
    lev = rng.integers(0, L, n)
    lh, lw = level_extents(pe, pyr, lev)
    x, y = _positions(rng, n, lh, lw)
    A = _affines(rng, n, 46.0 / 20)
    A[::2] *= rng.uniform(2.0, 6.0, n // 2).astype(np.float32)[:, None, None]
    case("larger than the staging buffer", 41, lev, x, y, A, want_direct=True)
    # every row dead; one keypoint; a count that is odd and prime; a patch
    # wider than a block has threads (the wide-patch path)
    for name, n, P, dead in (("all rows dead", 40, 41, True), ("n = 1", 1, 41, False),
                             ("n = 37", 37, 19, False), ("P = 131", 9, 131, False)):
        lev = rng.integers(0, L, n)
        lh, lw = level_extents(pe, pyr, lev)
        case(name, P, lev, rng.uniform(0, 1, n) * lw, rng.uniform(0, 1, n) * lh,
             _affines(rng, n, 46.0 / (P // 2)),
             live=np.zeros(n) if dead else None)
    # every level of the pyramid (spacings 1, 2, 4, 8 and 16), twice each
    lev = np.repeat(np.arange(L), 2)
    lh, lw = level_extents(pe, pyr, lev)
    n = len(lev)
    case("every level", 41, lev, rng.uniform(0, 1, n) * lw,
         rng.uniform(0, 1, n) * lh, _affines(rng, n, 46.0 / 20))

    for name, (P, (lev, oy, ox, params), want_direct) in cases.items():
        got = pk.dma_hat_resample(pyr, lev, oy, ox, params, P)
        ref = pk.plain_dma_hat_resample(pyr, lev, oy, ox, params, P)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(err == 0.0, f"dma_hat_resample, {name}: max abs err {err}")
        if want_direct:
            area, empty = box_areas(pk, params, ox, P, aligned)
            direct = int((~empty & (area > pk.STAGE_FLOATS)).sum())
            fit = int((~empty & (area <= pk.STAGE_FLOATS)).sum())
            check(direct >= 8 and fit >= 8,
                  f"{name}: {direct} keypoints read in place, {fit} staged")
        if name == "all rows dead":
            check(bool((got == 0).all()), "all rows dead: output not zero")
        elif not name.startswith("borders"):
            check(int(got.count_nonzero()) > got.numel() // 8,
                  f"{name}: output nearly all zero")
    return list(cases)


def window_resample_inputs(torch, pk, pe, pyr, n, P, seed):
    """Main-path-like hat_resample arguments on the pyramid `pyr` of an
    image narrower than the DMA window: random levels, positions over each
    level's extent, windows cropped as sample_patches crops them."""
    rng = np.random.default_rng(seed)
    dev = pyr.device
    L, H, W = pyr.shape
    levn = rng.integers(0, L, n).astype(np.int32)
    lh, lw = level_extents(pe, pyr, levn)
    x, y = _positions(rng, n, lh, lw)
    A = _affines(rng, n, 46.0 / (P // 2))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cx, cy, lwv, lhv, lev, A = t(x), t(y), t(lw), t(lh), t(levn), t(A)
    win = min(pe.WIN, H, W)
    ox = torch.minimum(torch.clamp(torch.floor(cx).to(torch.int32) - win // 2, min=0),
                       torch.clamp(lwv - win, min=0))
    oy = torch.minimum(torch.clamp(torch.floor(cy).to(torch.int32) - win // 2, min=0),
                       torch.clamp(lhv - win, min=0))
    wins = pe._gather_windows(pyr, lev, oy, ox, win)
    params = torch.stack([cx - ox, cy - oy, A[:, 0, 0], A[:, 0, 1], A[:, 1, 0],
                          A[:, 1, 1], ox.float(), oy.float(), lwv.float(),
                          lhv.float()], -1).contiguous()
    return wins, params


# a staging buffer that holds a whole 96x96 window
WHOLE_WINDOW_FLOATS = 96 * 96


def hat_resample_staged(pk, wins, params, P, stage_floats):
    """hat_resample's kernel with a staging buffer of `stage_floats`
    floats, whatever the wrapper would give patches of width P."""
    return pk._launch_resample_win(wins, params, P, stage_floats)


def window_resample_edge_cases(torch, pk, textured_image):
    """hat_resample against its plain version, max error 0, on the cases
    its paths could get wrong, each as the wrapper launches it for that
    patch width, with no staging buffer, with STAGE_FLOATS and with one
    that holds the whole window.  Returns the cases' names."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(78)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    cases = {}

    def case(name, n, Wn, P, A=None, cx=None, cy=None, lw=128.0, lh=96.0,
             offset=0, zero=False):
        buf = t(np.concatenate([np.zeros(offset, np.float32),
                                textured_image(n * Wn, Wn, len(cases)).ravel()]))
        wins = buf[offset:].view(n, Wn, Wn)
        cx = rng.uniform(-2, Wn + 2, n) if cx is None else cx
        cy = rng.uniform(-2, Wn + 2, n) if cy is None else cy
        A = _affines(rng, n, (Wn - 4) / 2.0 / (P // 2)) if A is None else A
        ox = rng.integers(0, 33, n)
        params = t(np.stack([cx, cy, A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1],
                             ox, np.zeros(n), np.full(n, lw), np.full(n, lh)], -1))
        cases[name] = (wins, params, P, zero)

    for Wn in (96, 64, 50):        # 50: no 16-byte copies
        for P in (19, 41):
            case(f"windows of {Wn}, P {P}", 48, Wn, P, lw=Wn + 32.0, lh=float(Wn))
    n = 16
    case("patch off its window", n, 96, 41, zero=True,
         cx=np.where(np.arange(n) % 2 == 0, -200.0, 400.0), cy=np.full(n, 48.0))
    case("patch off its window below", n, 96, 19, zero=True,
         cx=np.full(n, 48.0), cy=np.where(np.arange(n) % 2 == 0, -90.0, 190.0))
    case("P 129 (the wide-patch path)", 5, 96, 129)
    A = _affines(rng, n, 2.0)
    A[0] = [[3e37, 0.0], [0.0, 1.0]]
    A[1] = [[np.inf, 0.0], [0.0, 1.0]]
    A[2] = [[np.nan, 0.0], [0.0, 1.0]]
    A[3] = [[3e37, -3e37], [1.0, 0.5]]
    A[4] = [[1.0, 0.5], [np.nan, np.nan]]
    A[5] = [[0.0, 0.0], [0.0, 0.0]]
    case("NaN and infinite steps", n, 96, 41, A=A)
    case("all-dead geometry (level extent 0)", n, 96, 41, lw=0.0, lh=0.0, zero=True)
    case("windows off a 16-byte line", 24, 96, 41, offset=1)
    case("n = 1", 1, 96, 41, cx=np.array([48.0]), cy=np.array([48.0]))
    case("n = 37, P 19", 37, 96, 19)
    # boxes larger than the default staging buffer among ones that fit
    n = 64
    A = _affines(rng, n, 46.0 / 20) * 0.5
    th = rng.uniform(-np.pi, np.pi, n // 2)      # rotations reaching +-46 px
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    A[1::2] = R * (2.3 / (np.abs(np.cos(th)) + np.abs(np.sin(th))))[:, None, None]
    case("larger than the staging buffer", n, 96, 41, A=A,
         cx=np.full(n, 48.0), cy=np.full(n, 48.0))

    for name, (wins, params, P, zero) in cases.items():
        ref = pk.plain_hat_resample(wins, params, P)
        outs = {"default": pk.hat_resample(wins, params, P),
                "unstaged": hat_resample_staged(pk, wins, params, P, 0),
                "staged": hat_resample_staged(pk, wins, params, P,
                                              pk.STAGE_FLOATS),
                "whole window staged": hat_resample_staged(
                    pk, wins, params, P, WHOLE_WINDOW_FLOATS)}
        torch.cuda.synchronize()
        for how, got in outs.items():
            err = float((got - ref).abs().max())
            check(err == 0.0, f"hat_resample, {name}, {how}: max abs err {err}")
        got = outs["default"]
        if zero:
            check(bool((got == 0).all()), f"hat_resample, {name}: output not zero")
        elif name.startswith("NaN"):
            check(bool(torch.isfinite(got).all()), f"hat_resample, {name}: not finite")
        else:
            check(int(got.count_nonzero()) > got.numel() // 8,
                  f"hat_resample, {name}: output nearly all zero")
        if name.startswith("larger"):
            Wn = wins.shape[-1]
            xlo, xhi, ylo, yhi, empty = pk.footprint_boxes(
                params, torch.zeros(len(params), dtype=torch.int32, device=dev),
                P, Wn, Wn, True)
            area = (xhi - xlo + 1) * (yhi - ylo + 1)
            direct = int((~empty & (area > pk.STAGE_FLOATS)).sum())
            fit = int((~empty & (area <= pk.STAGE_FLOATS)).sum())
            check(direct >= 8 and fit >= 8,
                  f"{name}: {direct} keypoints read in place, {fit} staged")
    return list(cases)


def resample_positions(pk, params, P):
    """Window-local sample positions [n, P*P] of the resample kernels."""
    ig, jg = pk._grid(P, params.device)
    px = params[:, 0:1] + ig * params[:, 2:3] + jg * params[:, 3:4]
    py = params[:, 1:2] + ig * params[:, 4:5] + jg * params[:, 5:6]
    return px, py


def grid_sample_dma(pk, pyr, lev, params, P):
    """grid_sample over the same sample positions (3-D, exact level)."""
    import torch
    L, H, W = pyr.shape
    px, py = resample_positions(pk, params, P)
    px, py = px + params[:, 6:7], py + params[:, 7:8]
    gz = (2.0 * lev.float() / (L - 1) - 1.0)[:, None].expand_as(px)
    grid = torch.stack([2.0 * px / (W - 1) - 1.0, 2.0 * py / (H - 1) - 1.0, gz], -1)
    grid = grid.reshape(1, -1, P * P, 1, 3)
    inp = pyr[None, None]
    return lambda: torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def grid_sample_win(pk, wins, params, P):
    import torch
    n, Wn, _ = wins.shape
    px, py = resample_positions(pk, params, P)
    grid = torch.stack([2.0 * px / (Wn - 1) - 1.0, 2.0 * py / (Wn - 1) - 1.0],
                       -1).reshape(n, P, P, 2)
    inp = wins[:, None]
    return lambda: torch.nn.functional.grid_sample(
        inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def resample_bound(pk, src, flat, WY, WX, params, live, P, fixed_bytes):
    """Bound of a resample launch from what its data needs: the sectors its
    admitted taps touch, plus `fixed_bytes` (params, indices, output); the
    test for every sample of a live row, the taps for the admitted ones."""
    fp = Footprint(pk, src, flat, WY, WX)
    px, py = resample_positions(pk, params, P)
    fp.add(px, py, live, params[:, 6], params[:, 7], params[:, 8], params[:, 9])
    flops = (int(live.sum()) * P * P * RESAMPLE_TEST_FLOPS
             + fp.admitted * RESAMPLE_TAP_FLOPS)
    return bound_ms(fp.nbytes + fixed_bytes, flops) + (fp.nbytes,)


def blur_stack(torch, imops, textured_image, H, W):
    base = torch.from_numpy(textured_image(H, W, H)).to("cuda")
    return torch.stack([imops.gaussian_blur(base, 1.6 * 1.26 ** i)
                        for i in range(5)]).contiguous()


class baumberg_case:
    """Arguments of one Baumberg launch on `stack` ([5,H,W] blurs), made
    from `seed`: `name` picks dma_baumberg (windows of the stack in place)
    or baumberg_windows (precropped windows of 104x104, or of the stack's
    smaller side).  `run` and `plain` call the kernel and the plain version
    on `args`; `plain_cpu` gives the plain version's result on the CPU,
    where its sums run in another order."""

    def __init__(self, torch, pk, pe, imops, name, stack, n, ws, seed,
                 invalid_share=0.1, max_iter=16):
        dev = stack.device
        self.pk, self._plain_cpu = pk, None
        _, H, W = stack.shape
        rng = np.random.default_rng(seed)
        x, y = _positions(rng, n, H, W)
        ratio = rng.uniform(1.0, 2.05, n).astype(np.float32)
        valid = rng.uniform(0, 1, n) > invalid_share
        levn = rng.integers(0, 3, n).astype(np.int32)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        lx, ly, lev, vf = t(x), t(y), t(levn), t(valid.astype(np.float32))
        mask = torch.from_numpy(imops.gauss_mask(ws)).to(dev)
        self.valid = t(valid)
        if name == "dma_baumberg":
            oy, ox = pk.dma_window_origins(lx, ly, torch.full_like(lev, W),
                                           torch.full_like(lev, H))
            ox, oy = ox.contiguous(), oy.contiguous()
        else:
            wins, ox, oy = pe.crop_windows(stack, lev, torch.stack([lx, ly], -1), 104)
        params = torch.stack([lx - ox, ly - oy, t(ratio), vf, ox.float(), oy.float(),
                              torch.full_like(lx, W), torch.full_like(lx, H)],
                             -1).contiguous()
        self.params = params
        if name == "dma_baumberg":
            self.args = args = (stack, lev, oy, ox, params, mask, ws, max_iter, 0.05)
            self.run = lambda: pk.dma_baumberg(*args)
            self.plain = lambda trace=None: pk.plain_dma_baumberg(*args, trace=trace)
            self.kind, self.src = "stack", stack
            self.fp = Footprint(pk, stack, pyr_flat(stack, lev, oy, ox),
                                pk.DMA_WIN_Y, pk.DMA_WIN_X)
            self.fixed = nbytes(lev, oy, ox, params, mask)
        else:
            self.args = args = (wins, params, mask, ws, max_iter, 0.05)
            self.run = lambda: pk.baumberg_windows(*args)
            self.plain = lambda trace=None: pk.plain_baumberg_windows(*args, trace=trace)
            self.kind, self.src = "wins", wins
            Wn = wins.shape[-1]
            self.fp = Footprint(pk, wins, win_flat(wins), Wn, Wn)
            self.fixed = nbytes(params, mask)


    def plain_cpu(self):
        if self._plain_cpu is None:
            args = [a.cpu() if hasattr(a, "cpu") else a for a in self.args]
            plain = (self.pk.plain_dma_baumberg if self.kind == "stack"
                     else self.pk.plain_baumberg_windows)
            self._plain_cpu = [t.to(self.src.device) for t in plain(*args)]
        return self._plain_cpu


def baumberg_agreement(U, ok, U_ref, ok_ref, valid):
    """Share of valid keypoints whose accept flags agree, and the largest
    U difference over keypoints both accept."""
    agree = float((ok == ok_ref)[valid].float().mean()) if bool(valid.any()) else 1.0
    both = ok & ok_ref
    err = float((U - U_ref).abs()[both].max()) if bool(both.any()) else 0.0
    return agree, err


def held_to_plain(c, what, U, ok, U_ref, ok_ref):
    """Checks one Baumberg result of case `c` against the plain version's
    on the card: accept flags agree on >= 0.995 of the valid keypoints, U
    within 1e-3 on those both accept.  The window test is a step: where a
    sample lies within a rounding error of its threshold, the order of the
    sums decides whether it counts, and U moves by up to a whole
    iteration's step.  Such a keypoint is let off only if the plain
    version itself moves there by more than 1e-3 between the card and the
    CPU, and only 0.5 % of the accepted may be such.  Returns the flags'
    agreement, the largest U difference over the others, and how many
    were let off."""
    agree, err = baumberg_agreement(U, ok, U_ref, ok_ref, c.valid)
    check(agree >= 0.995, f"{what}: ok flags agree on {agree:.4f} of live")
    unstable = 0
    if err > 1e-3:
        both = ok & ok_ref
        far = both & ((U - U_ref).abs().amax((1, 2)) > 1e-3)
        U_cpu, ok_cpu = c.plain_cpu()
        moved = ~ok_cpu | ((U_cpu - U_ref).abs().amax((1, 2)) > 1e-3)
        unstable = int(far.sum())
        check(bool(moved[far].all()) and unstable <= 0.005 * int(both.sum()),
              f"{what}: U max abs err {err} on {unstable} keypoints, "
              f"{int((far & ~moved).sum())} of them where the plain version "
              "is stable")
        _, err = baumberg_agreement(U, ok & ~far, U_ref, ok_ref, c.valid)
    check(err <= 1e-3, f"{what}: U max abs err {err}")
    return agree, err, unstable


def baumberg_edge_cases(torch, pk, pe, imops, textured_image, name, stack, seed):
    """The Baumberg kernel `name` against its plain version where it could
    go wrong.  Returns the cases' names."""
    cases = [("all keypoints invalid", stack, 64, 19, 1.0),
             ("n = 1", stack, 1, 19, 0.0),
             ("n = 4097", stack, 4097, 19, 0.1),
             ("patch width 11", stack, 513, 11, 0.1),
             ("patch width 31", stack, 130, 31, 0.1),
             ("patch width 3", stack, 40, 3, 0.1)]
    if name == "baumberg_windows":
        # the small octaves of a 640x800 image: windows of 40x40 and 20x20
        cases += [(f"stack of {h}x{w}", blur_stack(torch, imops, textured_image, h, w),
                   n, 19, 0.1) for h, w, n in ((40, 50, 256), (20, 25, 128))]
    for i, (label, src, n, ws, invalid) in enumerate(cases):
        c = baumberg_case(torch, pk, pe, imops, name, src, n, ws,
                          seed + 1 + i, invalid)
        U_ref, ok_ref = c.plain()
        what = f"{name}, {label}"
        U, ok = c.run()
        torch.cuda.synchronize()
        held_to_plain(c, what, U, ok, U_ref, ok_ref)
        check(not bool(ok[~c.valid].any()), f"{what}: invalid row accepted")
        eye = torch.eye(2, device=U.device)
        check(bool((U[~ok] == eye).all()), f"{what}: rejected U not identity")
        if ws == 19 and n > 100 and src is stack:
            check(int(ok.sum()) > n // 10, f"{what}: {int(ok.sum())} accepted")
        # the sums have a fixed order: a second run gives the same bits
        U2, ok2 = c.run()
        check(bool((U2 == U).all()) and bool((ok2 == ok).all()),
              f"{what}: two runs differ")
    return [c[0] for c in cases] + ["two runs bit-equal"]


def baumberg_row(torch, pk, c, name, n, ws):
    """One Baumberg launch (case `c`) against its plain version: the
    kernel's time, and the bound from the samples the keypoints took,
    iteration by iteration."""
    trace = []
    U_ref, ok_ref = c.plain(trace)
    U, ok = c.run()
    agree, err, unstable = held_to_plain(c, f"{name} n={n}", U, ok, U_ref, ok_ref)
    U2, ok2 = c.run()
    check(bool((U2 == U).all()) and bool((ok2 == ok).all()),
          f"{name} n={n}: two runs differ")
    ms = device_ms(c.run)
    plain_ms = event_ms(c.plain, 3)
    steps = 0
    chain = torch.zeros(n, dtype=torch.int64, device=U.device)
    params = c.params
    for px, py, act in trace:
        steps += int(act.sum())
        chain += act
        c.fp.add(px, py, act, params[:, 4], params[:, 5], params[:, 6],
                 params[:, 7])
    flops = (steps * (ws * ws * BAUMBERG_SAMPLE_FLOPS + BAUMBERG_STEP_FLOPS)
             + c.fp.admitted * RESAMPLE_TAP_FLOPS)
    b, by = bound_ms(c.fp.nbytes + c.fixed + nbytes(U, ok), flops)
    row = dict(shape=f"{c.kind} {tuple(c.src.shape)}, n={n}", ms=ms,
               plain_ms=plain_ms, library_ms=None,
               bound_ms=b, bound_by=by, max_abs_err=err, ok_agree=agree,
               unstable_in_plain=unstable,
               iterations=steps, longest_chain=int(chain.max()),
               accepted=int(ok.sum()), source_bytes_read=c.fp.nbytes,
               launch=[name, list(c.src.shape), n, None])
    print(f"{name} {row['shape']}: {ms:.4f} ms (plain {plain_ms:.3f}, bound {b:.4f} by {by}, {c.fp.nbytes} B of the "
          f"source touched), ok agree {agree:.4f}, U err {err:.2e} ({unstable} "
          f"let off where the plain version is unstable), {steps} "
          f"iterations, longest chain {int(chain.max())}, {int(ok.sum())} accepted")
    return row


def hat_resample_row(torch, pk, wins, params, P):
    """hat_resample on one launch's arguments: error against the plain
    version (0), and the times of the kernel as the wrapper launches it,
    with no staging buffer and with STAGE_FLOATS, of the plain version and
    of grid_sample, beside the bound."""
    n, Wn = wins.shape[0], wins.shape[-1]
    run = lambda: pk.hat_resample(wins, params, P)
    got = run()
    ref = pk.plain_hat_resample(wins, params, P)
    err = float((got - ref).abs().max())
    check(err == 0.0, f"hat_resample P={P} n={n}: max abs err {err}")
    check(int(got.count_nonzero()) > got.numel() // 8,
          f"hat_resample P={P} n={n}: output nearly all zero")
    ms = device_ms(run)
    by_stage = {}
    for label, size in (("ms_unstaged", 0), ("ms_staged", pk.STAGE_FLOATS)):
        sized = lambda: hat_resample_staged(pk, wins, params, P, size)
        check(bool((sized() == ref).all()),
              f"hat_resample P={P} n={n} with a buffer of {size} floats differs")
        by_stage[label] = device_ms(sized)
    del ref
    plain = event_ms(lambda: pk.plain_hat_resample(wins, params, P), 3)
    lib = device_ms(grid_sample_win(pk, wins, params, P))
    b, by, read = resample_bound(pk, wins, win_flat(wins), Wn, Wn, params,
                                 torch.ones(n, dtype=torch.bool, device=wins.device),
                                 P, nbytes(params, got))
    xlo, xhi, ylo, yhi, empty = pk.footprint_boxes(
        params, torch.zeros(n, dtype=torch.int32, device=wins.device), P, Wn, Wn,
        Wn % 4 == 0)
    area = ((xhi - xlo + 1) * (yhi - ylo + 1))[~empty]
    row = dict(shape=f"wins {tuple(wins.shape)}, P={P}", ms=ms,
               launch=["hat_resample", list(wins.shape), n, P],
               **by_stage, stage_floats=pk.win_stage_floats(P), plain_ms=plain,
               library_ms=lib, bound_ms=b, bound_by=by, max_abs_err=err,
               source_bytes_read=read, missed_window=int(empty.sum()),
               mean_box_floats=float(area.float().mean()),
               boxes_over_buffer=int((area > pk.STAGE_FLOATS).sum()))
    print(f"hat_resample n={n} P={P}: {ms:.4f} ms ("
          f"unstaged {by_stage['ms_unstaged']:.4f}, staged "
          f"{by_stage['ms_staged']:.4f}, plain {plain:.3f}, grid_sample {lib:.4f}, "
          f"bound {b:.4f} by {by}, {read} B of the windows touched), err "
          f"{err:.2e}; {int(empty.sum())} off their window, boxes of "
          f"{row['mean_box_floats']:.0f} floats on average, "
          f"{row['boxes_over_buffer']} over {pk.STAGE_FLOATS}")
    return row


def dma_resample_row(torch, pk, pyr, lev, oy, ox, params, P):
    """dma_hat_resample on one launch's arguments: error against the plain
    version (0), dead rows zero, and the times of the kernel, of the
    kernel with no staging buffer, of the plain version and of
    grid_sample, beside the bound."""
    n = len(lev)
    run = lambda: pk.dma_hat_resample(pyr, lev, oy, ox, params, P)
    got = run()
    ref = pk.plain_dma_hat_resample(pyr, lev, oy, ox, params, P)
    err = float((got - ref).abs().max())
    check(err == 0.0, f"dma_hat_resample P={P} n={n}: max abs err {err}")
    live = params[:, 10] > 0.5
    check(bool((got[~live] == 0).all()), "dma_hat_resample: dead rows not zero")
    del ref
    ms = device_ms(run)
    # the same kernel with no staging buffer: every tap from global memory
    stage, pk.STAGE_FLOATS = pk.STAGE_FLOATS, 0
    try:
        check(bool((run() == got).all()),
              f"dma_hat_resample P={P} n={n} without staging differs")
        unstaged = device_ms(run)
    finally:
        pk.STAGE_FLOATS = stage
    plain = event_ms(lambda: pk.plain_dma_hat_resample(pyr, lev, oy, ox, params, P), 3)
    lib = device_ms(grid_sample_dma(pk, pyr, lev, params, P))
    b, by, read = resample_bound(
        pk, pyr, pyr_flat(pyr, lev, oy, ox), pk.DMA_WIN_Y, pk.DMA_WIN_X,
        params, live, P, nbytes(lev, oy, ox, params, got))
    area, empty = box_areas(pk, params, ox, P, pyr.shape[2] % 4 == 0)
    boxed = live & ~empty
    row = dict(shape=f"pyr {tuple(pyr.shape)}, n={n}, P={P}", ms=ms,
               ms_unstaged=unstaged, plain_ms=plain, library_ms=lib, bound_ms=b,
               bound_by=by, max_abs_err=err, source_bytes_read=read,
               live=int(live.sum()), missed_window=int((live & empty).sum()),
               mean_box_floats=float(area[boxed].float().mean()) if bool(boxed.any())
               else 0.0,
               boxes_over_buffer=int((boxed & (area > pk.STAGE_FLOATS)).sum()),
               launch=["dma_hat_resample", list(pyr.shape), n, P])
    print(f"dma_hat_resample P={P} n={n} on {tuple(pyr.shape)}: {ms:.4f} ms ("
          f"unstaged {unstaged:.4f}, plain {plain:.3f}, "
          f"grid_sample {lib:.4f}, bound {b:.4f} by {by}, {read} B of the "
          f"pyramid touched), err {err:.2e}; {row['live']} live, "
          f"{row['missed_window']} off their window, boxes of "
          f"{row['mean_box_floats']:.0f} floats on average, "
          f"{row['boxes_over_buffer']} over the staging buffer")
    return row


def kernel_checks(torch, pk, pe, imops, textured_image):
    """B1-B4 against their plain versions at the main path's shapes.  Each
    kernel and grid_sample is timed on the device (`device_ms`), each
    plain version with its host work (`event_ms`)."""
    dev = torch.device("cuda")
    rows = {}
    img = torch.from_numpy(textured_image(640, 800, 11)).to(dev)

    # ---- dma_hat_resample: orientation (P=19, n=4096) and descriptor
    #      (P=41, n=32768) patches on the 20-level 640x800 mip pyramid
    pyr = pe.build_mip_pyramid(img).contiguous()
    shapes = [dma_resample_row(torch, pk, pyr, *resample_inputs(pk, pe, pyr, n, P,
                                                                100 + P), P)
              for P, n in ((19, 4096), (41, 32768))]
    main = dict(shapes[-1])
    main["max_abs_err"] = max(s["max_abs_err"] for s in shapes)
    main["other_shapes"] = shapes[:-1]
    main["edge_cases"] = resample_edge_cases(torch, pk, pe, pyr)
    # a stack that allows no 16-byte copies (width no multiple of 4)
    narrow = pyr[:, :, :798].contiguous()
    main["edge_cases"] += [f"width 798: {c}" for c in
                           resample_edge_cases(torch, pk, pe, narrow)]
    print(f"dma_hat_resample: {len(main['edge_cases'])} edge cases agree "
          "with the plain version to 0")
    rows["dma_hat_resample"] = main

    # ---- hat_resample: descriptor patches of the 96x128 path (P=41,
    #      n=2048), its orientation patches (P=19, n=256), and orientation
    #      (P=19, n=4096) and descriptor (P=41, n=32768) patches on the mip
    #      pyramid of a 640x240 image
    pyr_s = pe.build_mip_pyramid(img[:96, :128].contiguous())
    n, P = 2048, 41
    rng = np.random.default_rng(5)
    xy = torch.from_numpy(np.stack([rng.uniform(0, 128, n), rng.uniform(0, 96, n)],
                                   -1).astype(np.float32)).to(dev)
    lev = torch.from_numpy(rng.integers(0, 8, n).astype(np.int32)).to(dev)
    wins, wox, woy = pe.crop_windows(pyr_s, lev, xy, pe.WIN)
    A = torch.from_numpy(_affines(rng, n, 46.0 / (P // 2))).to(dev)
    params = torch.stack([xy[:, 0] - wox, xy[:, 1] - woy, A[:, 0, 0], A[:, 0, 1],
                          A[:, 1, 0], A[:, 1, 1], wox.float(), woy.float(),
                          torch.full((n,), 128.0, device=dev),
                          torch.full((n,), 96.0, device=dev)], -1).contiguous()
    main = hat_resample_row(torch, pk, wins, params, P)
    del wins, params
    pyr_n = pe.build_mip_pyramid(img[:, :240].contiguous()).contiguous()
    main["other_shapes"] = []
    for src, P, n in ((pyr_s, 19, 256), (pyr_n, 19, 4096), (pyr_n, 41, 32768)):
        wins, params = window_resample_inputs(torch, pk, pe, src, n, P, 200 + P)
        main["other_shapes"].append(hat_resample_row(torch, pk, wins, params, P))
        del wins, params
    main["max_abs_err"] = max(r["max_abs_err"] for r in
                              [main, *main["other_shapes"]])
    main["edge_cases"] = window_resample_edge_cases(torch, pk, textured_image)
    print(f"hat_resample: {len(main['edge_cases'])} edge cases agree with the "
          "plain version to 0, staged and unstaged")
    rows["hat_resample"] = main
    torch.cuda.empty_cache()

    # ---- Baumberg: octave 0 of the 640x800 image (n=4096) on the DMA
    #      kernel; on precropped windows every octave that the pairs give
    #      to baumberg_windows, at its size (so its window width) and its
    #      cap of keypoints: octaves 2-5 of the 640x800 image, 0-4 of the
    #      640x240 image and 0-2 of the 96x128 image
    ws = 19
    for name, shapes in (("dma_baumberg", ((640, 800, 4096),)),
                         ("baumberg_windows", (
                             (160, 200, 1024), (80, 100, 512), (40, 50, 256),
                             (20, 25, 128),
                             (640, 240, 4096), (320, 120, 2048), (160, 60, 1024),
                             (80, 30, 512), (40, 15, 256),
                             (96, 128, 256), (48, 64, 128), (24, 32, 128)))):
        results, stacks = [], {}
        for H, W, n in shapes:
            if (H, W) not in stacks:
                stacks[H, W] = blur_stack(torch, imops, textured_image, H, W)
            stack = stacks[H, W]
            c = baumberg_case(torch, pk, pe, imops, name, stack, n, ws, H)
            results.append(baumberg_row(torch, pk, c, name, n, ws))
            # (a window narrower than 2.5 patches holds few whole patches)
            check(results[-1]["accepted"] > n // 10 or min(H, W) < 48,
                  f"{name} n={n}: only {results[-1]['accepted']} accepted")
        main = results[0]
        main["max_abs_err"] = max(r["max_abs_err"] for r in results)
        main["other_shapes"] = results[1:]
        H, W, _ = shapes[0]
        main["edge_cases"] = baumberg_edge_cases(
            torch, pk, pe, imops, textured_image, name, stacks[H, W], H)
        print(f"{name}: {len(main['edge_cases'])} edge cases pass")
        rows[name] = main
    return rows


def card_texture(torch, imops, H, W, seed, gap_rows=0):
    """[H, W] float32 in 0..255 on the card: seeded noise blurred at sigmas
    1..8 (textured_image's recipe, made on the device for atlas-sized
    canvases); with `gap_rows`, every 1024th row starts a black band of
    that many rows, as between the views of an atlas."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.zeros((H, W), device="cuda")
    for sigma in (1.0, 2.0, 4.0, 8.0):
        band = imops.gaussian_blur(torch.randn((H, W), device="cuda", generator=g), sigma)
        img += band / band.std()
    img = (img - img.min()) * (255.0 / (img.max() - img.min()))
    if gap_rows:
        rows = torch.arange(H, device="cuda")
        img[(rows % 1024) < gap_rows] = 0.0
    return img.contiguous()


def octave_extrema_cases(torch, imops, textured_image):
    """(label, resp, pyramid params, cap, sigmas) of every octave the card
    check holds octave_extrema to: the six Hessian octaves of a 640x800
    image at their caps (8192 ... 256), octave 0 of the two atlas canvases
    of the wide cells, a DoG and an iiDoG octave on a view with black
    corners (iiDoG's NaN), a Harris octave, RelativeTh with more extrema
    than the cap, and border 0 (the wrap-around of the NMS and the clamp
    of localize's reads)."""
    import dataclasses
    from mods_tpu_torch.detect import detector as det
    from mods_tpu_torch.detect import pyramid as pyr
    from mods_tpu_torch.testing import mods_detectors_config, tilted_pair
    cfg = mods_detectors_config()
    hess = cfg.hessian.pyramid

    def octaves(img, par, caps):
        first = det._first_level(img, par)
        for o, cap in enumerate(caps):
            _, resp, sigmas, first = pyr.build_octave(first, par, par.initialSigma)
            yield o, resp.contiguous(), sigmas, cap

    img = torch.from_numpy(textured_image(640, 800, 21)).cuda()
    for o, resp, sig, cap in octaves(img, hess, det.octave_cap_schedule(8192, 6)):
        yield f"hessian 640x800 octave {o}", resp, hess, cap, sig
    for H, W in ((14976, 512), (15744, 832)):
        atlas = card_texture(torch, imops, H, W, H + W, gap_rows=16)
        for _, resp, sig, cap in octaves(atlas, hess, [8192]):
            yield f"hessian atlas {H}x{W} octave 0", resp, hess, cap, sig
        del atlas
    view = torch.from_numpy(tilted_pair(640, 800, 22, 8.0, 0.3)[1]).cuda()
    dog = cfg.dog.pyramid
    iidog = dataclasses.replace(dog, iiDoGMode=True)
    for name, par in (("dog", dog), ("iidog", iidog)):
        for _, resp, sig, cap in octaves(view, par, [8192]):
            if name == "iidog":
                check(bool(torch.isnan(resp).any()), "iiDoG on black corners: no NaN")
            yield f"{name} tilted 640x800 black corners octave 0", resp, par, cap, sig
    for _, resp, sig, cap in octaves(img, cfg.harris.pyramid, [8192]):
        yield "harris 640x800 octave 0", resp, cfg.harris.pyramid, cap, sig
    rel = dataclasses.replace(hess, detector_mode="RelativeTh")
    for _, resp, sig, cap in octaves(img, rel, [256]):
        yield "hessian RelativeTh 640x800 octave 0 cap 256", resp, rel, cap, sig
    flat = dataclasses.replace(hess, detector_mode="RelativeTh", border=0)
    small = torch.from_numpy(textured_image(160, 200, 23)).cuda()
    for _, resp, sig, cap in octaves(small, flat, [32768]):
        yield "hessian RelativeTh border 0 160x200 octave 0", resp, flat, cap, sig


def max_ulps(torch, a, b):
    """Largest distance in units in the last place between two float32
    tensors whose elements pair up by sign (0 where the bits are equal)."""
    if a.numel() == 0:
        return 0
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def max_float_err(torch, a, b):
    """Largest absolute difference between two float32 tensors, 0 where
    the bits are equal (a NaN beside the same NaN), inf where one side is
    NaN or infinite and the other is not."""
    if a.numel() == 0:
        return 0.0
    same = a.view(torch.int32) == b.view(torch.int32)
    diff = (a.double() - b.double()).abs()
    diff = torch.where(torch.isnan(diff), float("inf"), diff)
    return float(torch.where(same, 0.0, diff).max())


def octave_extrema_row(torch, ox, label, resp, par, cap, sigmas):
    """octave_extrema against its plain version (find_extrema -> localize
    -> dedup_octave_map) on the card: every row, padded ones too; the
    integers and flags equal, rc and response bit for bit, scale bit for
    bit or within 2 ulp; no synchronizing call under sync debug mode.
    Times the kernels (a CUDA graph of 20 calls), the plain chain between
    events (3 calls, host work included) and the wrapper's host time."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ox.octave_extrema(resp, par, cap, sigmas)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = ox.plain_octave_extrema(resp, par, cap, sigmas)
    (gk, gr, gc, gkept, gn), (rk, rr, rcc, rkept, rn) = got, ref
    n_ext = int(gn)
    check(n_ext == rn, f"{label}: n_extrema {n_ext} vs plain {rn}")
    for what, a, b in (("level", gk.level, rk.level), ("r", gr, rr), ("c", gc, rcc),
                       ("valid", gk.valid, rk.valid), ("kept", gkept, rkept)):
        check(a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b)),
              f"{label}: {what} differs from the plain chain "
              f"({int((a != b).sum()) if a.shape == b.shape else a.shape} rows)")
    for what, a, b in (("rc", gk.rc, rk.rc), ("response", gk.response, rk.response)):
        check(bool(torch.equal(a.view(torch.int32), b.view(torch.int32))),
              f"{label}: {what} not bit-equal, max abs err "
              f"{float((a - b).abs().max())}")
    scale_ulps = max_ulps(torch, gk.scale, rk.scale)
    check(scale_ulps <= 2, f"{label}: scale {scale_ulps} ulp from the plain chain")
    err = max(max_float_err(torch, a, b) for a, b in (
        (gk.rc, rk.rc), (gk.response, rk.response), (gk.scale, rk.scale)))
    k = int(gk.level.shape[0])
    run = lambda: ox.octave_extrema(resp, par, cap, sigmas)
    ms = device_ms(run)
    plain_ms = event_ms(lambda: ox.plain_octave_extrema(resp, par, cap, sigmas), 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        run()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    bound, _ = bound_ms(nbytes(resp), 0)
    row = dict(label=label, shape=list(resp.shape), cap=cap, k=k, n_extrema=n_ext,
               accepted=int(gk.valid.sum()), kept=int(gkept.sum()),
               scale_max_ulps=scale_ulps, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               host_us=host_us, bound_ms=bound, bound_by="bytes")
    print(f"octave_extrema {label} {tuple(resp.shape)} cap {cap}: n_extrema {n_ext}, "
          f"kept {row['kept']}, scale {scale_ulps} ulp; {ms:.4f} ms on the device "
          f"(plain chain {plain_ms:.3f} ms with its host work; wrapper host "
          f"{host_us:.1f} us a call; bound {bound:.4f} ms)")
    return row


def octave_extrema_phase(torch, pk, imops, textured_image):
    """octave_extrema_row on every case of octave_extrema_cases, then the
    MODS loop on the 640x800 pair tilted by MODS_TILT, traced: every
    octave of every step through the kernels (detect.octaves.kernel ==
    detect.octaves), five launches an octave (LAUNCHES), and at most six
    device kernels under DetectTime.extrema an octave."""
    from torch.profiler import ProfilerActivity, profile
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.ops import octave_extrema as ox
    from mods_tpu_torch.testing import mods_schedule, tilted_pair
    from mods_tpu_torch.twoview import match_images
    rows = [octave_extrema_row(torch, ox, *case)
            for case in octave_extrema_cases(torch, imops, textured_image)]
    torch.cuda.empty_cache()
    cfg = Config()
    cfg.iters = mods_schedule()
    img1, img2, _ = tilted_pair(640, 800, 5, MODS_TILT, MODS_PSI)
    match_images(img1, img2, cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    pk.reset_launches()
    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r = match_images(img1, img2, cfg,
                         generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
    launches = pk.LAUNCHES["octave_extrema"]
    counts = [s["trace"]["counts"] for s in r.per_step]
    octaves = [c.get("detect.octaves", 0) for c in counts]
    kernel = [c.get("detect.octaves.kernel", 0) for c in counts]
    dev_events = [e for e in prof.events() if e.device_type == cuda]
    extents = _merged((a.time_range.start, a.time_range.end) for a in dev_events
                      if a.is_user_annotation and a.name == "DetectTime.extrema")
    starts = sorted(e.time_range.start for e in dev_events if not e.is_user_annotation)
    under = sum(bisect.bisect_left(starts, hi) - bisect.bisect_left(starts, lo)
                for lo, hi in extents)
    pair = dict(steps=r.steps_done, octaves=octaves, octaves_kernel=kernel,
                launches=launches, device_kernels_under_span=under,
                kernels_per_octave=under / max(sum(octaves), 1))
    print(f"octave_extrema in the MODS loop: {pair}")
    check(r.steps_done == 2 and all(o > 0 for o in octaves),
          f"MODS 640x800 traced: steps {r.steps_done}, octaves {octaves}")
    check(kernel == octaves, f"octaves {octaves}, through the kernels {kernel}")
    check(launches == ox.LAUNCHES_PER_CALL * sum(octaves),
          f"{launches} octave_extrema launches for {sum(octaves)} octaves")
    check(under <= 6 * sum(octaves),
          f"{under} device kernels under DetectTime.extrema, {sum(octaves)} octaves")
    return dict(rows=rows, mods_640x800=pair)


class noting_launches:
    """While entered, notes each call of the four kernel wrappers in the
    dict it yields: the key [wrapper, shape of its source tensor (stack,
    pyramid or windows), keypoints, P or None] -> the arguments of the
    first call at that key (kept only with keep=True, else None).
    `counts[key]` is the number of calls at the key."""

    NAMES = ("dma_baumberg", "dma_hat_resample", "baumberg_windows", "hat_resample")

    def __init__(self, pk, keep=False):
        self.pk, self.keep = pk, keep
        self.kept = {name: getattr(pk, name) for name in self.NAMES}
        self.counts = {}

    def shapes(self):
        """[wrapper, source shape, keypoints, P, calls] of every key."""
        return [[*k, c] for k, c in self.counts.items()]

    def __enter__(self):
        seen = {}

        def noting(name):
            def call(src, *args):
                n = args[0].shape[0]
                P = args[-1] if name.endswith("resample") else None
                key = (name, tuple(src.shape), n, P)
                if key not in seen:
                    seen[key] = (src, *args) if self.keep else None
                self.counts[key] = self.counts.get(key, 0) + 1
                return self.kept[name](src, *args)
            return call

        for name in self.NAMES:
            setattr(self.pk, name, noting(name))
        return seen

    def __exit__(self, *exc):
        for name, fn in self.kept.items():
            setattr(self.pk, name, fn)


def timed_keys(rows):
    return {tuple(tuple(x) if isinstance(x, list) else x for x in r["launch"])
            for name in rows for r in (rows[name], *rows[name]["other_shapes"])
            if "launch" in r}


def check_shapes_timed(rows, label, launched):
    """Every launch of the four kernels that a path made has a row of the
    kernel phase at its shape (source shape, keypoints, P)."""
    timed = timed_keys(rows)
    for key in launched:
        check(key in timed, f"{label} launched {key[0]} at {key[1:]}: not timed")


class captured_baumberg(baumberg_case):
    """A Baumberg launch of a path, on the arguments it was given."""

    def __init__(self, torch, pk, name, args):
        self.pk, self._plain_cpu = pk, None
        src, params = args[0], args[-5]
        self.params, self.src, self.args = params, src, args
        self.valid = params[:, 3] > 0.5
        if name == "dma_baumberg":
            _, lev, oy, ox = args[:4]
            self.run = lambda: pk.dma_baumberg(*args)
            self.plain = lambda trace=None: pk.plain_dma_baumberg(*args, trace=trace)
            self.kind = "stack"
            self.fp = Footprint(pk, src, pyr_flat(src, lev, oy, ox),
                                pk.DMA_WIN_Y, pk.DMA_WIN_X)
            self.fixed = nbytes(lev, oy, ox, params, args[5])
        else:
            self.run = lambda: pk.baumberg_windows(*args)
            self.plain = lambda trace=None: pk.plain_baumberg_windows(*args, trace=trace)
            self.kind = "wins"
            Wn = src.shape[-1]
            self.fp = Footprint(pk, src, win_flat(src), Wn, Wn)
            self.fixed = nbytes(params, args[2])


def rows_for_launches(torch, pk, rows, launched, label):
    """A row of the kernel phase, on the path's own arguments, for every
    launch key of `launched` that has none yet."""
    for key, args in launched.items():
        if key in timed_keys(rows):
            continue
        name, _, n, P = key
        print(f"{label}: timing {name} at {key[1:]} on the path's arguments")
        if name in ("dma_baumberg", "baumberg_windows"):
            row = baumberg_row(torch, pk, captured_baumberg(torch, pk, name, args),
                               name, n, args[-3])
        elif name == "dma_hat_resample":
            row = dma_resample_row(torch, pk, *args)
        else:
            row = hat_resample_row(torch, pk, *args)
        row["path"] = label
        rows[name]["other_shapes"].append(row)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], row["max_abs_err"])
        torch.cuda.empty_cache()


def timed_runs(torch, run, label, ok, runs, warm):
    """Median and all of `runs` timed calls of run() after `warm` warm-ups,
    host clock around work that ends in a synchronize; ok(result) must
    hold for every timed call."""
    for _ in range(warm):
        run()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(ok(r), f"{label}: a timed run ended otherwise")
    median = float(np.median(times))
    print(f"{label}: median {median:.1f} ms over {runs} runs "
          f"(all: {', '.join(f'{t:.1f}' for t in times)})")
    return median, times


def timed_pairs(torch, flagship, label, img1, img2, cfg, max_kp, gen):
    """Median and all of 5 timed match_pair calls after 2 warm-ups."""
    return timed_runs(torch, lambda: flagship.match_pair(img1, img2, cfg, max_kp,
                                                         generator=gen),
                      f"{label} match_pair", lambda r: int(r[1]) > 0, 5, 2)


MODS_TILT, MODS_PSI = 5.0, 0.3     # the 640x800 MODS pair's tilt and its axis


def mods_counts(r):
    """The result's counts; a traced step's spans and counters ("trace",
    which hold times) are left out."""
    per_step = [{k: v for k, v in s.items() if k != "trace"} for s in r.per_step]
    return dict(steps_done=r.steps_done, per_step=per_step, regions1=r.regions1,
                regions2=r.regions2, descriptors1=r.descriptors1,
                descriptors2=r.descriptors2, tentatives=r.tentatives,
                unique_tentatives=r.unique_tentatives, inliers=r.inliers)


def mods_phase(torch, pk, rows, gen):
    """twoview.match_images on a 640x800 pair tilted by MODS_TILT, at
    Config() defaults (max_keypoints = max_octave_cands = 8192) and the
    two-step MODS schedule: step 0 (the identity view) must stay under
    minMatches, step 1 (15 synthesized views through the atlas) reach it,
    H within 2 px at the corners.  Times 3 runs after 1 warm-up and traces
    one; every kernel shape the run launched gets a row."""
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.testing import corner_error, mods_schedule, tilted_pair
    from mods_tpu_torch.twoview import match_images
    cfg = Config()
    cfg.iters = mods_schedule()
    h, w = 640, 800
    img1, img2, H_true = tilted_pair(h, w, 5, MODS_TILT, MODS_PSI)
    pk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    noting = noting_launches(pk, keep=True)
    with noting as launched:
        r = match_images(img1, img2, cfg, generator=gen)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    err = corner_error(r.H, H_true, h, w)
    out = mods_counts(r)
    out.update(corner_error_px=err, launches=launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               timelog_s=dict(vars(r.timelog)),
               shapes_launched=noting.shapes())
    print(f"MODS 640x800 (tilt {MODS_TILT}): steps {r.steps_done}; per step "
          f"{r.per_step}; corner error {err:.3f} px; timelog "
          f"{ {k: round(v, 4) for k, v in vars(r.timelog).items()} }; launches "
          f"{launches}; peak memory {out['peak_memory_gb']:.2f} GB; shapes "
          f"launched: {out['shapes_launched']}")
    min_matches = cfg.matching.minMatches
    check(r.per_step[0]["inliers"] < min_matches,
          f"MODS 640x800: step 0 already verified {r.per_step[0]['inliers']}")
    check(r.steps_done == 2 and r.inliers >= min_matches,
          f"MODS 640x800: {r.steps_done} steps, {r.inliers} inliers")
    check(np.isfinite(r.H).all() and err <= 2.0, f"MODS 640x800: corner error {err}")
    for k in ("dma_baumberg", "dma_hat_resample", "baumberg_windows"):
        check(launches[k] > 0, f"MODS 640x800 did not launch {k}")
    rows_for_launches(torch, pk, rows, launched, "mods_640x800")
    check_shapes_timed(rows, "mods_640x800", launched)
    del launched
    torch.cuda.empty_cache()

    run = lambda: match_images(img1, img2, cfg, generator=gen)
    out["median_ms"], out["runs_ms"] = timed_runs(
        torch, run, "MODS 640x800 match_images",
        lambda rr: rr.steps_done == 2 and rr.inliers >= min_matches, 3, 1)
    prof = stage_profile(torch, run, MODS_STAGES)
    out["traced"] = prof
    out["counts"] = noting.counts
    print("MODS 640x800 traced run: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}); "
          "phases (host/device ms): {}".format(
              prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
              ", ".join(f"{k} {v['host_ms']:.1f}/{_ms(v['device_ms'])}"
                        for k, v in prof["stages"].items())))
    return launches, out


class seeded_draws:
    """RANSAC uniforms by name and shape from one numpy seed, the same for
    every caller (loransac_h's `draws`)."""

    def __init__(self, seed):
        self.seed, self.made = seed, {}

    def __call__(self, name, shape):
        import torch
        key = (name, tuple(shape))
        if key not in self.made:
            rng = np.random.default_rng([self.seed, len(self.made)])
            self.made[key] = torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
        return self.made[key]


def mods_card_vs_cpu(torch, pk, rows):
    """The MODS schedule on a 128x160 tilted pair at max_keypoints 1024,
    on the card and on the port's CPU path, both on the engine route with
    the same RANSAC uniforms: counts within PERF.md's envelope (inliers
    5%, tentatives 3%, descriptors 1%), the same number of steps.  The
    pair is narrower than the DMA window, so every octave and patch of
    its views takes baumberg_windows and hat_resample."""
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.testing import mods_schedule, tilted_pair
    from mods_tpu_torch.twoview import match_images
    cfg = Config()
    cfg.max_keypoints = cfg.max_octave_cands = 1024
    cfg.patch_source = "engine"
    cfg.iters = mods_schedule()
    img1, img2, _ = tilted_pair(128, 160, 1, 4.0, 0.3)
    draws = seeded_draws(4)
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    with noting as launched:
        rg = match_images(img1, img2, cfg, draws=draws)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    t0 = time.time()
    rc = match_images(img1, img2, cfg, draws=draws, device="cpu")
    gpu, cpu = mods_counts(rg), mods_counts(rc)
    print(f"MODS 128x160 card {gpu}; cpu {cpu} (cpu run {time.time() - t0:.1f} s); "
          f"launches {launches}; shapes launched: {noting.shapes()}")
    check(gpu["steps_done"] == cpu["steps_done"] == 2,
          f"MODS 128x160 steps: card {gpu['steps_done']}, cpu {cpu['steps_done']}")
    for name, tol in (("inliers", 0.05), ("tentatives", 0.03),
                      ("descriptors1", 0.01), ("descriptors2", 0.01)):
        check(abs(gpu[name] - cpu[name]) <= tol * max(cpu[name], 1),
              f"MODS 128x160 {name}: card {gpu[name]} vs cpu {cpu[name]}")
    for k in ("baumberg_windows", "hat_resample"):
        check(launches[k] > 0, f"MODS 128x160 did not launch {k}")
    rows_for_launches(torch, pk, rows, launched, "mods_128x160")
    check_shapes_timed(rows, "mods_128x160", launched)
    return launches, dict(card=gpu, cpu=cpu, launches=launches,
                          shapes_launched=noting.shapes(), counts=noting.counts)


class plain_forbidden:
    """While entered, a call of a plain version of the four kernels fails:
    on the card every Baumberg and every resample of a path launches its
    kernel (rows_for_launches, which holds them to their plain versions,
    runs outside)."""

    NAMES = ("plain_dma_baumberg", "plain_dma_hat_resample",
             "plain_baumberg_windows", "plain_hat_resample")

    def __init__(self, pk):
        self.pk = pk
        self.kept = {name: getattr(pk, name) for name in self.NAMES}

    def __enter__(self):
        def refuse(name):
            def call(*args, **kw):
                check(False, f"{name} reached on the card")
            return call
        for name in self.NAMES:
            setattr(self.pk, name, refuse(name))

    def __exit__(self, *exc):
        for name, fn in self.kept.items():
            setattr(self.pk, name, fn)


def detector_counts(r):
    """Regions and RootSIFT descriptors per detector and image."""
    return {det: {f"{what}{i}": sum(int(f.count()) for f in rep.get(det, desc))
                  for i, rep in ((1, r.rep1), (2, r.rep2))
                  for what, desc in (("regions", "None"), ("descriptors", "RootSIFT"))}
            for det in r.rep1.store}


def all_detectors_config(max_kp=None):
    """testing.mods_detectors_config() (DoG and Harris typed) with the
    iters_MODS-shaped schedule over every detector; max_kp, when given,
    caps keypoints and octave candidates and takes the engine route."""
    from mods_tpu_torch.testing import mods_all_detectors_schedule, mods_detectors_config
    cfg = mods_detectors_config()
    cfg.iters = mods_all_detectors_schedule()
    if max_kp is not None:
        cfg.max_keypoints = cfg.max_octave_cands = max_kp
        cfg.patch_source = "engine"
    return cfg


# MSER is affine-covariant: on the MODS pair (tilt 5) the identity view's
# MSER step already verifies (37 inliers on the CPU), and the loop would
# stop before the scale-space detectors run; at tilt 8 it verifies 8
MODS_ALL_TILT = 8.0


def mods_all_phase(torch, pk, rows, gen):
    """twoview.match_images with the iters_MODS-shaped schedule over every
    detector (step 0 MSER on the identity view; step 1 Hessian-Affine, DoG
    and Harris-Affine on 15 synthesized views each, one atlas a detector
    and side) on the 640x800 pair of the MODS phase tilted by MODS_ALL_TILT,
    Config() (8192 keypoints): step 0 under minMatches, the final step at
    least, H within 2 px at the corners, every detector > 0 regions on both
    images, and no plain kernel version reached.  Times 3 runs after 1
    warm-up and traces one; every kernel shape the run launched gets a
    row."""
    from mods_tpu_torch.testing import corner_error, tilted_pair
    from mods_tpu_torch.twoview import match_images
    cfg = all_detectors_config()
    h, w = 640, 800
    img1, img2, H_true = tilted_pair(h, w, 5, MODS_ALL_TILT, MODS_PSI)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    with noting as launched, plain_forbidden(pk):
        r = match_images(img1, img2, cfg, generator=gen)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    err = corner_error(r.H, H_true, h, w)
    out = mods_counts(r)
    out.update(per_detector=detector_counts(r), corner_error_px=err,
               launches=launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               timelog_s=dict(vars(r.timelog)), shapes_launched=noting.shapes())
    print(f"MODS all detectors 640x800 (tilt {MODS_ALL_TILT}): steps {r.steps_done}; "
          f"per step {r.per_step}; per detector {out['per_detector']}; corner "
          f"error {err:.3f} px; timelog "
          f"{ {k: round(v, 4) for k, v in vars(r.timelog).items()} }; launches "
          f"{launches}; peak memory {out['peak_memory_gb']:.2f} GB; shapes "
          f"launched: {out['shapes_launched']}")
    min_matches = cfg.matching.minMatches
    check(r.per_step[0]["inliers"] < min_matches,
          f"MODS all 640x800: step 0 (MSER) already verified {r.per_step[0]['inliers']}")
    check(r.steps_done == 2 and r.inliers >= min_matches,
          f"MODS all 640x800: {r.steps_done} steps, {r.inliers} inliers")
    check(np.isfinite(r.H).all() and err <= 2.0, f"MODS all 640x800: corner error {err}")
    check(sorted(out["per_detector"]) == ["DoG", "HarrisAffine", "HessianAffine", "MSER"],
          f"MODS all 640x800: detectors {sorted(out['per_detector'])}")
    for det, c in out["per_detector"].items():
        check(c["regions1"] > 0 and c["regions2"] > 0, f"MODS all 640x800: {det} {c}")
    for k in ("dma_baumberg", "dma_hat_resample", "baumberg_windows"):
        check(launches[k] > 0, f"MODS all 640x800 did not launch {k}")
    rows_for_launches(torch, pk, rows, launched, "mods_all_640x800")
    check_shapes_timed(rows, "mods_all_640x800", launched)
    del launched
    torch.cuda.empty_cache()

    def run():
        with plain_forbidden(pk):
            return match_images(img1, img2, cfg, generator=gen)
    out["median_ms"], out["runs_ms"] = timed_runs(
        torch, run, "MODS all 640x800 match_images",
        lambda rr: rr.steps_done == 2 and rr.inliers >= min_matches, 3, 1)
    prof = stage_profile(torch, run, MODS_STAGES, table=False)
    out["traced"] = prof
    out["counts"] = noting.counts
    print("MODS all 640x800 traced run: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}); "
          "phases (host/device ms): {}".format(
              prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
              ", ".join(f"{k} {v['host_ms']:.1f}/{_ms(v['device_ms'])}"
                        for k, v in prof["stages"].items())))
    return launches, out


def mods_all_card_vs_cpu(torch, pk, rows):
    """The every-detector schedule on a 128x160 pair tilted by 3 at
    max_keypoints 1024, on the card and on the port's CPU path, both on the
    engine route with the same RANSAC uniforms: steps equal, counts within
    PERF.md's envelope (inliers 5 %, tentatives 3 %, descriptors 1 %), and
    each detector's regions and descriptors within 1 % (at least 1)."""
    from mods_tpu_torch.testing import tilted_pair
    from mods_tpu_torch.twoview import match_images
    cfg = all_detectors_config(1024)
    img1, img2, _ = tilted_pair(128, 160, 4, 3.0, 0.3)
    draws = seeded_draws(5)
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    with noting as launched, plain_forbidden(pk):
        rg = match_images(img1, img2, cfg, draws=draws)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    t0 = time.time()
    rc = match_images(img1, img2, cfg, draws=draws, device="cpu")
    gpu, cpu = mods_counts(rg), mods_counts(rc)
    gpu["per_detector"], cpu["per_detector"] = detector_counts(rg), detector_counts(rc)
    print(f"MODS all 128x160 card {gpu}; cpu {cpu} (cpu run {time.time() - t0:.1f} s); "
          f"launches {launches}; shapes launched: {noting.shapes()}")
    check(gpu["steps_done"] == cpu["steps_done"] == 2,
          f"MODS all 128x160 steps: card {gpu['steps_done']}, cpu {cpu['steps_done']}")
    for name, tol in (("inliers", 0.05), ("tentatives", 0.03),
                      ("descriptors1", 0.01), ("descriptors2", 0.01)):
        check(abs(gpu[name] - cpu[name]) <= tol * max(cpu[name], 1),
              f"MODS all 128x160 {name}: card {gpu[name]} vs cpu {cpu[name]}")
    check(sorted(gpu["per_detector"]) == sorted(cpu["per_detector"]),
          "MODS all 128x160: detectors differ")
    for det, c in cpu["per_detector"].items():
        for k, v in c.items():
            g = gpu["per_detector"][det][k]
            check(v > 0 and abs(g - v) <= max(1, 0.01 * v),
                  f"MODS all 128x160 {det} {k}: card {g} vs cpu {v}")
    for k in ("baumberg_windows", "hat_resample"):
        check(launches[k] > 0, f"MODS all 128x160 did not launch {k}")
    rows_for_launches(torch, pk, rows, launched, "mods_all_128x160")
    check_shapes_timed(rows, "mods_all_128x160", launched)
    return launches, dict(card=gpu, cpu=cpu, launches=launches,
                          shapes_launched=noting.shapes(), counts=noting.counts)


def traced_span(torch, name, fn):
    """One traced call of fn under a span `name`: (its result, the span's
    host ms, the device ms of the work under it, the wall ms, the
    operators with the most host time)."""
    box = []

    def run():
        with torch.profiler.record_function(name):
            box.append(fn())
    prof = stage_profile(torch, run, (name,), table=False)
    span = prof["stages"][name]
    return box[0], span["host_ms"], span["device_ms"], prof["wall_ms"], prof["top_host_ops"]


def verifiers_card_vs_cpu(torch):
    """loransac_f (DEGENSAC) and orsa_filter on the committed graf
    tentatives (tests/data/fpath_graf_{fwd,rev}.npz, 65 and 78 valid of
    128) at RANSACPars() defaults, on the card and on the port's CPU path
    with the same uniforms (`seeded_draws`): inliers within PERF.md's
    envelope (5 %, at least 1), ORSA's decision (inliers kept or none)
    equal.  No kernel runs here.  Each verifier runs once warm on the
    card, then once traced (host ms of its span, device ms of the work
    under it, wall ms); the CPU call is timed on the host clock."""
    from mods_tpu_torch.config import RANSACPars
    from mods_tpu_torch.types import Tentatives
    from mods_tpu_torch.verify.fundamental import loransac_f
    from mods_tpu_torch.verify.orsa import orsa_filter
    fields = ("xy1", "xy2", "A1", "A2", "s1", "s2", "d1", "d2", "ratio", "valid")
    pars = RANSACPars()
    verifiers = (("loransac_f", lambda t, dr: loransac_f(t, pars, draws=dr)),
                 ("orsa_filter", lambda t, dr: orsa_filter(t, pars, 800, 640, draws=dr)))
    out = {}
    for name in ("fwd", "rev"):
        d = np.load(os.path.join(HERE, "tests", "data", f"fpath_graf_{name}.npz"))
        z = np.zeros_like(d["s1"])
        t = Tentatives(*[torch.from_numpy(np.array(d[k] if k in d else z))
                         for k in fields])
        tc = t.to("cuda")
        for verifier, run in verifiers:
            draws = seeded_draws(7)
            run(tc, draws)
            r, host_ms, device_ms, wall_ms, host_ops = traced_span(
                torch, verifier, lambda: run(tc, draws))
            t0 = time.perf_counter()
            rc = run(t, draws)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            gpu, cpu = int(r.n_inliers), int(rc.n_inliers)
            label = f"{verifier} graf_{name}"
            out[f"{verifier}_graf_{name}"] = dict(
                card=gpu, cpu=cpu, host_ms=host_ms, device_ms=device_ms,
                wall_ms=wall_ms, cpu_ms=cpu_ms, top_host_ops=host_ops)
            print(f"{label}: inliers card {gpu}, cpu {cpu}; card host "
                  f"{host_ms:.1f} ms, device {_ms(device_ms)} ms (wall "
                  f"{wall_ms:.1f}); cpu {cpu_ms:.1f} ms")
            check(abs(gpu - cpu) <= max(1, 0.05 * cpu), f"{label}: card {gpu} vs cpu {cpu}")
            if verifier == "orsa_filter":
                check((gpu > 0) == (cpu > 0), f"{label}: decisions differ")
    return out


def mods_f_phase(torch, pk, rows, gen):
    """twoview.match_images with ver_type LORANSACF, then ORSA, on a 640x800
    two_plane_pair (two planes at depths 4 and 8 seen by two cameras, a
    known F) at Config() defaults and the MODS schedule.  Each run: final
    inliers >= minMatches, at least 8 true matches of each plane among
    them (an H would verify one plane), the pair's true correspondences
    within 2 px of the returned F's epipolar lines (median,
    `epipolar_error`), and dma_baumberg, dma_hat_resample and
    baumberg_windows launched; every kernel shape launched gets a row.
    Times 3 runs after 1 warm-up of each and traces one of each (per
    TimeLog phase; RANSACTime holds the verifier)."""
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.testing import epipolar_error, mods_schedule, two_plane_pair
    from mods_tpu_torch.twoview import match_images
    cfg = Config()
    cfg.iters = mods_schedule()
    min_matches = cfg.matching.minMatches
    h, w = 640, 800
    img1, img2, _, grid = two_plane_pair(h, w, 5)
    launches, counts, out = {}, {}, {}
    for vt in ("LORANSACF", "ORSA"):
        label = f"mods_f_640x800_{vt}"
        run = lambda: match_images(img1, img2, cfg, ver_type=vt, generator=gen)
        pk.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        noting = noting_launches(pk, keep=True)
        with noting as launched:
            r = run()
        torch.cuda.synchronize()
        launches[label] = dict(pk.LAUNCHES)
        tt = r.final.tentatives
        keep = tt.valid.cpu().numpy()
        on = grid.plane_of(tt.xy1.cpu().numpy()[keep], tt.xy2.cpu().numpy()[keep])
        per_plane = [int((on == i).sum()) for i in (0, 1)]
        err = epipolar_error(r.H, grid.xy1, grid.xy2)
        res = mods_counts(r)
        res.update(per_plane_inliers=per_plane, off_both_planes=int((on < 0).sum()),
                   epipolar_error_px=err, launches=launches[label],
                   peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                   timelog_s=dict(vars(r.timelog)), shapes_launched=noting.shapes())
        print(f"MODS-F 640x800 {vt}: steps {r.steps_done}; per step {r.per_step}; "
              f"inliers per plane {per_plane} ({res['off_both_planes']} on neither); "
              f"epipolar error {err:.4f} px; timelog "
              f"{ {k: round(v, 4) for k, v in vars(r.timelog).items()} }; launches "
              f"{launches[label]}; peak memory {res['peak_memory_gb']:.2f} GB")
        check(r.inliers >= min_matches, f"{label}: {r.inliers} inliers")
        check(min(per_plane) >= 8, f"{label}: inliers per plane {per_plane}")
        check(np.isfinite(r.H).all() and err <= 2.0, f"{label}: epipolar error {err}")
        for k in ("dma_baumberg", "dma_hat_resample", "baumberg_windows"):
            check(launches[label][k] > 0, f"{label} did not launch {k}")
        rows_for_launches(torch, pk, rows, launched, label)
        check_shapes_timed(rows, label, launched)
        del launched
        counts[label] = noting.counts
        torch.cuda.empty_cache()

        res["median_ms"], res["runs_ms"] = timed_runs(
            torch, run, f"MODS-F 640x800 {vt} match_images",
            lambda rr: rr.inliers >= min_matches, 3, 1)
        prof = stage_profile(torch, run, MODS_STAGES, table=(vt == "LORANSACF"))
        ran = prof["stages"].get("RANSACTime", {})
        res.update(traced=prof, ransac_share_of_wall=ran.get("host_ms", 0) / prof["wall_ms"])
        print("MODS-F 640x800 {} traced: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}); "
              "phases (host/device ms): {}; most host time: {}".format(
                  vt, prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
                  ", ".join(f"{k} {v['host_ms']:.1f}/{_ms(v['device_ms'])}"
                            for k, v in prof["stages"].items()),
                  ", ".join(f"{o['name']} {o['self_host_ms']:.1f}" for o in prof["top_host_ops"])))
        out[vt] = res
    return launches, counts, out


# --------------------------------------------------------------------------- #
# the CNN stages (desc/cnn.py) and the deep flagship (models/deep.py)
# --------------------------------------------------------------------------- #
CNN_N = 8192          # patches a net takes in one call (cnn.CHUNK)
# the deep flagship's spans
DEEP_STAGES = ("detect", "mip_pyramid", "affnet", "orinet", "describe", "match",
               "duplicate_filter", "ransac")


def conv_macs(net, P=32):
    """Multiply-adds a patch of the net's convolutions, from its spec and
    weight shapes."""
    macs, side = 0, P
    for idx, kind, stride, pad, _ in net.spec:
        if kind != "conv":
            continue
        co, ci, k, _ = net._p(idx, "weight").shape
        side = (side + 2 * pad - k) // stride + 1
        macs += co * ci * k * k * side * side
    return macs


def cnn_patches_seeded(torch, textured_image, n, seed):
    """n 32x32 patches of 0..255 integers: random crops of a textured
    image."""
    img = textured_image(512, 512, seed)
    rng = np.random.default_rng(seed)
    oy, ox = rng.integers(0, 512 - 32, n), rng.integers(0, 512 - 32, n)
    r = np.arange(32)
    p = img[oy[:, None, None] + r[None, :, None], ox[:, None, None] + r[None, None, :]]
    return torch.from_numpy(np.round(p).astype(np.float32))


def cnn_forwards(torch, cnn, cfg, textured_image):
    """HardNet (its weights as cfg names them), AffNet and OriNet (random
    weights under the opt-in where their files are absent) on CNN_N seeded
    32x32 patches, on the card and on the CPU: the max abs error (HardNet
    on the 0..255 scale, AffNet's a11 a21 a22, OriNet's angle in rad), the
    card's ms per call (mean of 5 between CUDA events after a warm call;
    TF32 off), the CPU's ms, the FLOP bound at 67 TFLOP/s and the weights
    each net used."""
    p_cpu = cnn_patches_seeded(torch, textured_image, CNN_N, 21)
    p = p_cpu.to("cuda")
    out = {}
    for which in ("hardnet", "affnet", "orinet"):
        net = cnn.get_net(cfg, which, "cuda")
        net_cpu = cnn.get_net(cfg, which, "cpu")
        got = net(p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = net_cpu(p_cpu)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = got.cpu()
        if which == "orinet":
            da = torch.atan2(got[:, 0], got[:, 1]) - torch.atan2(ref[:, 0], ref[:, 1])
            err = float(torch.remainder(da + np.pi, 2 * np.pi).sub(np.pi).abs().max())
        else:
            err = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all()), f"{which}: not finite on the card")
        check(err <= {"hardnet": 1e-2, "affnet": 1e-4, "orinet": 1e-3}[which],
              f"{which}: card against CPU max abs err {err}")
        ms = event_ms(lambda: net(p), 5)
        macs = conv_macs(net)
        weights = sum(b.numel() * b.element_size() for b in net.buffers())
        b, by = bound_ms(nbytes(p) + weights + CNN_N * net.out_dim * 4,
                         2.0 * macs * CNN_N)
        out[which] = dict(weights=net.source, patches=CNN_N, ms=ms, cpu_ms=cpu_ms,
                          bound_ms=b, bound_by=by, macs_per_patch=macs,
                          tflops=2.0 * macs * CNN_N / ms / 1e9, max_abs_err=err,
                          library=f"cuDNN {torch.backends.cudnn.version()}")
        print(f"{which} ({net.source}): {ms:.3f} ms per {CNN_N} patches on the card "
              f"({out[which]['tflops']:.1f} TFLOP/s; bound {b:.3f} ms by {by}, "
              f"{macs} multiply-adds a patch), CPU {cpu_ms:.0f} ms, card against "
              f"CPU max abs err {err:.2e}")
    return out


def hardnet_phase(torch, pk, rows, gen):
    """twoview.match_images on a 640x800 warp pair at Config() with the
    classic detector (Baumberg, gradient orientation) describing with
    HardNet (its committed weights) in one identity step: at least 15
    inliers, H within 2 px at the corners; B2 launches at P 32 and every
    shape launched gets a row.  Times 3 runs after 1 warm-up and traces
    one (per TimeLog phase).  Then, reported with no threshold, the
    two-step HardNet schedule on the 640x800 pair tilted by MODS_TILT at
    max_keypoints 2048 (16 views of 8 orientations each go to the float
    kNN); its views are extracted one by one (no atlas for HardNet), each
    at its own size, so most of its launch shapes get rows of their own."""
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.testing import corner_error, mods_schedule, tilted_pair, warp_pair
    from mods_tpu_torch.twoview import match_images
    cfg = Config()
    cfg.iters = mods_schedule("HardNet")[:1]
    h, w = 640, 800
    img1, img2, H_true = warp_pair(h, w, 6)
    pk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    noting = noting_launches(pk, keep=True)
    with noting as launched:
        r = match_images(img1, img2, cfg, generator=gen)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    err = corner_error(r.H, H_true, h, w)
    out = mods_counts(r)
    out.update(corner_error_px=err, launches=launches,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               timelog_s=dict(vars(r.timelog)), shapes_launched=noting.shapes())
    print(f"HardNet 640x800: per step {r.per_step}; corner error {err:.3f} px; "
          f"launches {launches}; peak memory {out['peak_memory_gb']:.2f} GB; "
          f"shapes launched: {out['shapes_launched']}")
    check(r.inliers >= cfg.matching.minMatches, f"HardNet 640x800: {r.inliers} inliers")
    check(np.isfinite(r.H).all() and err <= 2.0, f"HardNet 640x800: corner error {err}")
    check(any(k[0] == "dma_hat_resample" and k[3] == 32 for k in launched),
          "HardNet 640x800 did not launch dma_hat_resample at P 32")
    rows_for_launches(torch, pk, rows, launched, "hardnet_640x800")
    check_shapes_timed(rows, "hardnet_640x800", launched)
    del launched
    torch.cuda.empty_cache()
    run = lambda: match_images(img1, img2, cfg, generator=gen)
    out["median_ms"], out["runs_ms"] = timed_runs(
        torch, run, "HardNet 640x800 match_images",
        lambda rr: rr.inliers >= cfg.matching.minMatches, 3, 1)
    prof = stage_profile(torch, run, MODS_STAGES, table=False)
    out["traced"] = prof
    print("HardNet 640x800 traced: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}); "
          "phases (host/device ms): {}".format(
              prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
              ", ".join(f"{k} {v['host_ms']:.1f}/{_ms(v['device_ms'])}"
                        for k, v in prof["stages"].items())))
    counts = {"hardnet_640x800": noting.counts}

    cfg_t = Config()
    cfg_t.max_keypoints = cfg_t.max_octave_cands = 2048
    cfg_t.iters = mods_schedule("HardNet")
    img1, img2, H_true = tilted_pair(h, w, 5, MODS_TILT, MODS_PSI)
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with noting as launched:
        rt = match_images(img1, img2, cfg_t, generator=gen)
    torch.cuda.synchronize()
    tilted = mods_counts(rt)
    tilted.update(wall_ms=(time.perf_counter() - t0) * 1e3, max_keypoints=2048,
                  corner_error_px=corner_error(rt.H, H_true, h, w),
                  launches=dict(pk.LAUNCHES), shapes_launched=noting.shapes(),
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                  timelog_s=dict(vars(rt.timelog)))
    print(f"HardNet MODS 640x800 (tilt {MODS_TILT}, 2048 keypoints): steps "
          f"{rt.steps_done}; per step {rt.per_step}; corner error "
          f"{tilted['corner_error_px']:.3f} px; wall {tilted['wall_ms']:.0f} ms; "
          f"peak {tilted['peak_memory_gb']:.2f} GB")
    rows_for_launches(torch, pk, rows, launched, "hardnet_mods_640x800")
    check_shapes_timed(rows, "hardnet_mods_640x800", launched)
    del launched
    out["mods_tilted"] = tilted
    counts["hardnet_mods_640x800"] = noting.counts
    torch.cuda.empty_cache()
    return {"hardnet_640x800": launches,
            "hardnet_mods_640x800": tilted["launches"]}, counts, out


def deep_phase(torch, pk, rows, gen):
    """models/deep.match_pair_deep on a 640x800 warp pair with
    testing.deep_config() at Config().max_keypoints (8192): HardNet with
    its committed weights, AffNet and OriNet random (the opt-in).  Baumberg
    is off, so only the resample kernels launch: B2 at P 32 three times a
    view.  Reports the counts (no quality threshold at random AffNet and
    OriNet weights); times 5 pairs after 2 warm-ups and traces one (per
    span host and device ms, busy share); peak memory."""
    from mods_tpu_torch.desc import cnn
    from mods_tpu_torch.models import deep
    from mods_tpu_torch.testing import corner_error, deep_config, warp_pair
    cfg = deep_config()
    max_kp = cfg.max_keypoints
    nets = cnn.nets3(cfg, "cuda")
    h, w = 640, 800
    img1, img2, H_true = warp_pair(h, w, 1)
    pk.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    noting = noting_launches(pk, keep=True)
    with noting as launched:
        H, ninl, ntent, n1, n2 = deep.match_pair_deep(img1, img2, cfg, max_kp, nets,
                                                      generator=gen)
    torch.cuda.synchronize()
    launches = dict(pk.LAUNCHES)
    out = dict(n1=int(n1), n2=int(n2), tentatives=int(ntent), inliers=int(ninl),
               corner_error_px=corner_error(H.cpu().numpy(), H_true, h, w),
               max_kp=max_kp, weights={k: n.source for k, n in
                                       zip(("affnet", "orinet", "hardnet"), nets)},
               launches=launches, shapes_launched=noting.shapes(),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"deep 640x800: n1 {out['n1']} n2 {out['n2']} tentatives "
          f"{out['tentatives']} inliers {out['inliers']}, corner error "
          f"{out['corner_error_px']:.3f} px; weights {out['weights']}; launches "
          f"{launches}; peak memory {out['peak_memory_gb']:.2f} GB; shapes "
          f"launched: {out['shapes_launched']}")
    check(bool(torch.isfinite(H).all()) and out["n1"] > 0 and out["n2"] > 0,
          f"deep 640x800: {out}")
    check(launches["dma_hat_resample"] == 6,
          f"deep 640x800: dma_hat_resample launched {launches['dma_hat_resample']} "
          "times, not 3 a view")
    for k in ("dma_baumberg", "baumberg_windows", "hat_resample"):
        check(launches[k] == 0, f"deep 640x800 launched {k}")
    rows_for_launches(torch, pk, rows, launched, "deep_640x800")
    check_shapes_timed(rows, "deep_640x800", launched)
    del launched
    torch.cuda.empty_cache()
    run = lambda: deep.match_pair_deep(img1, img2, cfg, max_kp, nets, generator=gen)
    out["median_ms"], out["runs_ms"] = timed_runs(
        torch, run, "deep 640x800 match_pair_deep", lambda r: int(r[4]) > 0, 5, 2)
    torch.cuda.reset_peak_memory_stats()
    prof = stage_profile(torch, run, DEEP_STAGES, table=False)
    out["traced"] = prof
    out["traced_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("deep 640x800 traced: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}); "
          "stages (host/device ms): {}".format(
              prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
              ", ".join(f"{k} {v['host_ms']:.1f}/{_ms(v['device_ms'])}"
                        for k, v in prof["stages"].items())))
    return launches, noting.counts, out


def cnn_card_vs_cpu(torch, pk, rows):
    """Two small runs on the card and on the port's CPU path with the same
    RANSAC uniforms, counts within PERF.md's envelope (inliers 5 %,
    tentatives 3 %, n1 and n2 1 %): deep.match_pair_deep on a 256x320
    warp pair with deep_config() at 1024 keypoints (B2 at P 32), and
    match_images with HardNet in one identity step on a 128x160 warp pair
    at 1024 keypoints on the engine route (narrower than the DMA window:
    B4 at P 32, where it stages its windows)."""
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.desc import cnn
    from mods_tpu_torch.models import deep
    from mods_tpu_torch.testing import deep_config, mods_schedule, warp_pair
    from mods_tpu_torch.twoview import match_images
    out, launches, counts = {}, {}, {}

    def within(label, gpu, cpu):
        for name, tol in (("inliers", 0.05), ("tentatives", 0.03), ("n1", 0.01),
                          ("n2", 0.01)):
            check(abs(gpu[name] - cpu[name]) <= tol * max(cpu[name], 1),
                  f"{label} {name}: card {gpu[name]} vs cpu {cpu[name]}")

    cfg = deep_config()
    cfg.max_keypoints = cfg.max_octave_cands = 1024
    img1, img2, _ = warp_pair(256, 320, 3)
    rng = np.random.default_rng(1)
    (sb, sm), (lb, lm) = deep.ransac_draw_shapes(cfg, 1024)
    draws = {"u_sweep": torch.from_numpy(rng.uniform(size=(sb, sm)).astype(np.float32)),
             "u_lo": torch.from_numpy(rng.uniform(size=(lb, lm)).astype(np.float32))}
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    with noting as launched:
        g = deep.match_pair_deep(img1, img2, cfg, 1024, draws=draws)
    torch.cuda.synchronize()
    launches["deep_256x320"] = dict(pk.LAUNCHES)
    counts["deep_256x320"] = noting.counts
    t0 = time.time()
    c = deep.match_pair_deep(img1, img2, cfg, 1024, draws=draws, device="cpu")
    keys = ("inliers", "tentatives", "n1", "n2")
    gpu = dict(zip(keys, (int(x) for x in g[1:])))
    cpu = dict(zip(keys, (int(x) for x in c[1:])))
    print(f"deep 256x320 card {gpu}, cpu {cpu} (cpu run {time.time() - t0:.1f} s); "
          f"launches {launches['deep_256x320']}")
    within("deep 256x320", gpu, cpu)
    check(launches["deep_256x320"]["dma_hat_resample"] == 6,
          "deep 256x320: dma_hat_resample not 3 a view")
    rows_for_launches(torch, pk, rows, launched, "deep_256x320")
    check_shapes_timed(rows, "deep_256x320", launched)
    out["deep_256x320"] = dict(card=gpu, cpu=cpu)

    cfg = Config()
    cfg.max_keypoints = cfg.max_octave_cands = 1024
    cfg.patch_source = "engine"
    cfg.iters = mods_schedule("HardNet")[:1]
    img1, img2, _ = warp_pair(128, 160, 3)
    draws = seeded_draws(5)
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    with noting as launched:
        rg = match_images(img1, img2, cfg, draws=draws)
    torch.cuda.synchronize()
    launches["hardnet_128x160"] = dict(pk.LAUNCHES)
    counts["hardnet_128x160"] = noting.counts
    t0 = time.time()
    rc = match_images(img1, img2, cfg, draws=draws, device="cpu")
    gpu, cpu = ({"inliers": r.inliers, "tentatives": r.tentatives,
                 "n1": r.descriptors1, "n2": r.descriptors2} for r in (rg, rc))
    print(f"HardNet 128x160 card {gpu}, cpu {cpu} (cpu run {time.time() - t0:.1f} s); "
          f"launches {launches['hardnet_128x160']}; shapes launched: {noting.shapes()}")
    within("HardNet 128x160", gpu, cpu)
    check(any(k[0] == "hat_resample" and k[3] == 32 for k in launched),
          "HardNet 128x160 did not launch hat_resample at P 32")
    rows_for_launches(torch, pk, rows, launched, "hardnet_128x160")
    check_shapes_timed(rows, "hardnet_128x160", launched)
    out["hardnet_128x160"] = dict(card=gpu, cpu=cpu)
    return launches, counts, out


# ---- the entry points users run (the CLI apps, the ZMQ daemons, the
#      multi-process path, the external-command escape hatch) ---- #
def _png(cv2, path, img):
    check(cv2.imwrite(path, np.clip(np.round(img), 0, 255).astype(np.uint8)),
          f"could not write {path}")
    return path


def cli_phase(torch, pk, rows, tmp, bare_ms):
    """The port's command-line apps on the card, on image files in `tmp`:
    `mods` on the MODS pair (tilted_pair(640, 800, 5, MODS_TILT,
    MODS_PSI)) with Config() (8192 keypoints) and the two-step MODS
    schedule from an iters INI (testing.iters_ini(mods_schedule())).  Its
    `.h` holds r.H (as %g writes it: 6 significant digits), within 2 px
    at the corners; the matchings file holds r.inliers rows (the final
    inliers, as the JAX CLI writes it); k1 / k2 load back to r.regions1 /
    r.regions2 regions; the log parses.  run_mods on the command's own
    images with seeded draws gives the counts of a match_images call with
    the same draws.  The command's median of 3 (its counted run above is
    the warm-up) beside `bare_ms`, mods_phase's match_images median on
    the same pair (there in float, here read back from 8-bit PNG files)
    and configuration: the difference is the command's I/O
    cost per pair.  Then `extract` of one image and
    `extract_batch --shard 0/2` and `--shard 1/2` over two: shard 0
    writes its image's features, shard 1 finds its output there (from
    `extract`) and skips it."""
    import cv2
    from mods_tpu_torch import cli
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.io import keys
    from mods_tpu_torch.testing import corner_error, iters_ini, mods_schedule, tilted_pair
    from mods_tpu_torch.twoview import match_images
    h, w = 640, 800
    a, b, H_true = tilted_pair(h, w, 5, MODS_TILT, MODS_PSI)
    png1 = _png(cv2, os.path.join(tmp, "img1.png"), a)
    png2 = _png(cv2, os.path.join(tmp, "img2.png"), b)
    iters = os.path.join(tmp, "iters_MODS.ini")
    with open(iters, "w") as fh:
        fh.write(iters_ini(mods_schedule()))
    cfg = cli.load_cli_config(None, iters)
    want = Config()
    want.iters = mods_schedule()
    want.matching.maxSteps = 2
    check(cfg == want, "cli: the iters INI does not give Config() and mods_schedule()")
    outs = [os.path.join(tmp, n) for n in ("out1.png", "out2.png", "k1.txt", "k2.txt",
                                           "matchings.txt", "log.txt")]
    argv = ["mods", png1, png2, *outs, "LORANSAC", "", "", iters]
    seen = []
    run_mods = cli.run_mods

    def keeping(*args, **kw):
        seen.append(run_mods(*args, **kw))
        return seen[-1]

    cli.run_mods = keeping
    try:
        pk.reset_launches()
        noting = noting_launches(pk, keep=True)
        with noting as launched:
            check(cli.main(argv) == 0, "cli mods: exit code")
        torch.cuda.synchronize()
        launches = {"cli_mods_640x800": dict(pk.LAUNCHES)}
        counts = {"cli_mods_640x800": noting.counts}
        r = seen[-1]
        out = dict(command=mods_counts(r), launches=launches["cli_mods_640x800"],
                   shapes_launched=noting.shapes())
        H_file = keys.read_h(outs[5] + ".h")
        err = corner_error(H_file, H_true, h, w)
        with open(outs[4]) as fh:
            rows_m = fh.read().splitlines()
        with open(outs[5]) as fh:
            log_line, record = fh.read().splitlines()
        record = json.loads(record)
        regions = [sum(int(m["None"].count()) for m in
                       keys.load_regions_native(p, device="cuda").values())
                   for p in outs[2:4]]
        out.update(corner_error_px=err, h_file_max_rel_err=float(
            np.max(np.abs(H_file - r.H) / np.maximum(np.abs(r.H), 1e-12))),
                   matchings_rows=len(rows_m) - 1, k_regions=regions)
        print(f"cli mods 640x800: {out['command']}; corner error {err:.3f} px; "
              f"matchings rows {out['matchings_rows']}; k1/k2 regions {regions}; "
              f"launches {launches['cli_mods_640x800']}; shapes launched: "
              f"{out['shapes_launched']}")
        check(r.steps_done == 2 and r.inliers >= cfg.matching.minMatches,
              f"cli mods: {r.steps_done} steps, {r.inliers} inliers")
        check(np.allclose(H_file, r.H, rtol=5e-6, atol=0), "cli mods: .h is not r.H")
        check(err <= 2.0, f"cli mods: corner error {err}")
        check(int(rows_m[0]) == r.inliers == len(rows_m) - 1,
              f"cli mods: {len(rows_m) - 1} matchings rows for {r.inliers} inliers")
        check(regions == [r.regions1, r.regions2],
              f"cli mods: k1/k2 hold {regions} regions, r {r.regions1} {r.regions2}")
        check(record["inliers"] == r.inliers and record["steps"] == r.steps_done
              and int(log_line.split()[1]) == r.inliers, "cli mods: the log")
        for p, shape in ((outs[0], (h, 2 * w + 8, 3)), (outs[1], (h, w, 3))):
            im = cv2.imread(p)
            check(im is not None and im.shape == shape, f"cli mods: {p}")
        for k in ("dma_baumberg", "dma_hat_resample", "baumberg_windows"):
            check(launches["cli_mods_640x800"][k] > 0, f"cli mods did not launch {k}")
        rows_for_launches(torch, pk, rows, launched, "cli_mods_640x800")
        check_shapes_timed(rows, "cli_mods_640x800", launched)
        del launched

        # run_mods on the command's images, against match_images, same draws
        img1, img2 = cli.load_gray(png1), cli.load_gray(png2)
        draws = seeded_draws(6)
        r_run = cli.run_mods(img1, img2, cfg, cli.ModsOutputs(*(
            os.path.join(tmp, "run_" + n) for n in ("k1.txt", "k2.txt", "m.txt",
                                                    "log.txt"))), draws=draws)
        r_bare = match_images(img1, img2, cfg, draws=draws)
        out["run_mods"], out["match_images"] = mods_counts(r_run), mods_counts(r_bare)
        print(f"cli run_mods {out['run_mods']}; match_images {out['match_images']}")
        check(out["run_mods"] == out["match_images"],
              "cli: run_mods and match_images disagree with the same draws")
        # the command's I/O cost: the command beside the bare loop
        ok = lambda rr: rr.inliers >= cfg.matching.minMatches
        out["command_median_ms"], out["command_runs_ms"] = timed_runs(
            torch, lambda: (cli.main(argv), seen[-1])[1], "cli mods command", ok, 3, 0)
    finally:
        cli.run_mods = run_mods
    out["bare_median_ms"] = bare_ms
    out["io_ms"] = out["command_median_ms"] - bare_ms
    # where the I/O cost goes: each part of the command once, on r (the
    # k1 / k2 key files are part of write_outputs, timed inside it)
    part_ms = {"write_k1_k2": 0.0}
    save_regions = keys.save_regions_native

    def part(name, fn):
        t0 = time.perf_counter()
        fn()
        part_ms[name] = (time.perf_counter() - t0) * 1e3

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        save_regions(*args, **kw)
        part_ms["write_k1_k2"] += (time.perf_counter() - t0) * 1e3

    from mods_tpu_torch.io.draw import draw_matches
    part("read_images", lambda: (cli.load_gray(png1), cli.load_gray(png2)))
    keys.save_regions_native = timed_save
    try:
        part("write_outputs", lambda: cli.write_mods_outputs(
            r, cli.ModsOutputs(*outs[2:]), "LORANSAC", 1.0))
    finally:
        keys.save_regions_native = save_regions
    part("draw", lambda: cv2.imwrite(outs[0], draw_matches(
        img1, img2, r.final.tentatives, H=r.H)))
    out["io_parts_ms"] = part_ms
    print(f"cli mods I/O cost: {out['io_ms']:.1f} ms a pair (command "
          f"{out['command_median_ms']:.1f}, bare {out['bare_median_ms']:.1f}); "
          f"parts (ms, once each): {part_ms}")

    # extract and extract_batch with shards and skip-if-exists
    lists = [os.path.join(tmp, n) for n in ("in.txt", "out.txt")]
    npz = [os.path.join(tmp, f"feat{i}.npz") for i in range(2)]
    for path, items in zip(lists, ((png1, png2), npz)):
        with open(path, "w") as fh:
            fh.write("\n".join(items))
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    with noting as launched:
        check(cli.main(["extract", png2, npz[1]]) == 0, "cli extract: exit code")
        check(cli.main(["extract_batch", *lists, "--shard", "0/2"]) == 0,
              "cli extract_batch 0/2: exit code")
    torch.cuda.synchronize()
    launches["cli_extract_640x800"] = dict(pk.LAUNCHES)
    counts["cli_extract_640x800"] = noting.counts
    mtime = os.path.getmtime(npz[1])
    pk.reset_launches()
    check(cli.main(["extract_batch", *lists, "--shard=1/2"]) == 0,
          "cli extract_batch 1/2: exit code")
    skipped = sum(pk.LAUNCHES.values()) == 0 and os.path.getmtime(npz[1]) == mtime
    n_feat = [int(keys.load_npz(p, device="cuda").count()) for p in npz]
    out["extract"] = dict(descriptors=n_feat, launches=launches["cli_extract_640x800"],
                          shard_1_skipped=skipped)
    print(f"cli extract / extract_batch: descriptors {n_feat}; launches "
          f"{launches['cli_extract_640x800']}; shard 1/2 skipped its output: {skipped}")
    check(min(n_feat) > 1000, f"cli extract: {n_feat} descriptors")
    check(skipped, "cli extract_batch 1/2 did not skip its output")
    rows_for_launches(torch, pk, rows, launched, "cli_extract_640x800")
    check_shapes_timed(rows, "cli_extract_640x800", launched)
    torch.cuda.empty_cache()
    return launches, counts, out


def free_ports(n):
    """n TCP ports that no socket of this machine holds now: bound at once
    on localhost with port 0, read and released (a port just released
    also serves as one that nobody listens on)."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def serve_phase(torch, cnn, cfg, textured_image):
    """The three ZMQ daemons (serve/zmq_server.py) as threads on free
    localhost ports, on the card; `query` with CNN_N seeded 32x32 patches a head:
    each reply equals the net's direct forward on the card (HardNet within
    1e-2 on 0..255, AffNet 1e-4, OriNet's angle 1e-3 rad); ms per CNN_N
    patches through the server (median of 5 after a warm call: PNG
    encoding, the socket, decoding, the forward and the copies) beside the
    bare forward's (mean of 5 between CUDA events); a query to a port no
    daemon serves raises after its timeout; the daemons stop."""
    import threading
    import cv2
    import zmq
    from mods_tpu_torch.serve import zmq_server as zs
    p_cpu = cnn_patches_seeded(torch, textured_image, CNN_N, 31).clamp(0, 255)
    patches = p_cpu.numpy()
    stop = threading.Event()
    *ports, dead = free_ports(4)
    threads = zs.serve_all(cfg, ports, stop, device="cuda")
    out = {}
    try:
        for which, port in zip(zs.HEADS, ports):
            net = cnn.get_net(cfg, which, "cuda")
            got = zs.query(patches, port=port, timeout_s=60.0)
            ref = net(p_cpu.to("cuda")).cpu().numpy()
            if which == "orinet":
                da = np.arctan2(got[:, 0], got[:, 1]) - np.arctan2(ref[:, 0], ref[:, 1])
                err = float(np.abs(np.remainder(da + np.pi, 2 * np.pi) - np.pi).max())
            else:
                err = float(np.abs(got - ref).max())
            check(got.shape == (CNN_N, net.out_dim) and np.isfinite(got).all(),
                  f"serve {which}: reply {got.shape}")
            check(err <= {"hardnet": 1e-2, "affnet": 1e-4, "orinet": 1e-3}[which],
                  f"serve {which}: reply against the forward max abs err {err}")
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                zs.query(patches, port=port, timeout_s=60.0)
                times.append((time.perf_counter() - t0) * 1e3)
            x = p_cpu.to("cuda")
            bare = event_ms(lambda: net(x), 5)
            # the request's parts, once each: the client's PNG encoding, the
            # daemon's decoding and its patches -> reply step
            t0 = time.perf_counter()
            png = cv2.imencode(".png", patches.reshape(-1, 32).astype(np.uint8))[1].tobytes()
            t1 = time.perf_counter()
            dec = zs.decode_patches(png)
            t2 = time.perf_counter()
            zs.describe_patches(net, dec)
            t3 = time.perf_counter()
            parts = dict(encode_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
                         describe_ms=(t3 - t2) * 1e3, png_bytes=len(png))
            out[which] = dict(max_abs_err=err, server_ms=float(np.median(times)),
                              server_runs_ms=times, forward_ms=bare,
                              weights=net.source, parts=parts)
            print(f"serve {which}: {out[which]['server_ms']:.1f} ms per {CNN_N} patches "
                  f"through the daemon (all {', '.join(f'{t:.1f}' for t in times)}), "
                  f"forward {bare:.1f} ms; parts {parts}; reply against the forward "
                  f"max abs err {err:.2e}")
        t0 = time.perf_counter()
        try:
            zs.query(patches[:1], port=dead, timeout_s=0.5)
            check(False, "serve: a query to a dead port returned")
        except zmq.error.Again:
            out["dead_port_s"] = time.perf_counter() - t0
        print(f"serve: a dead port raised after {out['dead_port_s']:.2f} s")
    finally:
        stop.set()
        for th in threads:
            th.join(10)
    check(not any(th.is_alive() for th in threads), "serve: a daemon did not stop")
    return out


def parallel_phase(torch, pk, rows):
    """parallel/mesh.py on a one-process NCCL group on the card (world
    size 1, a free localhost port), make_mesh(1, 1): sharded_knn of 8192
    queries against 65,536 database rows (seeded integers 0..255, 128
    wide, k 50) equals the dense match.matching._knn, distances and
    indices; batch_match_sharded on 4 warp_pair(640, 800, seed) pairs at
    max_kp 4096 (each pair's generator seeded with its index) equals
    models/flagship.match_pairs with the same per-pair generators (H to
    1e-5, counts equal).  The group is destroyed at the end.

    With one rank this holds the NCCL set-up, the all_gathers over the
    mesh's one-rank groups, the keyed merge of the one block's top-k and
    the per-pair generators on the card; the split over several ranks is
    held by tests/test_torch_parallel.py (gloo, against the JAX package)
    and tools/mesh_check.py (NCCL on four cards)."""
    import torch.distributed as dist
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.match.matching import _knn
    from mods_tpu_torch.models import flagship
    from mods_tpu_torch.parallel.mesh import batch_match_sharded, make_mesh, sharded_knn
    from mods_tpu_torch.testing import warp_pair
    port, = free_ports(1)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    out = {}
    try:
        mesh = make_mesh(1, 1)
        rng = np.random.default_rng(41)
        q = torch.from_numpy(rng.integers(0, 256, (8192, 128)).astype(np.float32)).cuda()
        db = torch.from_numpy(rng.integers(0, 256, (65536, 128)).astype(np.float32)).cuda()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, idx = sharded_knn(mesh, q, db, 50)
        torch.cuda.synchronize()
        knn_ms = (time.perf_counter() - t0) * 1e3
        dd, di = _knn(q, db, torch.ones(65536, dtype=torch.bool, device="cuda"), 50, False)
        out["knn"] = dict(queries=8192, rows=65536, k=50, ms=knn_ms,
                          dists_equal=bool(torch.equal(d, dd)),
                          indices_equal=bool(torch.equal(idx, di)))
        print(f"parallel sharded_knn 8192 x 65536, k 50: {knn_ms:.1f} ms; "
              f"equal to _knn: {out['knn']}")
        check(out["knn"]["dists_equal"] and out["knn"]["indices_equal"],
              "parallel: sharded_knn is not the dense _knn")
        del q, db, d, idx, dd, di

        cfg = Config()
        cfg.max_octave_cands = 4096
        pairs = [warp_pair(640, 800, 11 + i) for i in range(4)]
        imgs1 = np.stack([p[0] for p in pairs])
        imgs2 = np.stack([p[1] for p in pairs])
        pk.reset_launches()
        noting = noting_launches(pk, keep=True)
        t0 = time.perf_counter()
        with noting as launched:
            H, inl, tent = batch_match_sharded(mesh, cfg, imgs1, imgs2, max_kp=4096)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = {"sharded_640x800": dict(pk.LAUNCHES)}
        counts = {"sharded_640x800": noting.counts}
        gens = [torch.Generator(device="cuda").manual_seed(i) for i in range(4)]
        Hr, inlr, tentr, _, _ = flagship.match_pairs(imgs1, imgs2, cfg, 4096,
                                                     generator=gens)
        h_err = float((H - Hr.float()).abs().max())
        out["batch"] = dict(pairs=4, wall_ms=wall, inliers=inl.tolist(),
                            tentatives=tent.tolist(), ref_inliers=inlr.tolist(),
                            ref_tentatives=tentr.tolist(), H_max_abs_err=h_err,
                            launches=launches["sharded_640x800"],
                            shapes_launched=noting.shapes())
        print(f"parallel batch_match_sharded 4 x 640x800: {wall:.0f} ms; inliers "
              f"{inl.tolist()} (match_pairs {inlr.tolist()}), tentatives "
              f"{tent.tolist()} ({tentr.tolist()}), H max abs err {h_err:.2e}; "
              f"launches {launches['sharded_640x800']}")
        check(inl.tolist() == inlr.tolist() and tent.tolist() == tentr.tolist(),
              "parallel: batch_match_sharded counts are not match_pairs'")
        check(h_err <= 1e-5, f"parallel: H differs by {h_err}")
        check(min(inl.tolist()) >= 15, f"parallel: inliers {inl.tolist()}")
        for k in ("dma_baumberg", "dma_hat_resample", "baumberg_windows"):
            check(launches["sharded_640x800"][k] > 0, f"batch_match_sharded did not launch {k}")
        rows_for_launches(torch, pk, rows, launched, "sharded_640x800")
        check_shapes_timed(rows, "sharded_640x800", launched)
        del launched
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches, counts, out


EXT_TOOL = r'''
import shutil, sys
import cv2
import numpy as np
mode, keep, src, dst = sys.argv[1:5]
shutil.copy(src, keep)
img = cv2.imread(src, cv2.IMREAD_GRAYSCALE)
n = img.shape[0] // img.shape[1]
k = np.arange(n)
if mode == "desc":
    vals = [3] + list(np.stack([k, (k % 5) * 0.25, np.full(n, n)], 1).ravel())
elif mode == "ori":
    vals = 0.1 * (k % 7) - 0.3
else:
    vals = np.stack([1.2 + 0.05 * (k % 3), 0.1 * (k % 2), -0.05 * (k % 4),
                     np.full(n, 0.8)], 1).ravel()
with open(dst, "w") as fh:
    fh.write(" ".join(f"{v:.9g}" for v in vals))
'''


def ext_phase(torch, pk, rows, textured_image, tmp):
    """pipeline.extract_view on a 640x800 image at 8192 keypoints with the
    external affine-shape command, the external orientation command and
    CLIDescriptor, each a mock tool written into `tmp` (it keeps the BMP
    it was given and answers by patch index): the descriptor rows are the
    tool's, the descriptor frames the regions' rotated by the tool's
    angles, the regions' frames lower-triangular (rectified); the
    descriptor patches the port wrote (BMP, through cv2) within 1 grey
    level of extract_patches_host on the CPU at the same keypoints."""
    import cv2
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.ops import patches as patchops
    from mods_tpu_torch.pipeline import extract_view
    path = os.path.join(tmp, "tool.py")
    with open(path, "w") as fh:
        fh.write(EXT_TOOL)
    keep = {m: os.path.join(tmp, f"kept_{m}.bmp") for m in ("aff", "ori", "desc")}
    run = {m: f"{sys.executable} {path} {m} {keep[m]}" for m in keep}
    cfg = Config()
    cfg.hessian.affine.external_command = run["aff"]
    cfg.domori.external_command = run["ori"]
    cfg.cli_descriptor_runfile = run["desc"]
    img = textured_image(640, 800, 13)
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    t0 = time.perf_counter()
    with noting as launched:
        vf = extract_view(torch.from_numpy(img).cuda(), np.eye(3), 800, 640, cfg,
                          "HessianAffine", ["CLIDescriptor"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {"ext_640x800": dict(pk.LAUNCHES)}
    counts = {"ext_640x800": noting.counts}
    f = vf.by_desc["CLIDescriptor"]
    v = f.valid.cpu().numpy()
    n = int(v.sum())
    k = np.arange(n)
    desc_ok = np.array_equal(f.desc.cpu().numpy()[v],
                             np.stack([k, (k % 5) * 0.25, np.full(n, n)], 1))
    ang = 0.1 * (np.arange(f.n) % 7) - 0.3
    c, s = np.cos(-ang), np.sin(-ang)
    A = vf.regions.det.A.cpu().numpy()
    rot = np.stack([np.stack([A[:, 0, 0] * c - A[:, 0, 1] * s,
                              A[:, 0, 0] * s + A[:, 0, 1] * c], -1),
                    np.stack([A[:, 1, 0] * c - A[:, 1, 1] * s,
                              A[:, 1, 0] * s + A[:, 1, 1] * c], -1)], -2)
    rot_err = float(np.abs(f.det.A.cpu().numpy()[v] - rot[v]).max())
    reg_v = vf.regions.det.valid.cpu().numpy()
    upper = float(np.abs(A[reg_v][:, 0, 1]).max())
    kept = cv2.imread(keep["desc"], cv2.IMREAD_GRAYSCALE).astype(int)
    kp = f.det.to("cpu")
    ref = patchops.extract_patches_host(
        torch.from_numpy(img), kp.xy[kp.valid], kp.A[kp.valid], kp.s[kp.valid],
        cfg.cli_descriptor_mr_size, cfg.cli_descriptor_patch_size, photo_norm=True)
    ref = np.clip(np.round(ref.numpy()), 0, 255).astype(int).reshape(kept.shape)
    diff = np.abs(kept - ref)
    out = dict(regions=int(reg_v.sum()), descriptors=n, wall_ms=wall,
               descriptor_rows_are_the_tools=desc_ok, rotation_max_err=rot_err,
               region_a12_max=upper, patch_max_grey_diff=int(diff.max()),
               patch_pixels_differing=float((diff > 0).mean()),
               launches=launches["ext_640x800"], shapes_launched=noting.shapes())
    print(f"external commands 640x800: {out}")
    check(n > 1000 and desc_ok, f"ext: {n} descriptors, rows the tool's: {desc_ok}")
    check(rot_err <= 1e-5, f"ext: orientation off by {rot_err}")
    check(upper == 0.0, f"ext: region frames not rectified ({upper})")
    check(diff.max() <= 1 and (diff > 0).mean() < 0.01,
          f"ext: descriptor patches off the CPU's by {diff.max()}")
    check(launches["ext_640x800"]["dma_baumberg"] > 0, "ext: no dma_baumberg")
    rows_for_launches(torch, pk, rows, launched, "ext_640x800")
    check_shapes_timed(rows, "ext_640x800", launched)
    torch.cuda.empty_cache()
    return launches, counts, out


# the train phase: jitter pairs on 8 base images of 512x512, pipeline pairs
# on 2 images x 2 views, then HardNet at the JAX trainer's batch for 200
# steps of lr 3e-3 (the cosine schedule), validated every 50
TRAIN = dict(pairs=4096, images=8, size=512, pipeline_images=2, pipeline_views=2,
             pipeline_kp=2048, check_batch=256, batch=1024, steps=200, lr=3e-3,
             chunk=50)
# desc/train.make_train_step's spans
TRAIN_STAGES = ("train_forward", "train_backward", "train_update")


def train_phase(torch, pk, rows, tmp):
    """Descriptor training (desc/data.py, desc/train.py,
    tools/train_hardnet.train) on the card, at the sizes of TRAIN:
    1. desc.data.generate_pairs(sz["pairs"], seed 0, sz["images"] base
       images, no graf) under plain_forbidden: B1, B2 and B3 launch (B4
       does not: every base image is 512x512), every launch shape gets a
       row; base images from files and procedural, ms per image;
    2. generate_pairs_pipeline on 2 images x 2 views at 512 (max_kp 2048,
       AffNet and OriNet at seeded random weights, the opt-in): > 0 pairs;
       B2 only (no Baumberg in the deep configuration);
    3. one training step's loss, weight gradients and new BN statistics
       (train_bn) on 256 pairs of step 1 drawn with replacement (duplicate
       ids), card against CPU from one init_hardnet_params: loss 1e-4
       relative, stats 1e-4; each gradient's error (of its tensor's largest
       entry) against float64 on the CPU at most 1e-3 or twice the CPU's
       largest float32 error there (the card-against-CPU error is printed);
    4. tools.train_hardnet.train at batch 1024, 200 steps of Adam at lr 3e-3
       under the cosine schedule, chunks of 50, on the pairs of step 1 split
       by source keypoint: the last chunk's mean loss below the first's;
       ms a step (median over the chunks, host clock after a synchronize)
       beside the FLOP bound (3 x the forward's of 2 x batch patches at 67
       TFLOP/s), peak memory, fpr95 and val accuracy;
    5. the final file through cnn.load_layers into the inference HardNet,
       whose descriptors equal quantize(hardnet_embed) of the trained net
       within 1e-2 on 0..255;
    6. five steps of a copy of the trained net traced (torch.profiler):
       host and device ms of the forward, backward and update spans, the
       device's busy share, the kernels with the most device time.
    Returns (launches, counts, the "train_hardnet" dict)."""
    from mods_tpu_torch.desc import cnn
    from mods_tpu_torch.desc import data as D
    from mods_tpu_torch.desc import train as T
    from mods_tpu_torch.tools import train_hardnet as tool
    sz, dev, sync = TRAIN, "cuda", torch.cuda.synchronize
    out, launches, counts = {}, {}, {}

    # 1. jitter pairs over the Baumberg and resample kernels
    from_files = min(sz["images"], len(D._collage_tiles(sz["size"]))
                     + len(D._discover_photos()))
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    sync()
    t0 = time.perf_counter()
    with plain_forbidden(pk), noting as launched:
        a, p, ids = D.generate_pairs(sz["pairs"], seed=0, n_images=sz["images"],
                                     include_graf=False, device=dev)
    sync()
    gen_s = time.perf_counter() - t0
    launches["train_pairs_512"] = dict(pk.LAUNCHES)
    counts["train_pairs_512"] = noting.counts
    out["jitter_pairs"] = dict(
        pairs=len(a), unique_ids=int(len(np.unique(ids))), images=sz["images"],
        images_from_files=from_files, images_procedural=sz["images"] - from_files,
        ms_per_image=gen_s * 1e3 / sz["images"], launches=launches["train_pairs_512"],
        shapes_launched=noting.shapes())
    print(f"train jitter pairs: {out['jitter_pairs']}")
    # each image takes its share of what is still needed; flat patches are
    # dropped after sampling, so the set can end a little short
    check(len(a) >= 0.9 * sz["pairs"] and np.isfinite(a).all() and np.isfinite(p).all(),
          f"train: {len(a)} jitter pairs")
    for k in ("dma_baumberg", "dma_hat_resample", "baumberg_windows"):
        check(launches["train_pairs_512"][k] > 0, f"train pairs did not launch {k}")
    check(launches["train_pairs_512"]["hat_resample"] == 0, "train pairs launched B4")
    rows_for_launches(torch, pk, rows, launched, "train_pairs_512")
    check_shapes_timed(rows, "train_pairs_512", launched)
    del launched

    # 2. pipeline pairs: the deep frame chain on warped views
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    sync()
    t0 = time.perf_counter()
    with plain_forbidden(pk), noting as launched:
        pa, pp, pi = D.generate_pairs_pipeline(
            10 ** 6, seed=0, n_images=sz["pipeline_images"],
            views_per_image=sz["pipeline_views"], max_kp=sz["pipeline_kp"],
            size=sz["size"], device=dev)
    sync()
    launches["pipeline_pairs_512"] = dict(pk.LAUNCHES)
    counts["pipeline_pairs_512"] = noting.counts
    out["pipeline_pairs"] = dict(
        pairs=len(pa), images=sz["pipeline_images"], views=sz["pipeline_views"],
        max_kp=sz["pipeline_kp"], wall_ms=(time.perf_counter() - t0) * 1e3,
        launches=launches["pipeline_pairs_512"], shapes_launched=noting.shapes())
    print(f"train pipeline pairs: {out['pipeline_pairs']}")
    check(len(pa) > 0 and np.isfinite(pa).all(), "train: no pipeline pairs")
    check(launches["pipeline_pairs_512"]["dma_hat_resample"] > 0,
          "pipeline pairs did not launch dma_hat_resample")
    rows_for_launches(torch, pk, rows, launched, "pipeline_pairs_512")
    check_shapes_timed(rows, "pipeline_pairs_512", launched)
    del launched

    # 3. one step's loss, gradients and BN statistics, card against CPU
    #    (and both against the CPU in float64)
    net0 = T.init_hardnet_params(torch.Generator().manual_seed(0), "cpu")
    sel = np.random.default_rng(1).choice(len(a), sz["check_batch"], replace=True)
    got = []
    for where, dt in ((dev, torch.float32), ("cpu", torch.float32),
                      ("cpu", torch.float64)):
        net = T.from_jax_params(net0.params(), where).to(dt)
        f = lambda x: torch.from_numpy(x[sel]).to(where, dt)
        loss, stats = T.train_loss(net, f(a), f(p), torch.from_numpy(ids[sel]).to(where),
                                   train_bn=True)
        loss.backward()
        got.append((float(loss.detach()),
                    {k: w.grad.cpu().double() for k, w in net.named_parameters()},
                    {k: v.cpu().double() for k, v in stats.items()}))
    (l_d, g_d, s_d), (l_c, g_c, s_c), (_, g_64, _) = got
    rel = lambda g, r: {k: float((g[k] - r[k]).abs().max() / r[k].abs().max()) for k in r}
    card_cpu, card_64, cpu_64 = rel(g_d, g_c), rel(g_d, g_64), rel(g_c, g_64)
    stat_err = max(float((s_d[k] - s_c[k]).abs().max()) for k in s_c)
    out["step_card_vs_cpu"] = dict(
        batch=sz["check_batch"], duplicate_rows=int(sz["check_batch"] - len(np.unique(
            ids[sel]))), loss=l_d, cpu_loss=l_c, loss_rel_err=abs(l_d - l_c) / abs(l_c),
        grad_err_rel_to_max=max(card_cpu.values()), grad_err_by_tensor=card_cpu,
        card_vs_float64=card_64, cpu_vs_float64=cpu_64, stats_max_abs_err=stat_err)
    print(f"train step card against CPU: {out['step_card_vs_cpu']}")
    check(abs(l_d - l_c) <= 1e-4 * abs(l_c), f"train step loss {l_d} vs cpu {l_c}")
    # at initial weights float32 itself is off float64 by up to ~1e-2 of a
    # gradient's largest entry (batch-statistics BN's backward cancels on
    # near-collapsed embeddings), on the CPU as on the card, tensor by
    # tensor at random: the card's gradients must be no farther from
    # float64 than twice the CPU's farthest (or 1e-3)
    noise = max(cpu_64.values())
    for k in g_c:
        check(card_64[k] <= max(1e-3, 2.0 * noise),
              f"train step gradient {k}: card {card_64[k]:.2e} off float64, the "
              f"CPU's float32 up to {noise:.2e}")
    check(stat_err <= 1e-4, f"train step BN statistics off by {stat_err}")

    # 4. training at full width
    net = T.init_hardnet_params(torch.Generator().manual_seed(0), dev)
    torch.cuda.reset_peak_memory_stats()
    path = os.path.join(tmp, "hardnet_trained.npz")
    hist = tool.train(net, a, p, ids, sz["steps"], sz["batch"], sz["lr"], sz["chunk"],
                      0, path, log=lambda m: print(f"train: {m}"))
    T.save_hardnet_npz(net, path)
    step_ms = float(np.median([h["train_s"] for h in hist])) * 1e3 / sz["chunk"]
    inf = cnn.params_from_jax(net.to_layers(), "hardnet", dev)
    flops = 3 * 2.0 * conv_macs(inf) * 2 * sz["batch"]
    b_ms, b_by = bound_ms(0, flops)
    out["training"] = dict(
        batch=sz["batch"], steps=hist[-1]["step"], lr=sz["lr"], chunk=sz["chunk"],
        ms_per_step=step_ms, bound_ms=b_ms, bound_by=b_by, chunks=hist,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        first_chunk_loss=hist[0]["loss"], last_chunk_loss=hist[-1]["loss"],
        fpr95=hist[-1]["fpr95"], val_acc=hist[-1]["val_acc"])
    print(f"train HardNet, batch {sz['batch']}: {step_ms:.2f} ms a step (bound "
          f"{b_ms:.2f} ms by {b_by}), loss {hist[0]['loss']:.4f} -> "
          f"{hist[-1]['loss']:.4f}, fpr95 {hist[-1]['fpr95']:.4f}, val acc "
          f"{hist[-1]['val_acc']:.4f}, peak {out['training']['peak_memory_gb']} GB")
    check(hist[-1]["loss"] < hist[0]["loss"], f"train: the loss did not fall: {hist}")

    # 5. the saved file in the inference HardNet
    layers, source = cnn.load_layers(path, "hardnet")
    loaded = cnn.params_from_jax(layers, "hardnet", dev)
    val_sel, _ = T.split_by_keypoint(ids)
    x = torch.from_numpy(a[val_sel[:1024]]).to(dev)
    with torch.no_grad():
        reload_err = float((loaded(x) - cnn.quantize(T.hardnet_embed(net, x))).abs().max())
    out["reload"] = dict(file=os.path.basename(source), patches=len(x),
                         max_abs_err=reload_err)
    print(f"train reload: {out['reload']}")
    check(reload_err <= 1e-2, f"train: the reloaded HardNet is off by {reload_err}")

    # 6. where a step's time goes: 5 steps of a copy of the trained net traced
    tnet = T.from_jax_params(net.params(), dev)
    opt, sched = T.cosine_adam(tnet, sz["lr"], sz["steps"])
    step = T.make_train_step(opt, train_bn=True, scheduler=sched)
    sel = torch.randint(0, len(a), (sz["batch"],), generator=torch.Generator().manual_seed(2))
    xa, xp = (torch.from_numpy(v[sel.numpy()]).to(dev) for v in (a, p))
    xi = torch.from_numpy(ids[sel.numpy()]).to(dev)
    step(tnet, xa, xp, xi)
    prof = stage_profile(torch, lambda: [step(tnet, xa, xp, xi) for _ in range(5)],
                         TRAIN_STAGES, table=False)
    # autograd runs the backward's kernels from its own thread, outside the
    # span's extent on the device: its work is the busy time the other two
    # spans leave
    prof["backward_device_ms_by_difference"] = prof["device_busy_ms"] - sum(
        prof["stages"][k]["device_ms"] or 0.0 for k in ("train_forward", "train_update"))
    out["training"]["traced_5_steps"] = prof
    print("train traced 5 steps: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}); "
          "spans (host/device ms): {}; backward's device ms by difference {:.1f}; "
          "top kernels: {}".format(
              prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
              ", ".join(f"{k} {v['host_ms']:.1f}/{_ms(v['device_ms'])}"
                        for k, v in prof["stages"].items()),
              prof["backward_device_ms_by_difference"],
              [(k["name"][:40], round(k["device_ms"], 2)) for k in
               prof["top_device_kernels"]]))
    torch.cuda.empty_cache()
    return launches, counts, out


TOOLS_HW = (640, 800)          # the tools' pair: the main path's warp pair
TOOLS_KP = 4096                # profile's --max-kp
PROFILE_STAGES = (
    ("default", ("detect (all octaves)", "extract (det+ori+desc)", "match_fginn",
                 "duplicate_filter", "ransac_h", "FULL match_pair")),
    ("kernels", ("gaussian_blur sigma=1.6", "half_image", "build_mip_pyramid",
                 "build_octave 0 (blur+resp)", "find_extrema (NMS+compact)",
                 "sample_patches 41px x{n}", "sample_patches 32px x{n}")),
    ("deep", ("mip_pyramid", "cnn patches 32px x{n}", "hardnet_forward x{n}",
              "affnet_forward x{n}", "orinet_forward x{n}")))


def run_tools(tmp, jobs):
    """Each (name, args) of `jobs` as `python -m mods_tpu_torch.tools.<name>
    ARGS` from the repository's root on the default device, all started at
    once, AffNet and OriNet at seeded random weights (the opt-in), their
    output in files in `tmp`: {name: (standard output lines, seconds from
    the start to its exit)}.  Each must exit 0 within 600 s; at the limit
    every one still running is killed."""
    env = {**os.environ, "MODS_TPU_ALLOW_RANDOM_CNN": "1"}
    t0 = time.perf_counter()
    procs, logs, walls = {}, {}, {}
    try:
        for name, args in jobs:
            logs[name] = [open(os.path.join(tmp, f"tool_{name}.{s}"), "w+")
                          for s in ("out", "err")]
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", f"mods_tpu_torch.tools.{name}", *args], cwd=HERE,
                env=env, stdout=logs[name][0], stderr=logs[name][1], text=True)
        while len(walls) < len(procs):
            for name, p in procs.items():
                if name not in walls and p.poll() is not None:
                    walls[name] = time.perf_counter() - t0
            check(time.perf_counter() - t0 < 600,
                  f"tools {sorted(set(procs) - set(walls))}: still running after 600 s")
            time.sleep(0.2)
        out = {}
        for name, p in procs.items():
            text = []
            for f in logs[name]:
                f.seek(0)
                text.append(f.read())
            check(p.returncode == 0, f"tools {name}: exit code {p.returncode}\n"
                  f"{text[0][-2000:]}\n{text[1][-4000:]}")
            out[name] = (text[0].splitlines(), walls[name])
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (f for pair in logs.values() for f in pair):
            f.close()


def profile_times(lines):
    """{stage: ms} of the profiler's stage lines."""
    out = {}
    for ln in lines:
        name, rest = ln[:34].strip(), ln[34:].split()
        if len(rest) == 2 and rest[1] == "ms":
            out[name] = float(rest[0])
    return out


def ext_counts(path):
    """{"detector/descriptor": rows} of a file in the extended native
    format (io/keys.py save_regions_native_ext)."""
    with open(path) as fh:
        lines = iter([ln for ln in fh.read().splitlines() if ln.strip()])
    out = {}
    for _ in range(int(next(lines))):
        det, n_maps = next(lines).rsplit(" ", 1)
        for _ in range(int(n_maps)):
            dn, n = next(lines).rsplit(" ", 1)
            for _ in range(int(n) + 1):      # the dimension, then the rows
                next(lines)
            out[f"{det}/{dn}"] = int(n)
    return out


def tools_phase(torch, pk, rows, tmp, trained):
    """The port's tools (mods_tpu_torch/tools/) on the card, each run as
    `python -m mods_tpu_torch.tools.<name>` on the 640x800 warp pair
    (warp_pair(640, 800, 1)) written as PNG files in `tmp`, at their own
    defaults (Config() and one Hessian-Affine RootSIFT step, or
    testing.deep_config() and one ZMQ step; AffNet and OriNet at seeded
    random weights under the opt-in); each must exit 0, and:
    - golden_run prints the counts of match_images on the same files and
      configuration with the same draws (a generator seeded with
      cfg.ransac.seed), in this process;
    - eval_deep prints one line for weights/HardNetPS.npz (at least 15
      inliers) and one for `trained`, train_phase's checkpoint;
    - export_native's two files parse back through io/keys.py to the
      rows it printed per detector and descriptor, and so do the counts in
      their extended twins;
    - diag_deep prints the six stage counts of both images, each stage
      keeping at most what the one before it kept, described > 100;
    - diag_deep_ab prints HardNet's and RootSIFT's counts, HardNet at least
      15 inliers;
    - profile with --kernels --deep --reps 3 --max-kp 4096 prints every
      stage of its three sections with a positive time;
    then profile.main with the three sections (--reps 1) in this process:
    B1, B2 and B3 launch, and every launch shape has a row
    (rows_for_launches, check_shapes_timed).  The first five tools run at
    once, then profile alone (it times its stages); each tool's seconds
    from its start to its exit (start-up and kernel load included) are
    kept."""
    from argparse import Namespace
    import cv2
    from mods_tpu_torch import cli
    from mods_tpu_torch.io import keys
    from mods_tpu_torch.testing import warp_pair
    from mods_tpu_torch.tools import common, profile
    from mods_tpu_torch.twoview import match_images
    h, w = TOOLS_HW
    img1, img2, _ = warp_pair(h, w, 1)
    pngs = [_png(cv2, os.path.join(tmp, f"tools_img{i}.png"), im)
            for i, im in ((1, img1), (2, img2))]
    pair = ["--img1", pngs[0], "--img2", pngs[1]]
    k = [os.path.join(tmp, f"tools_k{i}.txt") for i in (1, 2)]
    prof_args = ["--size", f"{h}x{w}", "--max-kp", str(TOOLS_KP), "--kernels", "--deep"]
    ran = run_tools(tmp, [
        ("golden_run", pair), ("export_native", [*k, *pair]), ("diag_deep", pair),
        ("diag_deep_ab", pair),
        ("eval_deep", [os.path.join(HERE, "weights", "HardNetPS.npz"), trained, *pair])])
    ran.update(run_tools(tmp, [("profile", [*prof_args, "--reps", "3"])]))
    out = {"wall_s": {name: wall for name, (_, wall) in ran.items()}}

    def run(name):
        print(f"tools {name} ({out['wall_s'][name]:.1f} s):\n  " + "\n  ".join(ran[name][0]))
        return ran[name][0]

    # golden_run against match_images in this process
    lines = "\n".join(run("golden_run"))
    cfg = common.tool_config(Namespace(config=None, iters=None))
    r = match_images(cli.load_gray(pngs[0]), cli.load_gray(pngs[1]), cfg,
                     device="cuda", generator=common.ransac_generator(cfg, torch.device("cuda")))
    want = (f"regions: {r.regions1}/{r.regions2} ", f"descriptors: {r.descriptors1}/"
            f"{r.descriptors2} ", f"tentatives: {r.tentatives} unique: "
            f"{r.unique_tentatives} ", f"inliers: {r.inliers} ")
    out["golden_run"] = mods_counts(r)
    for s in want:
        check(s in lines, f"tools golden_run: no '{s}' in its output")
    check(r.inliers >= 15, f"tools golden_run: {r.inliers} inliers")

    # eval_deep: the committed HardNet and the trainer's checkpoint
    lines = run("eval_deep")
    check(len(lines) == 2, f"tools eval_deep: {len(lines)} lines for 2 checkpoints")
    evals = []
    for ln, p in zip(lines, ("HardNetPS.npz", os.path.basename(trained))):
        tok = dict(re.findall(r"(\w+)=\s*([0-9.]+)", ln))
        evals.append({k: float(v) for k, v in tok.items()})
        check(ln.startswith(p) and ln.endswith("[graf ref: 264/254/147]")
              and set(tok) == {"tent", "uniq", "inl", "ratio"},
              f"tools eval_deep: {ln!r}")
    check(evals[0]["inl"] >= 15, f"tools eval_deep: {evals[0]}")
    out["eval_deep"] = evals

    # export_native: the files against the printed counts
    lines = run("export_native")
    out["export_native"] = {}
    for ln, path in zip(lines, k):
        printed = {kv.split("=")[0]: int(kv.split("=")[1])
                   for kv in ln.split(": ", 1)[1].split(", ")}
        parsed = {f"{det}/{dn}": int(f.count()) for det, dmap in
                  keys.load_regions_native(path, device="cuda").items()
                  for dn, f in dmap.items()}
        ext = ext_counts(path.replace(".txt", "_ext.txt"))
        out["export_native"][os.path.basename(path)] = parsed
        check(ln.startswith(path) and printed == parsed == ext and min(parsed.values()) > 1000,
              f"tools export_native {path}: printed {printed}, parsed {parsed}, ext {ext}")

    # diag_deep: the stage counts
    lines = run("diag_deep")
    out["diag_deep"] = {}
    for name in ("tools_img1", "tools_img2"):
        row = [ln for ln in lines if ln.startswith(name + ": ")]
        check(len(row) == 1, f"tools diag_deep: no line for {name}")
        n = {kv.split("=")[0]: int(kv.split("=")[1]) for kv in row[0].split()[1:]}
        out["diag_deep"][name] = n
        stages = ("detected", "affnet_ok", "reproj_ok", "orinet", "border_ok", "described")
        check(list(n) == list(stages) and all(
            n[a] >= n[b] for a, b in zip(stages, stages[1:])) and n["described"] > 100,
            f"tools diag_deep {name}: {n}")

    # diag_deep_ab: both descriptors matched
    lines = run("diag_deep_ab")
    ab = {}
    for ln in lines:
        if ln.startswith(("HardNet(ours):", "RootSIFT     :")):
            ab[ln.split(":")[0].strip()] = {kv.split("=")[0]: int(kv.split("=")[1])
                                            for kv in ln.split(":", 1)[1].split()}
    out["diag_deep_ab"] = ab
    check(set(ab) == {"HardNet(ours)", "RootSIFT"} and ab["HardNet(ours)"]["inliers"] >= 15,
          f"tools diag_deep_ab: {lines}")

    # profile: every stage of the three sections timed
    lines = run("profile")
    times = profile_times(lines)
    out["profile"] = dict(header=lines[0], stages_ms=times)
    check("nvidia-smi:" in lines[0], f"tools profile: header {lines[0]!r}")
    for section, names in PROFILE_STAGES:
        for name in names:
            name = name.format(n=TOOLS_KP)
            check(times.get(name, 0.0) > 0.0, f"tools profile {section}: no time for {name}")

    # the kernels under the tools: profile.main in this process
    pk.reset_launches()
    noting = noting_launches(pk, keep=True)
    with noting as launched:
        check(profile.main([*prof_args, "--reps", "1"]) == 0,
              "tools profile.main: exit code")
    torch.cuda.synchronize()
    label = "tools_profile_640x800"
    launches, counts = {label: dict(pk.LAUNCHES)}, {label: noting.counts}
    out["launches"], out["shapes_launched"] = launches[label], noting.shapes()
    print(f"tools profile.main launches {launches[label]}; shapes launched: "
          f"{out['shapes_launched']}")
    for kname in ("dma_baumberg", "dma_hat_resample", "baumberg_windows"):
        check(launches[label][kname] > 0, f"tools profile.main did not launch {kname}")
    rows_for_launches(torch, pk, rows, launched, label)
    check_shapes_timed(rows, label, launched)
    torch.cuda.empty_cache()
    return launches, counts, out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mods_tpu_torch import resolve_device
    from mods_tpu_torch.config import Config
    from mods_tpu_torch.desc import cnn
    from mods_tpu_torch.models import flagship
    from mods_tpu_torch.ops import image as imops
    from mods_tpu_torch.ops import patch_engine as pe
    from mods_tpu_torch.ops import patch_kernels as pk
    from mods_tpu_torch.testing import (corner_error, rolled_pair, textured_image,
                                        warp_pair)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    resolve_device("cuda")
    t0 = time.time()
    lib = pk.build_library()
    pk._library()
    print(f"kernels built in {time.time() - t0:.1f} s: {os.path.relpath(lib, HERE)}")

    extrema = octave_extrema_phase(torch, pk, imops, textured_image)
    print(json.dumps({"octave_extrema": extrema}))
    rows = kernel_checks(torch, pk, pe, imops, textured_image)

    # ---- 640x800 main path ---- #
    cfg = Config()
    cfg.max_octave_cands = 4096
    max_kp = 4096
    h, w = 640, 800
    img1, img2, H_true = warp_pair(h, w, 1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pk.reset_launches()
    # note the boxes that the pair's dma_hat_resample launches stage
    boxes = []
    resample = pk.dma_hat_resample

    def noting_boxes(pyr, lev, oy, ox, params, P):
        area, empty = box_areas(pk, params, ox, P, pyr.shape[2] % 4 == 0)
        boxed = ~empty & (params[:, 10] > 0.5)
        boxes.append(dict(P=P, n=len(lev), live=int(boxed.sum()),
                          mean_box_floats=float(area[boxed].float().mean()),
                          max_box_floats=int(area[boxed].max()),
                          over_buffer=int((area[boxed] > pk.STAGE_FLOATS).sum())))
        return resample(pyr, lev, oy, ox, params, P)

    pk.dma_hat_resample = noting_boxes
    try:
        noting = noting_launches(pk, keep=True)
        with noting as launched:
            out = flagship.match_pair(img1, img2, cfg, max_kp, generator=gen)
    finally:
        pk.dma_hat_resample = resample
    torch.cuda.synchronize()
    launches = {"640x800": dict(pk.LAUNCHES)}
    counts = {"640x800": noting.counts}
    shapes = noting.shapes()
    print(f"640x800 dma_hat_resample boxes: {boxes}; kernels launched: {shapes}")
    H, ninl, ntent, n1, n2 = [o.cpu().numpy() for o in out]
    for k in ("dma_baumberg", "dma_hat_resample", "baumberg_windows"):
        check(launches["640x800"][k] > 0, f"640x800 pair did not launch {k}")
    rows_for_launches(torch, pk, rows, launched, "640x800")
    check_shapes_timed(rows, "640x800", launched)
    del launched
    err = corner_error(H, H_true, h, w)
    print(f"640x800: n1 {int(n1)} n2 {int(n2)} tentatives {int(ntent)} "
          f"inliers {int(ninl)}, corner error {err:.3f} px, launches "
          f"{launches['640x800']}")
    check(np.isfinite(H).all() and err <= 2.0, f"640x800: corner error {err}")
    pair_ms, times = timed_pairs(torch, flagship, "640x800", img1, img2, cfg,
                                 max_kp, gen)
    prof = stage_profile(
        torch, lambda: flagship.match_pair(img1, img2, cfg, max_kp, generator=gen))
    print("640x800 traced pair: wall {:.1f} ms, device busy {:.1f} ms ({:.1%}); "
          "stages (host/device ms): {}".format(
              prof["wall_ms"], prof["device_busy_ms"], prof["device_busy_share"],
              ", ".join(f"{k} {v['host_ms']:.1f}/{_ms(v['device_ms'])}"
                        for k, v in prof["stages"].items())))
    print(json.dumps({"pair_640x800": dict(
        median_ms=pair_ms, runs_ms=times, n1=int(n1), n2=int(n2),
        tentatives=int(ntent), inliers=int(ninl), corner_error_px=err,
        resample_boxes=boxes, shapes_launched=shapes, traced=prof)}))

    # ---- 640x240: the precropped kernels at full width ---- #
    h, w = 640, 240
    img1, img2, H_true = warp_pair(h, w, 2)
    pk.reset_launches()
    noting = noting_launches(pk)
    with noting as launched:
        out = flagship.match_pair(img1, img2, cfg, max_kp, generator=gen)
    torch.cuda.synchronize()
    launches["640x240"] = dict(pk.LAUNCHES)
    counts["640x240"] = noting.counts
    shapes = noting.shapes()
    H_n, ninl_n, ntent_n, n1_n, n2_n = [o.cpu().numpy() for o in out]
    err_n = corner_error(H_n, H_true, h, w)
    print(f"640x240: n1 {int(n1_n)} n2 {int(n2_n)} tentatives {int(ntent_n)} "
          f"inliers {int(ninl_n)}, corner error {err_n:.3f} px, launches "
          f"{launches['640x240']}; shapes launched: {shapes}")
    for k in ("baumberg_windows", "hat_resample"):
        check(launches["640x240"][k] > 0, f"640x240 pair did not launch {k}")
    for k in ("dma_baumberg", "dma_hat_resample"):
        check(launches["640x240"][k] == 0, f"640x240 pair launched {k}")
    check_shapes_timed(rows, "640x240", launched)
    check(np.isfinite(H_n).all() and err_n <= 2.0, f"640x240: corner error {err_n}")
    narrow_ms, narrow_times = timed_pairs(torch, flagship, "640x240", img1, img2,
                                          cfg, max_kp, gen)
    print(json.dumps({"pair_640x240": dict(
        median_ms=narrow_ms, runs_ms=narrow_times, n1=int(n1_n), n2=int(n2_n),
        tentatives=int(ntent_n), inliers=int(ninl_n), corner_error_px=err_n,
        launches=launches["640x240"], shapes_launched=shapes)}))

    # ---- 96x128 rolled pair: the precropped kernels ---- #
    cfg_s = Config()
    cfg_s.max_octave_cands = 256
    a, b = rolled_pair()
    pk.reset_launches()
    noting = noting_launches(pk)
    with noting as launched:
        out = flagship.match_pair(a, b, cfg_s, 256, generator=gen)
    torch.cuda.synchronize()
    launches["96x128"] = dict(pk.LAUNCHES)
    counts["96x128"] = noting.counts
    shapes = noting.shapes()
    H_s, ninl_s, ntent_s, n1_s, n2_s = [o.cpu().numpy() for o in out]
    print(f"96x128: n1 {int(n1_s)} n2 {int(n2_s)} tentatives {int(ntent_s)} "
          f"inliers {int(ninl_s)}, launches {launches['96x128']}; shapes "
          f"launched: {shapes}")
    for k in ("baumberg_windows", "hat_resample"):
        check(launches["96x128"][k] > 0, f"96x128 pair did not launch {k}")
    check_shapes_timed(rows, "96x128", launched)
    check(np.isfinite(H_s).all() and int(ninl_s) >= 8,
          f"96x128: {int(ninl_s)} inliers")

    # ---- 256x320: card against the port's CPU path, same uniforms ---- #
    cfg_m = Config()
    cfg_m.max_octave_cands = 1024
    img1, img2, H_true = warp_pair(256, 320, 3)
    rng = np.random.default_rng(0)
    (sb, sm), (lb, lm) = flagship.ransac_draw_shapes(cfg_m, 1024)
    draws = {"u_sweep": torch.from_numpy(rng.uniform(size=(sb, sm)).astype(np.float32)),
             "u_lo": torch.from_numpy(rng.uniform(size=(lb, lm)).astype(np.float32))}
    t0 = time.time()
    gpu = [int(o) for o in flagship.match_pair(img1, img2, cfg_m, 1024,
                                               draws=draws)[1:]]
    cpu = [int(o) for o in flagship.match_pair(img1, img2, cfg_m, 1024,
                                               draws=draws, device="cpu")[1:]]
    print(f"256x320 (inliers, tentatives, n1, n2): card {gpu}, cpu {cpu} "
          f"({time.time() - t0:.1f} s)")
    for name, i, tol in (("inliers", 0, 0.05), ("tentatives", 1, 0.03),
                         ("n1", 2, 0.01), ("n2", 3, 0.01)):
        check(abs(gpu[i] - cpu[i]) <= tol * max(cpu[i], 1),
              f"256x320 {name}: card {gpu[i]} vs cpu {cpu[i]}")

    # ---- the MODS loop at full width: a wide-baseline 640x800 pair ---- #
    launches["mods_640x800"], mods = mods_phase(torch, pk, rows, gen)
    # ---- a small MODS run, card against the port's CPU path ---- #
    launches["mods_128x160"], mods_small = mods_card_vs_cpu(torch, pk, rows)
    counts["mods_640x800"] = mods.pop("counts")
    counts["mods_128x160"] = mods_small.pop("counts")
    # ---- every detector of the MODS schedules in the loop: MSER, then
    #      Hessian-Affine, DoG and Harris-Affine; full width, then card
    #      against the port's CPU path ---- #
    launches["mods_all_640x800"], mods_all = mods_all_phase(torch, pk, rows, gen)
    launches["mods_all_128x160"], mods_all_small = mods_all_card_vs_cpu(torch, pk, rows)
    counts["mods_all_640x800"] = mods_all.pop("counts")
    counts["mods_all_128x160"] = mods_all_small.pop("counts")
    # ---- epipolar verification on real tentatives, card against CPU ---- #
    verifiers = verifiers_card_vs_cpu(torch)
    # ---- the MODS loop with F verification on a two-plane 640x800 pair ---- #
    f_launches, f_counts, mods_f = mods_f_phase(torch, pk, rows, gen)
    launches.update(f_launches)
    counts.update(f_counts)
    # ---- the CNN stages: AffNet and OriNet at random weights (their files
    #      are not in the repository), HardNet at its committed weights ---- #
    os.environ[cnn.RANDOM_OPT_IN] = "1"
    cnn_out = cnn_forwards(torch, cnn, Config(), textured_image)
    # ---- HardNet with the classic detector, in the MODS loop ---- #
    h_launches, h_counts, hardnet = hardnet_phase(torch, pk, rows, gen)
    launches.update(h_launches)
    counts.update(h_counts)
    # ---- the deep flagship at full width ---- #
    launches["deep_640x800"], counts["deep_640x800"], deep_out = deep_phase(
        torch, pk, rows, gen)
    # ---- the deep flagship and a HardNet step, card against CPU ---- #
    c_launches, c_counts, cnn_small = cnn_card_vs_cpu(torch, pk, rows)
    launches.update(c_launches)
    counts.update(c_counts)
    # ---- the entry points users run: the CLI apps on image files, the ZMQ
    #      daemons, the multi-process path, the external commands ---- #
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli_counts, cli_out = cli_phase(torch, pk, rows, tmp,
                                                      mods["median_ms"])
        launches.update(cli_launches)
        counts.update(cli_counts)
        serve_out = serve_phase(torch, cnn, Config(), textured_image)
        p_launches, p_counts, parallel_out = parallel_phase(torch, pk, rows)
        launches.update(p_launches)
        counts.update(p_counts)
        e_launches, e_counts, ext_out = ext_phase(torch, pk, rows, textured_image, tmp)
        launches.update(e_launches)
        counts.update(e_counts)
        # ---- descriptor training: the pair generators over the kernels,
        #      then HardNet's training step at full width ---- #
        t_launches, t_counts, train_out = train_phase(torch, pk, rows, tmp)
        launches.update(t_launches)
        counts.update(t_counts)
        # ---- the repository's tools, as a user runs them ---- #
        t_launches, t_counts, tools_out = tools_phase(
            torch, pk, rows, tmp, os.path.join(tmp, "hardnet_trained.npz"))
        launches.update(t_launches)
        counts.update(t_counts)
    # each row's launches on each path, at its shape
    for name in rows:
        for r in (rows[name], *rows[name]["other_shapes"]):
            if "launch" in r:
                key = tuple(tuple(x) if isinstance(x, list) else x for x in r["launch"])
                r["launches_by_path"] = {p: c.get(key, 0) for p, c in counts.items()}

    sources = {"dma_baumberg": ("baumberg_pyr", "mods_tpu/ops/pallas_patch.py:644"),
               "dma_hat_resample": ("resample_pyr", "mods_tpu/ops/pallas_patch.py:434"),
               "baumberg_windows": ("baumberg_win", "mods_tpu/ops/pallas_patch.py:286"),
               "hat_resample": ("resample_win", "mods_tpu/ops/pallas_patch.py:95")}
    kernels = []
    for name, (entry, replaces) in sources.items():
        r = rows[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="mods_tpu_torch/csrc/patch_kernels.cu", entry=entry,
            replaces=replaces,
            launches=sum(l[name] for l in launches.values()),
            launches_by_pair={p: l[name] for p, l in launches.items()},
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{k: v for k, v in r.items() if k not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}))
    # no Pallas kernel: the eager chain of detect/pyramid.py is what it replaces
    kernels.append(dict(
        name="octave_extrema", route="cuda",
        source="mods_tpu_torch/csrc/patch_kernels.cu", entry="octave_extrema",
        replaces="mods_tpu_torch/detect/pyramid.py find_extrema, localize, "
                 "dedup_octave_map",
        launches=sum(l["octave_extrema"] for l in launches.values()),
        launches_by_pair={p: l["octave_extrema"] for p, l in launches.items()},
        max_abs_err=max(r["max_abs_err"] for r in extrema["rows"]), **extrema))
    print(json.dumps({"mods_640x800": mods, "mods_128x160": mods_small}))
    print(json.dumps({"mods_all_640x800": mods_all, "mods_all_128x160": mods_all_small}))
    print(json.dumps({"f_verifiers_graf": verifiers}))
    print(json.dumps({"mods_f_640x800": mods_f}))
    print(json.dumps({"cnn_forwards": cnn_out}))
    print(json.dumps({"hardnet_640x800": hardnet}))
    print(json.dumps({"deep_640x800": deep_out, "card_vs_cpu": cnn_small}))
    print(json.dumps({"cli_640x800": cli_out}))
    print(json.dumps({"serve": serve_out}))
    print(json.dumps({"parallel": parallel_out}))
    print(json.dumps({"external_commands_640x800": ext_out}))
    print(json.dumps({"train_hardnet": train_out}))
    print(json.dumps({"tools_640x800": tools_out}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
