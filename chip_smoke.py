#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

1. prints the card's name and power limit and builds the CUDA kernels
   from mods_tpu_torch/csrc with nvcc;
2. holds each of the four patch kernels against its plain PyTorch version
   on the card, at the shapes of the main paths, and times both (and
   torch.nn.functional.grid_sample for the two resamplers, as a yardstick
   the port never calls); each kernel's bound counts the bytes and
   operations its data needs (the 32-byte sectors its taps touch).  Every
   kernel is timed in turns with its first design (`ms_before`); the
   resamplers also without their staging buffer (`ms_unstaged`);
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
9. runs the epipolar verifiers (DEGENSAC loransac_f, orsa_filter) on the
   committed graf tentatives on the card and on the CPU with the same
   uniforms: inliers within 5 %, ORSA's decision equal; host and device
   ms of each;
10. runs the MODS loop with ver_type LORANSACF, then ORSA, on a 640x800
   pair of two planes at different depths (`testing.two_plane_pair`, a
   known F): at least 15 inliers, at least 8 on each plane, the true
   correspondences within 2 px of F's epipolar lines; times 3 runs of
   each after 1 warm-up and traces one of each;
11. runs HardNet, AffNet and OriNet (desc/cnn.py) on 8192 seeded 32x32
   patches on the card and on the CPU: error, ms per call, FLOP bound;
   HardNet at its committed weights, AffNet and OriNet at seeded random
   weights (their files are not in the repository; the opt-in
   MODS_TPU_ALLOW_RANDOM_CNN is set for them), each net's source printed;
12. runs match_images with HardNet as the descriptor of the classic
   detector on a 640x800 warp pair (one identity step): at least 15
   inliers, H within 2 px; times 3 runs after 1 warm-up and traces one;
   then, with no threshold, the two-step HardNet schedule on the tilted
   640x800 pair at 2048 keypoints;
13. runs the deep flagship (models/deep.match_pair_deep, testing.deep_config,
   8192 keypoints) on a 640x800 warp pair: B2 at P 32 three times a view,
   no Baumberg kernel; times 5 pairs after 2 warm-ups and traces one;
14. runs the deep flagship on a 256x320 pair and a HardNet step on a
   128x160 pair (B4 at P 32) on the card and on the CPU with the same
   RANSAC uniforms, and compares the counts;
   every kernel shape that a path launches and the kernel phase has no
   row for gets a row on the path's own arguments (`rows_for_launches`),
   and every launch must have one (`check_shapes_timed`);
15. prints a "pair_640x800", a "pair_640x240", a MODS, an
   "f_verifiers_graf", a "mods_f_640x800", a "cnn_forwards", a
   "hardnet_640x800", a "deep_640x800" and a "kernels" JSON line, the
   nvidia-smi line, and last {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero; it exits 2 without
a CUDA device.  It imports nothing of JAX.
"""
import bisect
import json
import os
import subprocess
import sys
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


def turns_ms(first, new):
    """Device ms of two versions of one kernel, timed in turns (first, new,
    new, first) so that both see the same card state; each the mean of its
    two readings."""
    a0, b0, b1, a1 = (device_ms(f) for f in (first, new, new, first))
    return (a0 + a1) / 2, (b0 + b1) / 2


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
    # wider than a block has threads (it takes the first design)
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
    return pk._launch_resample_win(pk._library().resample_win, wins, params, P,
                                   stage_floats)


def window_resample_edge_cases(torch, pk, textured_image):
    """hat_resample against its plain version, max error 0, on the cases
    its paths could get wrong, each as the wrapper launches it for that
    patch width, with no staging buffer, with STAGE_FLOATS and with one
    that holds the whole window; the first design on the same cases.
    Returns the cases' names."""
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
    case("P 129 (the first design)", 5, 96, 129)
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
                    pk, wins, params, P, WHOLE_WINDOW_FLOATS),
                "first design": pk.first_hat_resample(wins, params, P)}
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
    smaller side).  `run`, `first` and `plain` call the kernel, its first
    design and the plain version on `args`; `plain_cpu` gives the plain
    version's result on the CPU, where its sums run in another order."""

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
            self.first = lambda: pk.first_dma_baumberg(*args)
            self.plain = lambda trace=None: pk.plain_dma_baumberg(*args, trace=trace)
            self.kind, self.src = "stack", stack
            self.fp = Footprint(pk, stack, pyr_flat(stack, lev, oy, ox),
                                pk.DMA_WIN_Y, pk.DMA_WIN_X)
            self.fixed = nbytes(lev, oy, ox, params, mask)
        else:
            self.args = args = (wins, params, mask, ws, max_iter, 0.05)
            self.run = lambda: pk.baumberg_windows(*args)
            self.first = lambda: pk.first_baumberg_windows(*args)
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
    go wrong; the first design on the same cases.  Returns the cases'
    names."""
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
        for body, run in (("kernel", c.run), ("first design", c.first)):
            what = f"{name}, {label}, {body}"
            U, ok = run()
            torch.cuda.synchronize()
            held_to_plain(c, what, U, ok, U_ref, ok_ref)
            check(not bool(ok[~c.valid].any()), f"{what}: invalid row accepted")
            eye = torch.eye(2, device=U.device)
            check(bool((U[~ok] == eye).all()), f"{what}: rejected U not identity")
            if ws == 19 and n > 100 and src is stack:
                check(int(ok.sum()) > n // 10, f"{what}: {int(ok.sum())} accepted")
            # the sums have a fixed order: a second run gives the same bits
            U2, ok2 = run()
            check(bool((U2 == U).all()) and bool((ok2 == ok).all()),
                  f"{what}: two runs differ")
    return [c[0] for c in cases] + ["two runs bit-equal"]


def baumberg_row(torch, pk, c, name, n, ws):
    """One Baumberg launch (case `c`) against its plain version: the
    kernel timed in turns with the first design, and the bound from the
    samples the keypoints took, iteration by iteration."""
    trace = []
    U_ref, ok_ref = c.plain(trace)
    U, ok = c.run()
    agree, err, unstable = held_to_plain(c, f"{name} n={n}", U, ok, U_ref, ok_ref)
    U2, ok2 = c.run()
    check(bool((U2 == U).all()) and bool((ok2 == ok).all()),
          f"{name} n={n}: two runs differ")
    held_to_plain(c, f"first {name} n={n}", *c.first(), U_ref, ok_ref)
    before, ms = turns_ms(c.first, c.run)
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
               ms_before=before, plain_ms=plain_ms, library_ms=None,
               bound_ms=b, bound_by=by, max_abs_err=err, ok_agree=agree,
               unstable_in_plain=unstable,
               iterations=steps, longest_chain=int(chain.max()),
               accepted=int(ok.sum()), source_bytes_read=c.fp.nbytes,
               launch=[name, list(c.src.shape), n, None])
    print(f"{name} {row['shape']}: {ms:.4f} ms (first design {before:.4f}, "
          f"plain {plain_ms:.3f}, bound {b:.4f} by {by}, {c.fp.nbytes} B of the "
          f"source touched), ok agree {agree:.4f}, U err {err:.2e} ({unstable} "
          f"let off where the plain version is unstable), {steps} "
          f"iterations, longest chain {int(chain.max())}, {int(ok.sum())} accepted")
    return row


def hat_resample_row(torch, pk, wins, params, P):
    """hat_resample on one launch's arguments: error against the plain
    version (0), the first design's agreement, and the times of the
    kernel as the wrapper launches it, of the first design in turns with
    it, of the kernel with no staging buffer and with STAGE_FLOATS, of
    the plain version and of grid_sample, beside the bound."""
    n, Wn = wins.shape[0], wins.shape[-1]
    run = lambda: pk.hat_resample(wins, params, P)
    got = run()
    ref = pk.plain_hat_resample(wins, params, P)
    err = float((got - ref).abs().max())
    check(err == 0.0, f"hat_resample P={P} n={n}: max abs err {err}")
    check(int(got.count_nonzero()) > got.numel() // 8,
          f"hat_resample P={P} n={n}: output nearly all zero")
    first = lambda: pk.first_hat_resample(wins, params, P)
    check(bool((first() == ref).all()), f"first hat_resample P={P} n={n} differs")
    before, ms = turns_ms(first, run)
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
    row = dict(shape=f"wins {tuple(wins.shape)}, P={P}", ms=ms, ms_before=before,
               launch=["hat_resample", list(wins.shape), n, P],
               **by_stage, stage_floats=pk.win_stage_floats(P), plain_ms=plain,
               library_ms=lib, bound_ms=b, bound_by=by, max_abs_err=err,
               source_bytes_read=read, missed_window=int(empty.sum()),
               mean_box_floats=float(area.float().mean()),
               boxes_over_buffer=int((area > pk.STAGE_FLOATS).sum()))
    print(f"hat_resample n={n} P={P}: {ms:.4f} ms (first design {before:.4f}, "
          f"unstaged {by_stage['ms_unstaged']:.4f}, staged "
          f"{by_stage['ms_staged']:.4f}, plain {plain:.3f}, grid_sample {lib:.4f}, "
          f"bound {b:.4f} by {by}, {read} B of the windows touched), err "
          f"{err:.2e}; {int(empty.sum())} off their window, boxes of "
          f"{row['mean_box_floats']:.0f} floats on average, "
          f"{row['boxes_over_buffer']} over {pk.STAGE_FLOATS}")
    return row


def dma_resample_row(torch, pk, pyr, lev, oy, ox, params, P):
    """dma_hat_resample on one launch's arguments: error against the plain
    version (0), dead rows zero, the first design's agreement, and the
    times of the kernel, of the first design in turns with it, of the
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
    first = pk.first_dma_hat_resample(pyr, lev, oy, ox, params, P)
    check(bool((first == ref).all()), f"first dma_hat_resample P={P} n={n} differs")
    del first, ref
    before, ms = turns_ms(
        lambda: pk.first_dma_hat_resample(pyr, lev, oy, ox, params, P), run)
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
    row = dict(shape=f"pyr {tuple(pyr.shape)}, n={n}, P={P}", ms=ms, ms_before=before,
               ms_unstaged=unstaged, plain_ms=plain, library_ms=lib, bound_ms=b,
               bound_by=by, max_abs_err=err, source_bytes_read=read,
               live=int(live.sum()), missed_window=int((live & empty).sum()),
               mean_box_floats=float(area[boxed].float().mean()) if bool(boxed.any())
               else 0.0,
               boxes_over_buffer=int((boxed & (area > pk.STAGE_FLOATS)).sum()),
               launch=["dma_hat_resample", list(pyr.shape), n, P])
    print(f"dma_hat_resample P={P} n={n} on {tuple(pyr.shape)}: {ms:.4f} ms (first "
          f"design {before:.4f}, unstaged {unstaged:.4f}, plain {plain:.3f}, "
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
          "plain version to 0, staged, unstaged and by the first design")
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
            self.first = lambda: pk.first_dma_baumberg(*args)
            self.plain = lambda trace=None: pk.plain_dma_baumberg(*args, trace=trace)
            self.kind = "stack"
            self.fp = Footprint(pk, src, pyr_flat(src, lev, oy, ox),
                                pk.DMA_WIN_Y, pk.DMA_WIN_X)
            self.fixed = nbytes(lev, oy, ox, params, args[5])
        else:
            self.run = lambda: pk.baumberg_windows(*args)
            self.first = lambda: pk.first_baumberg_windows(*args)
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
    return dict(steps_done=r.steps_done, per_step=r.per_step, regions1=r.regions1,
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
    print(json.dumps({"mods_640x800": mods, "mods_128x160": mods_small}))
    print(json.dumps({"f_verifiers_graf": verifiers}))
    print(json.dumps({"mods_f_640x800": mods_f}))
    print(json.dumps({"cnn_forwards": cnn_out}))
    print(json.dumps({"hardnet_640x800": hardnet}))
    print(json.dumps({"deep_640x800": deep_out, "card_vs_cpu": cnn_small}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
