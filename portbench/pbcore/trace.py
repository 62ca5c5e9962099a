"""Reduction of a torch.profiler trace of the window to the numbers the
per-layer metrics read: device busy time as the union of the device's work
intervals, the device time under each program span, the device operations
with the most time, and the device's idle gaps by the host span open at
their start.

`span_device_s` follows chip_smoke.span_device_ms (the device work under a
span's extent on the device, its `gpu_user_annotation`, repeated spans of
a name merged first), with two changes: work is the union of the device's
intervals, so overlapping work counts once, and work that straddles an
extent's edge counts for the part inside it."""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]


def merged(intervals: Iterable[Interval]) -> List[List[float]]:
    """Sorted, disjoint union of [start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def covered(union: List[List[float]], lo: float, hi: float) -> float:
    """Length of [lo, hi) covered by a sorted disjoint union."""
    starts = [s for s, _ in union]
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    tot = 0.0
    while i < len(union) and union[i][0] < hi:
        s, e = union[i]
        tot += max(0.0, min(e, hi) - max(s, lo))
        i += 1
    return tot


def gaps(union: List[List[float]], lo: float, hi: float) -> List[Interval]:
    """The idle intervals inside [lo, hi) between the union's pieces."""
    out, t = [], lo
    for s, e in union:
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def reduce_events(work: Sequence[Tuple[float, float, str]],
                  dev_spans: Sequence[Tuple[float, float, str]],
                  host_spans: Sequence[Tuple[float, float, str]],
                  window: Interval, span_names: Sequence[str],
                  top: int = 10) -> Dict:
    """All times in microseconds on the profiler's clock.

    work: the device's operations (start, end, name); dev_spans: the
    program spans' extents on the device; host_spans: the same spans on
    the host; window: the traced window's extent on the host.
    Returns busy_s, window_s, span_device_s {name: s or None}, device_ops
    [[name, s]] (the `top` with the most time) and idle_gaps [[name, s]]
    (idle time summed by the host span open at each gap's start, the
    `top` largest)."""
    lo, hi = window
    union = merged((s, e) for s, e, _ in work if e > lo and s < hi)
    busy = covered(union, lo, hi)
    span_dev: Dict[str, Optional[float]] = {}
    for name in span_names:
        ext = merged((s, e) for s, e, n in dev_spans if n == name)
        span_dev[name] = (sum(covered(union, a, b) for a, b in ext) / 1e6
                          if ext else None)
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, n in work:
        if e > lo and s < hi:
            by_op[n] += min(e, hi) - max(s, lo)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    hs = sorted((s, e, n) for s, e, n in host_spans)
    hstarts = [s for s, _, _ in hs]
    idle: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for a, b in gaps(union, lo, hi):
        # the host span open at the gap's start (the program's TimeLog
        # spans do not nest): the last one that began before it
        j = bisect.bisect_right(hstarts, a) - 1
        name = hs[j][2] if j >= 0 and hs[j][1] > a else "no program span"
        idle[name][0] += b - a
        idle[name][1] += 1
    idle_list = sorted(([f"{n} ({int(c)} gaps)", t / 1e6] for n, (t, c) in idle.items()),
                       key=lambda x: -x[1])[:top]
    return dict(busy_s=busy / 1e6, window_s=(hi - lo) / 1e6, span_device_s=span_dev,
                device_ops=[[n[:120], t / 1e6] for n, t in ops], idle_gaps=idle_list)


def reduce_profile(prof, span_names: Sequence[str], window_name: str,
                   top: int = 10) -> Dict:
    """`reduce_events` over a finished torch.profiler.profile whose window
    is the host span `window_name`.  Reads the profiler's raw events
    (kineto_results), not its parsed FunctionEvents, which take minutes
    to build for a window of some million device operations."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    work, dev_spans, host_spans, window = [], [], [], None
    names = set(span_names)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.device_type() == cuda:
            if e.is_user_annotation():
                if name in names:
                    dev_spans.append((s, t, name))
            else:
                work.append((s, t, name))
        elif name == window_name:
            window = (s, t)
        elif name in names:
            host_spans.append((s, t, name))
    if window is None:
        raise RuntimeError(f"the trace holds no span {window_name!r}")
    return reduce_events(work, dev_spans, host_spans, window, span_names, top)
