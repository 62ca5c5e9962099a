"""The port's tracer: `TimeLog`, a pair's seconds by phase, and the spans
and counters of a traced pair.

`twoview.match_images` makes its pair's trace the active one (a context
variable) while the pair runs, so `span` and `count` record into it from
the modules below (`detect/`, `match/`) without being handed it.  Tracing
is on while a torch profiler records, unless the caller says otherwise
(`match_images(trace=)`).

Off: a phase adds the block's host seconds to its field and does nothing
more, and `span` and `count` cost one context-variable lookup.  On: a
phase is a profiler range that ends in a device synchronize, so its
seconds hold the block's device work; a span is a profiler range, timed
on the host and, on CUDA, by a pair of events on the current stream; a
counter sums ints, and 0-d device tensors on the device.
`StepTrace.take_step` reads a step's spans and counters once, after the
step's work has been synchronized."""
from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Union

import torch
from torch.profiler import record_function

PHASES = ("SynthTime", "DetectTime", "OrientTime", "DescTime", "MatchTime",
          "RANSACTime", "MiscTime")

_ACTIVE: ContextVar[Optional["StepTrace"]] = ContextVar("mods_tpu_torch_trace",
                                                        default=None)
_OFF = contextlib.nullcontext()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def tracing(trace: Optional[bool] = None) -> bool:
    """`trace`, or where it is None, whether a torch profiler is recording."""
    return torch.autograd._profiler_enabled() if trace is None else bool(trace)


def active() -> Optional["StepTrace"]:
    """The trace that spans and counters record into; None with tracing off."""
    return _ACTIVE.get()


def span(name: str):
    """A context manager that times its block under `name` in the active
    trace; a no-op where there is none."""
    tr = _ACTIVE.get()
    return _OFF if tr is None else tr.span(name)


def count(name: str, n: Union[int, torch.Tensor]) -> None:
    """Adds `n` (an int, or a 0-d integer tensor summed where it lives) to
    the counter `name` of the active trace; a no-op where there is none."""
    tr = _ACTIVE.get()
    if tr is not None:
        tr.count(name, n)


class StepTrace:
    """The spans and counters of the step under way of a traced pair."""

    def __init__(self, device):
        dev = torch.device(device)
        # the CUDA device on whose current stream span events go, else None
        self.events_on = dev if dev.type == "cuda" else None
        self.spans: Dict[str, list] = {}    # name -> [host s, calls, [(start, end)]]
        self.counts: Dict[str, list] = {}   # name -> [int sum, device sum or None]

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        with record_function(name):
            events = None
            if self.events_on is not None:
                stream = torch.cuda.current_stream(self.events_on)
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
            t0 = time.perf_counter()
            yield
            host = time.perf_counter() - t0
            if events is not None:
                events[1].record(stream)
        rec = self.spans.setdefault(name, [0.0, 0, []])
        rec[0] += host
        rec[1] += 1
        if events is not None:
            rec[2].append(events)

    def count(self, name: str, n: Union[int, torch.Tensor]) -> None:
        rec = self.counts.setdefault(name, [0, None])
        if isinstance(n, torch.Tensor):
            n = n.to(torch.int64)
            rec[1] = n if rec[1] is None else rec[1] + n
        else:
            rec[0] += int(n)

    def take_step(self) -> Dict[str, Dict]:
        """The spans and counters recorded since the last call, as plain
        numbers, and a fresh start for the next step:
        {"spans": {name: {"host_ms", "device_ms", "calls"}},
         "counts": {name: int}}, `device_ms` None off CUDA.  Reads the
        events and the device sums: call it once the step's work has been
        synchronized."""
        def device_ms(events: List) -> Optional[float]:
            if self.events_on is None:
                return None
            return float(sum(a.elapsed_time(b) for a, b in events))

        spans = {name: dict(host_ms=host * 1e3, device_ms=device_ms(events), calls=calls)
                 for name, (host, calls, events) in self.spans.items()}
        counts = {name: n + (int(dev) if dev is not None else 0)
                  for name, (n, dev) in self.counts.items()}
        self.spans, self.counts = {}, {}
        return dict(spans=spans, counts=counts)


@dataclass
class TimeLog:
    """Per-phase wall-clock seconds (reference structures.hpp:33-56).
    `trace`: the phases are profiler spans timed to the end of their
    device work, and `recording` makes a StepTrace active."""
    SynthTime: float = 0.0
    DetectTime: float = 0.0
    OrientTime: float = 0.0
    DescTime: float = 0.0
    MatchTime: float = 0.0
    RANSACTime: float = 0.0
    MiscTime: float = 0.0
    trace: bool = False

    def total(self) -> float:
        return sum(getattr(self, p) for p in PHASES)

    @contextlib.contextmanager
    def phase(self, name: str, device):
        """Adds the wall time of the block to the field `name`.  With `trace`
        on, the block is a profiler span of that name and its time ends
        after the device has finished the block's work."""
        with record_function(name) if self.trace else _OFF:
            t0 = time.perf_counter()
            yield
            if self.trace:
                _sync(device)
            setattr(self, name, getattr(self, name) + time.perf_counter() - t0)

    @contextlib.contextmanager
    def recording(self, device) -> Iterator[Optional[StepTrace]]:
        """While the block runs, the active trace: a new StepTrace on
        `device` (yielded) if `trace` is on, else none (None)."""
        tr = StepTrace(device) if self.trace else None
        token = _ACTIVE.set(tr)
        try:
            yield tr
        finally:
            _ACTIVE.reset(token)
