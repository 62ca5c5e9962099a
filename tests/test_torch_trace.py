"""The port's tracer (`mods_tpu_torch/timelog.py`) on the CPU.

- Off, TimeLog's phases and the spans and counters make no synchronize,
  profiler range or CUDA event call, on a CUDA device too (stubbed here);
  on, they make them.
- match_images on a 96x128 pair, two steps of one detector and one
  descriptor: traced and untraced runs give the same outputs, only the
  traced one has `per_step[i]["trace"]`; its detection spans ran once
  an octave, its kNN counters hold the valid and the padded descriptor
  rows' products; under torch.profiler tracing turns on by itself and
  the profiler holds `DetectTime.pyramid` inside `DetectTime`.
"""
import contextlib

import numpy as np
import pytest
import torch

from mods_tpu_torch import timelog
from mods_tpu_torch.config import Config, detector_step
from mods_tpu_torch.detect import pyramid
from mods_tpu_torch.testing import tilted_pair
from mods_tpu_torch.twoview import match_images

SPANS = ("DetectTime.pyramid", "DetectTime.extrema")
DET, DESC = "HessianAffine", "RootSIFT"


class _DeviceCalls:
    """Stubs for the calls tracing may make on a CUDA device, counted."""

    def __init__(self, monkeypatch):
        self.calls = []
        calls = self.calls

        @contextlib.contextmanager
        def record_function(name):
            calls.append(("record_function", name))
            yield

        class Event:
            def __init__(self, enable_timing=False):
                calls.append(("Event", enable_timing))

            def record(self, stream=None):
                pass

            def elapsed_time(self, end):
                return 2.5

        monkeypatch.setattr(timelog, "record_function", record_function)
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda device=None: calls.append(("synchronize", device)))
        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)


@pytest.mark.parametrize("trace", [False, True])
def test_tracing_off_makes_no_device_calls(monkeypatch, trace):
    calls = _DeviceCalls(monkeypatch)
    tl = timelog.TimeLog(trace=trace)
    dev = torch.device("cuda", 0)
    with tl.recording(dev) as tr:
        with tl.phase("DetectTime", dev):
            with timelog.span("DetectTime.pyramid"):
                timelog.count("knn.cells", 6)
                timelog.count("knn.valid_cells", torch.tensor(2) * torch.tensor(3))
                timelog.count("knn.valid_cells", 1)
        step = tr.take_step() if tr is not None else None
    assert timelog.active() is None and tl.DetectTime > 0
    if not trace:
        assert tr is None and calls.calls == []
        return
    assert sorted(calls.calls, key=str) == [
        ("Event", True), ("Event", True), ("record_function", "DetectTime"),
        ("record_function", "DetectTime.pyramid"), ("synchronize", dev)]
    span = step["spans"].pop("DetectTime.pyramid")
    assert step == dict(spans={}, counts={"knn.cells": 6, "knn.valid_cells": 7})
    assert span["device_ms"] == 2.5 and span["calls"] == 1 and span["host_ms"] > 0
    assert tr.take_step() == dict(spans={}, counts={})


def _config():
    cfg = Config()
    cfg.max_keypoints = cfg.max_octave_cands = 256
    cfg.iters = [detector_step([DET], [1.0], 360.0, DESC),
                 detector_step([DET], [1.0, 2.0], 180.0, DESC)]
    cfg.matching.minMatches = 10 ** 6          # both steps run
    return cfg


@contextlib.contextmanager
def _one_thread():
    """One intra-op thread: the small pair's many small ops otherwise wait on
    every other test process's threads (100x slower beside 5 busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """match_images untraced (with the device calls stubbed), traced, and
    under torch.profiler; the traced run also counts build_octave's calls
    up to each step's end."""
    with _one_thread():
        return _runs()


def _runs():
    cfg = _config()
    img1, img2, _ = tilted_pair(96, 128, 1, 2.0, 0.3)

    def run(**kw):
        return match_images(img1, img2, cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0), **kw)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        calls = _DeviceCalls(mp)
        out["off"] = run(trace=False)
        out["off_calls"] = list(calls.calls)
    octaves, at_step_end = [0], []
    with pytest.MonkeyPatch.context() as mp:
        build = pyramid.build_octave

        def counted(*a, **k):
            octaves[0] += 1
            return build(*a, **k)

        take = timelog.StepTrace.take_step

        def taking(self):
            at_step_end.append(octaves[0])
            return take(self)

        mp.setattr(pyramid, "build_octave", counted)
        mp.setattr(timelog.StepTrace, "take_step", taking)
        out["on"] = run(trace=True)
    out["octaves"] = np.diff([0] + at_step_end).tolist()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out["profiled"] = run()
    out["events"] = [(e.name(), e.start_ns(), e.end_ns())
                     for e in prof.profiler.kineto_results.events()]
    return out


def _untraced(per_step):
    return [{k: v for k, v in s.items() if k != "trace"} for s in per_step]


def test_trace_changes_no_output(runs):
    off, on = runs["off"], runs["on"]
    assert runs["off_calls"] == []
    assert all("trace" not in s for s in off.per_step)
    assert all("trace" in s for s in on.per_step)
    assert off.steps_done == on.steps_done == 2
    assert _untraced(on.per_step) == off.per_step
    np.testing.assert_array_equal(on.H, off.H)
    for a, b in ((off.rep1, on.rep1), (off.rep2, on.rep2)):
        fa, fb = a.get(DET, DESC), b.get(DET, DESC)
        assert len(fa) == len(fb) > 1
        for x, y in zip(fa, fb):
            assert torch.equal(x.desc, y.desc) and torch.equal(x.valid, y.valid)


def test_detection_spans_run_once_an_octave(runs):
    on = runs["on"]
    assert min(runs["octaves"]) > 0 and len(runs["octaves"]) == on.steps_done
    for s, octaves in zip(on.per_step, runs["octaves"]):
        spans = s["trace"]["spans"]
        assert set(spans) == set(SPANS)
        for name in SPANS:
            assert spans[name]["calls"] == octaves
            assert spans[name]["device_ms"] is None and spans[name]["host_ms"] > 0


def test_knn_counters_hold_the_descriptor_counts(runs):
    """`knn.cells`: image 1's padded rows x the columns the kNN keeps,
    image 2's valid rows (`descriptors2`), or k of them where fewer are."""
    on = runs["on"]
    rows1 = [f.n for f in on.rep1.get(DET, DESC)]
    rows2 = [f.n for f in on.rep2.get(DET, DESC)]
    views = [1, len(rows1)]               # step 0: the identity view; step 1: all
    k = _config().matching.knn
    for s, v in zip(on.per_step, views):
        counts = s["trace"]["counts"]
        assert counts["knn.valid_cells"] == s["descriptors1"] * s["descriptors2"] > 0
        kept = max(s["descriptors2"], min(k, sum(rows2[:v])))
        assert counts["knn.cells"] == sum(rows1[:v]) * kept
        assert kept < sum(rows2[:v])
        assert isinstance(counts["knn.cells"], int)
        assert isinstance(counts["knn.valid_cells"], int)


def test_profiler_turns_tracing_on(runs):
    prof = runs["profiled"]
    assert _untraced(prof.per_step) == runs["off"].per_step
    assert all(set(s["trace"]["spans"]) == set(SPANS) for s in prof.per_step)
    ev = runs["events"]
    detect = [(a, b) for n, a, b in ev if n == "DetectTime"]
    pyr = [(a, b) for n, a, b in ev if n == "DetectTime.pyramid"]
    calls = sum(s["trace"]["spans"]["DetectTime.pyramid"]["calls"] for s in prof.per_step)
    assert detect and len(pyr) == calls
    assert all(any(a <= s and e <= b for a, b in detect) for s, e in pyr)
