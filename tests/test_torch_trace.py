"""The port's tracer (`mods_tpu_torch/timelog.py`) on the CPU.

- Off, TimeLog's phases and the spans and counters make no synchronize,
  profiler range or CUDA event call, on a CUDA device too (stubbed here);
  on, they make them.
- match_images on a 96x128 pair, two steps of one detector and one
  descriptor: traced and untraced runs give the same outputs, only the
  traced one has `per_step[i]["trace"]`; its detection spans ran once
  an octave, `detect.octaves` counts them and `detect.octaves.kernel`
  none (the extrema kernels run on the card alone), its kNN counters
  hold the valid and the padded descriptor rows' products; under torch.profiler tracing turns on by itself and
  the profiler holds `DetectTime.pyramid` inside `DetectTime`.
- match_images on the same pair with the every-detector schedule (MSER,
  then Hessian-Affine, DoG and Harris-Affine on 16 views): one
  `Detector.<name>` span a detector and an image, `DetectTime.mser` once
  an MSER view, `detect.regions.<name>` the regions each detector stored,
  `match.tentatives.<name>` what the concatenation before RANSAC took of
  each detector's group; untraced, no counter is computed and no device
  call made.
"""
import contextlib

import numpy as np
import pytest
import torch

from mods_tpu_torch import timelog, twoview
from mods_tpu_torch.config import Config, detector_step
from mods_tpu_torch.detect import pyramid
from mods_tpu_torch.testing import (mods_all_detectors_schedule, mods_detectors_config,
                                    tilted_pair)
from mods_tpu_torch.twoview import match_images

SPANS = ("DetectTime.pyramid", "DetectTime.extrema")
DET, DESC = "HessianAffine", "RootSIFT"
STEP_SPANS = set(SPANS) | {f"Detector.{DET}"}
ALL_DETECTORS = ("MSER", "HessianAffine", "DoG", "HarrisAffine")


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
        assert set(spans) == STEP_SPANS
        for name in SPANS:
            assert spans[name]["calls"] == octaves
            assert spans[name]["device_ms"] is None and spans[name]["host_ms"] > 0


def test_octave_counters_count_every_octave(runs):
    """`detect.octaves` adds one an octave; on the CPU no octave goes
    through the extrema kernels, so `detect.octaves.kernel` stays 0."""
    on = runs["on"]
    for s, octaves in zip(on.per_step, runs["octaves"]):
        counts = s["trace"]["counts"]
        assert counts["detect.octaves"] == octaves > 0
        assert counts["detect.octaves.kernel"] == 0


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
    assert all(set(s["trace"]["spans"]) == STEP_SPANS for s in prof.per_step)
    ev = runs["events"]
    detect = [(a, b) for n, a, b in ev if n == "DetectTime"]
    pyr = [(a, b) for n, a, b in ev if n == "DetectTime.pyramid"]
    calls = sum(s["trace"]["spans"]["DetectTime.pyramid"]["calls"] for s in prof.per_step)
    assert detect and len(pyr) == calls
    assert all(any(a <= s and e <= b for a, b in detect) for s, e in pyr)


def _alldet_config():
    """The every-detector MODS schedule: step 0 MSER on the identity view,
    step 1 Hessian-Affine, DoG and Harris-Affine on tilts 1, 2 and 4 at
    Phi 72 (16 views an image), each matched in a group of its own.  At 32
    keypoints a view and without Baumberg, so that a run takes seconds on
    one thread; both steps run."""
    cfg = mods_detectors_config()
    cfg.max_keypoints = cfg.max_octave_cands = 32
    for det in (cfg.hessian, cfg.dog, cfg.harris):
        det.affine.doBaumberg = False
    cfg.iters = mods_all_detectors_schedule(DESC)
    cfg.matching.minMatches = 10 ** 6
    return cfg


@pytest.fixture(scope="module")
def alldet_runs():
    """The every-detector schedule untraced (device calls stubbed, the
    counters' calls recorded) and traced (MSER's host calls counted up to
    each step's end)."""
    with _one_thread():
        return _alldet_runs()


def _alldet_runs():
    cfg = _alldet_config()
    img1, img2, _ = tilted_pair(96, 128, 1, 2.0, 0.3)

    def run(**kw):
        return match_images(img1, img2, cfg, device="cpu",
                            generator=torch.Generator().manual_seed(0), **kw)

    out = {"cfg": cfg}
    with pytest.MonkeyPatch.context() as mp:
        calls = _DeviceCalls(mp)
        mp.setattr(timelog, "count", lambda *a: calls.calls.append(("count",) + a))
        out["off"] = run(trace=False)
        out["off_calls"] = list(calls.calls)
    mser, at_step_end = [0], []
    with pytest.MonkeyPatch.context() as mp:
        detect = twoview.detect_mser

        def counted(*a, **k):
            mser[0] += 1
            return detect(*a, **k)

        take = timelog.StepTrace.take_step

        def taking(self):
            at_step_end.append(mser[0])
            return take(self)

        mp.setattr(twoview, "detect_mser", counted)
        mp.setattr(timelog.StepTrace, "take_step", taking)
        out["on"] = run(trace=True)
    out["mser_views"] = np.diff([0] + at_step_end).tolist()
    return out


def test_alldet_trace_changes_no_output(alldet_runs):
    off, on = alldet_runs["off"], alldet_runs["on"]
    assert off.steps_done == on.steps_done == 2
    assert _untraced(on.per_step) == off.per_step
    np.testing.assert_array_equal(on.H, off.H)
    for a, b in ((off.rep1, on.rep1), (off.rep2, on.rep2)):
        assert list(a.store) == list(b.store) == list(ALL_DETECTORS)
        for det in ALL_DETECTORS:
            fa, fb = a.get(det, DESC), b.get(det, DESC)
            assert len(fa) == len(fb) > 0
            for x, y in zip(fa, fb):
                assert torch.equal(x.desc, y.desc) and torch.equal(x.valid, y.valid)


def test_alldet_untraced_makes_no_device_calls(alldet_runs):
    """Off, no synchronize, profiler range or CUDA event, and no counter's
    argument computed."""
    assert alldet_runs["off_calls"] == []
    assert all("trace" not in s for s in alldet_runs["off"].per_step)


def test_alldet_detector_spans_follow_the_schedule(alldet_runs):
    on, cfg = alldet_runs["on"], alldet_runs["cfg"]
    for s, step in zip(on.per_step, cfg.iters):
        spans = s["trace"]["spans"]
        detectors = {n: sp for n, sp in spans.items() if n.startswith("Detector.")}
        assert set(detectors) == {f"Detector.{d}" for d in step.detectors}
        for sp in detectors.values():       # one extraction a detector and an image
            assert sp["calls"] == 2 and sp["host_ms"] > 0 and sp["device_ms"] is None
    # the scale-space detectors' spans open in step 1 alone
    assert set(on.per_step[0]["trace"]["spans"]) == {"Detector.MSER", "DetectTime.mser"}
    assert set(SPANS) < set(on.per_step[1]["trace"]["spans"])


def test_alldet_mser_span_once_a_view(alldet_runs):
    on = alldet_runs["on"]
    assert alldet_runs["mser_views"] == [2, 0]      # the identity view of each image
    for s, views in zip(on.per_step, alldet_runs["mser_views"]):
        span = s["trace"]["spans"].get("DetectTime.mser")
        assert (span["calls"] if span else 0) == views


def test_alldet_region_counters_hold_the_stores(alldet_runs):
    on, cfg = alldet_runs["on"], alldet_runs["cfg"]
    counts = [s["trace"]["counts"] for s in on.per_step]
    for det in ALL_DETECTORS:
        stored = sum(int(f.count()) for rep in (on.rep1, on.rep2)
                     for f in rep.get(det, "None"))
        counted = [c.get(f"detect.regions.{det}", 0) for c in counts]
        assert sum(counted) == stored > 0
        assert [n > 0 for n in counted] == [det in st.detectors for st in cfg.iters]
    regions = [0] + [s["regions1"] + s["regions2"] for s in on.per_step]
    for i, c in enumerate(counts):
        added = sum(n for k, n in c.items() if k.startswith("detect.regions."))
        assert added == regions[i + 1] - regions[i]
        assert all(isinstance(n, int) for n in c.values())


def test_alldet_tentative_counters_sum_to_the_tentatives(alldet_runs):
    """Each detector's group as the concatenation before the duplicate
    filter takes it; MSER's group of step 0 stays in the bank in step 1."""
    on = alldet_runs["on"]
    names = [{"MSER"}, set(ALL_DETECTORS)]
    for s, want in zip(on.per_step, names):
        tents = {k[len("match.tentatives."):]: n for k, n in s["trace"]["counts"].items()
                 if k.startswith("match.tentatives.")}
        assert set(tents) == want
        assert sum(tents.values()) == s["tentatives"] > 0
    assert (on.per_step[0]["trace"]["counts"]["match.tentatives.MSER"]
            == on.per_step[1]["trace"]["counts"]["match.tentatives.MSER"])
