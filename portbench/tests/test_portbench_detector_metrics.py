"""mser_ms, dog_harris_ms and detect_us_per_region on hand-built records:
the program's per-step spans and counters read into the metrics, and
nothing read where the trace or the program's span or counter is
missing."""
import pytest

from pbcore import spec

NAMES = ["mser_ms", "dog_harris_ms", "detect_us_per_region"]


def _step(mser=None, dog=None, harris=None, regions=None):
    spans = {}
    for name, ms in (("DetectTime.mser", mser), ("Detector.DoG", dog),
                     ("Detector.HarrisAffine", harris)):
        if ms is not None:
            spans[name] = dict(host_ms=ms, device_ms=None, calls=2)
    spans["DetectTime.pyramid"] = dict(host_ms=99.0, device_ms=1.0, calls=4)
    counts = {f"detect.regions.{d}": n for d, n in (regions or {}).items()}
    counts["knn.cells"] = 10 ** 6
    return dict(trace=dict(spans=spans, counts=counts))


def _pair(detect_s, *steps):
    return dict(per_step=list(steps), timelog={"DetectTime": detect_s})


def _record(*pairs):
    return dict(pairs=list(pairs), trace=None, spec={})


def _read(name, rec):
    return spec.metric(name).read(rec)


def test_span_and_counter_arithmetic():
    rec = _record(
        _pair(2.0, _step(mser=30.0, regions={"MSER": 100}),
              _step(dog=400.0, harris=600.0,
                    regions={"HessianAffine": 5000, "DoG": 1000, "HarrisAffine": 3900})),
        _pair(1.0, _step(mser=10.0, regions={"MSER": 0}),
              _step(dog=200.0, harris=300.0, regions={"DoG": 2000})))
    # the mean over pairs of each pair's sum over its steps
    assert _read("mser_ms", rec) == pytest.approx((30.0 + 10.0) / 2)
    assert _read("dog_harris_ms", rec) == pytest.approx((1000.0 + 500.0) / 2)
    # DetectTime's seconds over every detector's regions, both pairs
    assert _read("detect_us_per_region", rec) == pytest.approx(3.0e6 / 12_000)


def test_a_step_without_the_span_adds_nothing():
    rec = _record(_pair(1.0, _step(mser=8.0, regions={"MSER": 50}),
                        _step(dog=100.0, regions={"DoG": 150})))
    assert _read("mser_ms", rec) == pytest.approx(8.0)
    assert _read("dog_harris_ms", rec) == pytest.approx(100.0)
    assert _read("detect_us_per_region", rec) == pytest.approx(1e6 / 200)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    # a program without the tracer: no "trace" key in a step
    untraced = _record(_pair(1.0, dict(regions1=5)))
    assert _read(name, untraced) is None
    partly = _record(_pair(1.0, _step(1.0, 1.0, 1.0, {"MSER": 3})),
                     _pair(1.0, dict(regions1=5)))
    assert _read(name, partly) is None
    assert _read(name, _record()) is None
    # traced, but a program without these spans and counters (the parent's)
    assert _read(name, _record(_pair(1.0, _step(), _step()))) is None
