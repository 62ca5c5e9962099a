"""pyramid_ms, extrema_ms and knn_valid_share on hand-built records: the
program's per-step trace (spans and counters) read into the metrics, and
nothing read where the trace is missing."""
import pytest

from pbcore import spec


def _step(pyr_ms, ext_ms, valid, cells, calls=3):
    span = lambda ms: dict(host_ms=2.0 * (ms or 1.0), device_ms=ms, calls=calls)
    return dict(descriptors1=1, descriptors2=1, trace=dict(
        spans={"DetectTime.pyramid": span(pyr_ms), "DetectTime.extrema": span(ext_ms)},
        counts={"knn.valid_cells": valid, "knn.cells": cells}))


def _record(*pairs, device_trace=True):
    return dict(pairs=[dict(per_step=list(steps), timelog={}) for steps in pairs],
                trace=dict(window_s=1.0, busy_s=0.5, span_device_s={}) if device_trace
                else None, spec={})


def _read(name, rec):
    return spec.metric(name).read(rec)


def test_span_and_counter_arithmetic():
    rec = _record([_step(10.0, 30.0, 6_499 * 26_122, 131_072 ** 2),
                   _step(5.0, 15.0, 100, 400)],
                  [_step(12.0, 20.0, 50, 200)])
    # the mean over pairs of each pair's sum over its steps
    assert _read("pyramid_ms", rec) == pytest.approx((15.0 + 12.0) / 2)
    assert _read("extrema_ms", rec) == pytest.approx((45.0 + 20.0) / 2)
    assert _read("knn_valid_share", rec) == pytest.approx(
        100.0 * (6_499 * 26_122 + 150) / (131_072 ** 2 + 600))
    # one wide pair's step 1 alone: under 1 % of its padded cells
    one = _record([_step(1.0, 1.0, 6_499 * 26_122, 131_072 ** 2)])
    assert _read("knn_valid_share", one) == pytest.approx(0.98815, rel=1e-4)


def test_a_step_without_a_span_adds_nothing():
    step = _step(4.0, 8.0, 10, 20)
    del step["trace"]["spans"]["DetectTime.pyramid"]
    rec = _record([_step(6.0, 2.0, 10, 20), step])
    assert _read("pyramid_ms", rec) == pytest.approx(6.0)
    assert _read("extrema_ms", rec) == pytest.approx(10.0)
    assert _read("knn_valid_share", rec) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["pyramid_ms", "extrema_ms", "knn_valid_share"])
def test_nothing_to_read(name):
    # a program without the tracer: no "trace" key in a step
    untraced = _record([dict(descriptors1=5, descriptors2=7)])
    assert _read(name, untraced) is None
    partly = _record([_step(1.0, 1.0, 1, 2)], [dict(descriptors1=5, descriptors2=7)])
    assert _read(name, partly) is None
    assert _read(name, _record()) is None
    # the CPU: spans without device time, no device trace; no kNN cell computed
    assert _read(name, _record([_step(None, None, 1, 2)], device_trace=False)) is None
    assert _read(name, _record([_step(None, None, 0, 0)])) is None
