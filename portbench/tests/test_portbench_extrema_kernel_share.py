"""extrema_kernel_share on hand-built records: the program's octave
counters read into the share, and nothing read where the device trace,
the program's trace or its counters are missing."""
import pytest

from pbcore import spec


def _step(octaves=None, kernel=None):
    counts = {"knn.cells": 10 ** 6}
    if octaves is not None:
        counts["detect.octaves"] = octaves
    if kernel is not None:
        counts["detect.octaves.kernel"] = kernel
    spans = {"DetectTime.extrema": dict(host_ms=9.0, device_ms=1.0, calls=12)}
    return dict(trace=dict(spans=spans, counts=counts))


def _record(*pairs, device_trace=True):
    return dict(pairs=[dict(per_step=list(steps), timelog={"DetectTime": 1.0})
                       for steps in pairs],
                trace=dict(window_s=1.0, busy_s=0.5, span_device_s={}) if device_trace
                else None, spec={})


def _read(rec):
    return spec.metric("extrema_kernel_share").read(rec)


def test_share_over_pairs_and_steps():
    rec = _record([_step(12, 12), _step(12, 12)], [_step(12, 12), _step(6, 0)])
    assert _read(rec) == pytest.approx(100.0 * 36 / 42)
    assert _read(_record([_step(12, 12)])) == pytest.approx(100.0)
    assert _read(_record([_step(12, 0)])) == pytest.approx(0.0)
    # a step without detection (a counter absent) adds nothing
    assert _read(_record([_step(12, 12), _step()])) == pytest.approx(100.0)


def test_nothing_to_read():
    assert _read(_record([dict(regions1=5)])) is None          # no tracer
    assert _read(_record([_step(12, 12)], [dict(regions1=5)])) is None
    assert _read(_record()) is None
    assert _read(_record([_step(), _step()])) is None          # the parent's program
    # the CPU: the plain chain by design, no device trace
    assert _read(_record([_step(12, 0)], device_trace=False)) is None
