"""The whole of a run but the look for a chip, on the CPU at a small size:
sound runs come out correct, and runs whose timed path is broken
underneath come out not correct, once for each fault the cells can have:
on the one-step path of the easy cells, and on the two-step path of
`rootsift.wide`, where step 0 fails and step 1 synthesizes the views."""
import copy

import numpy as np
import pytest
import torch

import run
from pbcore import spec

BENCH = spec.load_benchmark()


WIDE = "rootsift.wide"


def _cell(wl="rootsift.easy"):
    """The cell at 128x160 and 512 keypoints a view; the easy cells' pool
    of 2 pairs on step 0 alone, the wide cell's one pair on its whole
    two-step schedule."""
    w = spec.workload(BENCH, wl)
    s = spec.config(BENCH, w["config"])
    s.update(max_keypoints=512, max_octave_cands=512)
    if wl != WIDE:
        s["schedule"] = s["schedule"][:1]
    traffic = dict(spec.traffic(w["traffic"]), pool=1 if wl == WIDE else 2)
    traffic["params"] = dict(traffic["params"], h=128, w=160)
    return s, traffic, spec.limits(wl)


def _run(fault=None, wl="rootsift.easy", trace=False, before=None):
    """One run; `fault(res)` sees each answer, `before(args, kwargs)` each
    call's arguments (the warm-up pair's too)."""
    from mods_tpu_torch.twoview import match_images
    s, traffic, lim = _cell(wl)

    def match(*a, **k):
        if before is not None:
            a, k = before(a, k)
        res = match_images(*a, **k)
        if fault is not None:
            fault(res)
        return res

    kind = "per_layer" if trace else "end_to_end"
    return run.run_cell(s, traffic, lim, 2 ** 31 + 4321, 0.5, trace, "cpu",
                        spec.cell_metrics(BENCH, wl, kind), match_fn=match)


def _altered_H(res, mp):
    """The answer altered where it is produced."""
    res.H = res.H @ np.diag([1.0, 1.0 + 1e-3, 1.0])


def _wrap_describe(mp, change):
    """Plant `change` under the program's description stage (pipeline)."""
    import mods_tpu_torch.pipeline as pl
    orig = pl.describe_sift_family

    def describe(*a, **k):
        return change(orig(*a, **k))
    mp.setattr(pl, "describe_sift_family", describe)


def _half_rows(res, mp):
    """Half of the batch left out: every other descriptor row of each view
    zeroed where it is made, before matching."""
    def half(d):
        d = d.clone()
        d[1::2] = 0.0
        return d
    _wrap_describe(mp, half)


def _altered_descriptors(res, mp):
    """Every descriptor shifted by one quantization step where it is made."""
    _wrap_describe(mp, lambda d: d + 1.0)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"pairs_per_s", "setup_s", "pair_ms_p90"} <= set(out["metrics"])


def test_traced_run_reads_the_span_metrics():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    # no device trace on the CPU: only the program's spans are read
    assert {"detect_ms", "desc_ms", "match_ms", "verify_ms"} == set(out["metrics"])


@pytest.mark.parametrize("fault", [_altered_H, _half_rows, _altered_descriptors],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    planted = {}

    def after(res):
        if not planted:            # a fault under the stage is planted once,
            planted[0] = True      # after the warm-up pair; the answer's
            fault(res, monkeypatch)     # on every pair
        elif fault is _altered_H:
            fault(res, monkeypatch)
    out = _run(after)
    assert planted and not out["correct"], out["checks"]


def test_pair_that_raises_is_failed():
    calls = []

    def boom(res):
        calls.append(1)
        if len(calls) > 1:          # after the warm-up
            raise RuntimeError("planted")
    out = _run(boom)
    assert out["failed"] >= 1 and not out["correct"]


def test_sound_wide_run_is_correct():
    out = _run(wl=WIDE)
    assert out["correct"], out["checks"]
    assert out["numbers"]["steps"] == 0


def _skip_step1(a, k):
    """The loop stops after step 0 whatever step 0 verified: no view is
    synthesized and no group of views matched."""
    img1, img2, cfg = a[:3]
    cfg = copy.copy(cfg)
    cfg.iters = cfg.iters[:1]
    return (img1, img2, cfg) + tuple(a[3:]), k


def _half_views(mp):
    """Every other synthesized view of a step left out where the views are
    planned, on both images; the identity view stays."""
    import mods_tpu_torch.twoview as tv
    orig = tv.set_vs_pars

    def plan(*a, **k):
        views, prev = orig(*a, **k)
        if len(views) > 1:
            views = views[::2]
        return views, prev
    mp.setattr(tv, "set_vs_pars", plan)


def test_wide_with_step1_skipped_is_not_correct():
    out = _run(wl=WIDE, before=_skip_step1)
    assert not out["correct"], out["checks"]
    assert out["numbers"]["steps"] == 1


def test_wide_with_half_the_views_is_not_correct(monkeypatch):
    _half_views(monkeypatch)
    out = _run(wl=WIDE)
    assert not out["correct"], out["checks"]
    lim = spec.limits(WIDE)["limits"]["rows_changed"]
    assert out["numbers"]["rows_changed"] > 3 * lim, out["numbers"]
