"""`alldet.wide`: MODS with every detector (configs/mods-alldet.json) on
pairs tilted by 8 (traffic/steep_tilt.json).

On the CPU at a small size where MSER's step fails and step 1 runs: the
program agrees with the reference on every compared number; a traced run
through the harness is correct and reads the detection metrics of the
cell; and each fault of the every-detector path comes out not correct
under the cell's limits: the MSER step skipped, DoG run as Hessian, and
half of Harris-Affine's views left out.  On the card (`-m card`), the same
faults at the cell's own size, 640x800."""
import copy

import pytest

import run
from pbcore import compare, spec
from pbcore.draws import PairDraws
from pbcore.portcfg import build_config

BENCH = spec.load_benchmark()
WL = "alldet.wide"
SEED = 2 ** 31 + 2020
# 96x128 at tilt 4 and 128 keypoints a view: MSER's identity step finds no
# inlier, step 1 runs the three scale-space detectors on 16 views an image
SMALL = dict(h=96, w=128, tilt=4.0)
SMALL_KP = 128
EVERY_DETECTOR = ["MSER", "HessianAffine", "DoG", "HarrisAffine"]
CARD_SEEDS = (2 ** 31 + 81, 2 ** 31 + 82, 2 ** 31 + 83)


def _cell(small=True):
    w = spec.workload(BENCH, WL)
    s = spec.config(BENCH, w["config"])
    t = spec.traffic(w["traffic"])
    if small:
        s.update(max_keypoints=SMALL_KP, max_octave_cands=SMALL_KP)
        t = dict(t, pool=1, params=dict(t["params"], **SMALL))
    return s, t, spec.limits(WL)["limits"]


def _mser_skipped(cfg, mp):
    """The loop starts at step 1: MSER's identity step never runs."""
    cfg = copy.copy(cfg)
    cfg.iters = cfg.iters[1:]
    return cfg


def _dog_as_hessian(cfg, mp):
    """DoG's detector computes the Hessian response and threshold rule."""
    cfg = copy.deepcopy(cfg)
    cfg.dog.pyramid.detector_type = "Hessian"
    return cfg


def _half_harris_views(cfg, mp):
    """Every other view of Harris-Affine's step left out where the views
    are planned, on both images; the other detectors keep all theirs."""
    import mods_tpu_torch.twoview as tv
    extract, plan = tv._extract_detector, tv.set_vs_pars
    current = [None]

    def extract_detector(img, cfg, det_name, *a, **k):
        current[0] = det_name
        return extract(img, cfg, det_name, *a, **k)

    def plan_views(*a, **k):
        views, prev = plan(*a, **k)
        if current[0] == "HarrisAffine" and len(views) > 1:
            views = views[::2]
        return views, prev
    mp.setattr(tv, "_extract_detector", extract_detector)
    mp.setattr(tv, "set_vs_pars", plan_views)
    return cfg


FAULTS = [_mser_skipped, _dog_as_hessian, _half_harris_views]


def _program(img1, img2, cfg, seed, device):
    from mods_tpu_torch.twoview import match_images
    return match_images(img1, img2, cfg, device=device, draws=PairDraws(seed, 0, device))


@pytest.fixture(scope="module")
def small():
    """The small pair, the configuration, and the reference's summary."""
    import reference
    from mods_tpu_torch import config as pcfg
    s, t, lim = _cell()
    img1, img2, H = spec.generator(t["generator"]).make(t["params"], SEED)
    ref = compare.summarize(reference.match_pair(
        img1, img2, s, PairDraws(SEED, 0, "cpu"), "cpu"), s["descriptor"])
    return dict(spec=s, lim=lim, pair=(img1, img2, H), ref=ref,
                cfg=build_config(pcfg, s))


def _numbers(small, res):
    img1, _, H = small["pair"]
    return compare.numbers(compare.summarize(res, small["spec"]["descriptor"]),
                           small["ref"], H, *img1.shape)


def test_small_cell_matches_the_reference(small):
    ref = small["ref"]
    assert ref["steps"] == 2 and ref["per_step"][0]["inliers"] < 15, ref["per_step"]
    img1, img2, _ = small["pair"]
    res = _program(img1, img2, small["cfg"], SEED, "cpu")
    # every detector stored regions, on both images
    for rep in (res.rep1, res.rep2):
        assert sorted(rep.store) == sorted(EVERY_DETECTOR)
        assert all(sum(int(f.count()) for f in rep.get(d, "None")) > 0
                   for d in EVERY_DETECTOR)
    n = _numbers(small, res)
    for name in ("steps", "regions", "tentatives", "rows_changed"):
        assert n[name] == 0.0, n


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(small, fault, monkeypatch):
    img1, img2, _ = small["pair"]
    cfg = fault(small["cfg"], monkeypatch)
    n = _numbers(small, _program(img1, img2, cfg, SEED, "cpu"))
    ok, rows = compare.judge(n, small["lim"])
    assert not ok, rows


def test_traced_small_run_reads_the_detection_metrics():
    s, t, _ = _cell()
    out = run.run_cell(s, t, spec.limits(WL), SEED, 0.1, True, "cpu",
                       spec.cell_metrics(BENCH, WL, "per_layer"))
    assert out["correct"], out["checks"]
    # no device trace on the CPU: the program's spans and counters only
    assert {"mser_ms", "dog_harris_ms", "detect_us_per_region", "detect_ms"} \
        <= set(out["metrics"])
    assert out["metrics"]["detect_us_per_region"]["unit"] == "us/region"


@pytest.mark.card
def test_alldet_faults_fail_on_the_card(card, monkeypatch):
    import reference
    from mods_tpu_torch import config as pcfg
    s, t, lim = _cell(small=False)
    gen = spec.generator(t["generator"])
    cfg = build_config(pcfg, s)
    for seed in CARD_SEEDS:
        img1, img2, H = gen.make(t["params"], seed)
        ref = compare.summarize(reference.match_pair(
            img1, img2, s, PairDraws(seed, 0, card), card), s["descriptor"])
        for fault in [None] + FAULTS:
            with monkeypatch.context() as mp:
                c = cfg if fault is None else fault(cfg, mp)
                for _ in range(2):     # the second call is judged, as in a run
                    res = _program(img1, img2, c, seed, card)
            ok, rows = compare.judge(compare.numbers(
                compare.summarize(res, s["descriptor"]), ref, H, *img1.shape), lim)
            assert ok == (fault is None), (seed, fault, rows)
