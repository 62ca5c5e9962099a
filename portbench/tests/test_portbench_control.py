"""On the card: the lower-precision control (the reference with TF32 on,
one precision below the configurations' float32) put in the program's
place fails the cell's limits, and the program passes them, on the cell's
own pairs and sizes; and the faults of the two-step path (step 1 skipped,
half the synthesized views left out) fail `rootsift.wide`'s limits at its
own size.  `python -m pytest portbench/tests -m card` on the chip;
skipped without a CUDA device."""
import copy

import pytest

from pbcore import compare, spec
from pbcore.draws import PairDraws
from pbcore.pairs import pool_seeds, sampled_index
from pbcore.portcfg import build_config

BENCH = spec.load_benchmark()
SEEDS = (2 ** 31 + 71, 2 ** 31 + 72, 2 ** 31 + 73)


def _judged(wl, seed):
    w = spec.workload(BENCH, wl)
    s = spec.config(BENCH, w["config"])
    t = spec.traffic(w["traffic"])
    gen = spec.generator(t["generator"])
    seeds = pool_seeds(seed, int(t["pool"]))
    return s, gen.make(t["params"], seeds[sampled_index(seed, len(seeds))])


@pytest.mark.card
@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_and_program_passes(card, wl):
    import reference
    from mods_tpu_torch import config as pcfg
    from mods_tpu_torch.twoview import match_images
    lim = spec.limits(wl)["limits"]
    for seed in SEEDS:
        s, (img1, img2, H) = _judged(wl, seed)
        h, w = img1.shape
        ref = compare.summarize(reference.match_pair(
            img1, img2, s, PairDraws(seed, 0, card), card), s["descriptor"])
        ctl = compare.summarize(reference.match_pair(
            img1, img2, s, PairDraws(seed, 0, card), card, tf32=True), s["descriptor"])
        ok, rows = compare.judge(compare.numbers(ctl, ref, H, h, w), lim)
        assert not ok, rows
        cfg = build_config(pcfg, s)
        for _ in range(2):     # the second call is judged, as in a run
            res = match_images(img1, img2, cfg, device=card,
                               draws=PairDraws(seed, 0, card))
        prog = compare.summarize(res, s["descriptor"])
        ok, rows = compare.judge(compare.numbers(prog, ref, H, h, w), lim)
        assert ok, rows


@pytest.mark.card
def test_wide_faults_fail_on_the_card(card, monkeypatch):
    import reference
    import mods_tpu_torch.twoview as tv
    from mods_tpu_torch import config as pcfg
    wl = "rootsift.wide"
    lim = spec.limits(wl)["limits"]
    orig = tv.set_vs_pars

    def half(*a, **k):
        views, prev = orig(*a, **k)
        return (views[::2] if len(views) > 1 else views), prev
    for seed in SEEDS:
        s, (img1, img2, H) = _judged(wl, seed)
        h, w = img1.shape
        ref = compare.summarize(reference.match_pair(
            img1, img2, s, PairDraws(seed, 0, card), card), s["descriptor"])
        cfg = build_config(pcfg, s)
        skipped = copy.copy(cfg)
        skipped.iters = cfg.iters[:1]
        for c, plan, sound in ((cfg, orig, True), (skipped, orig, False), (cfg, half, False)):
            monkeypatch.setattr(tv, "set_vs_pars", plan)
            for _ in range(2):     # the second call is judged, as in a run
                res = tv.match_images(img1, img2, c, device=card,
                                      draws=PairDraws(seed, 0, card))
            ok, rows = compare.judge(compare.numbers(
                compare.summarize(res, s["descriptor"]), ref, H, h, w), lim)
            assert ok == sound, rows
