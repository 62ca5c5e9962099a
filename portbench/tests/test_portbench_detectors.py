"""The harness takes the port's other detectors and DEGENSAC, on the CPU
at a small size: a schedule types DoG and Harris on the program's and the
reference's configuration alike (and the two configuration files build
what they built before); the reference carries MSER, Hessian-Affine, DoG,
Harris-Affine and LO-RANSAC-F as the program runs them; `F_gap_px` judges
a fundamental matrix; a program that runs DoG as Hessian fails; and
importing the reference builds nothing."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import run
from pbcore import compare, pairs, spec
from pbcore.draws import PairDraws
from pbcore.portcfg import ROOT, build_config

BENCH = spec.load_benchmark()
PB = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 1907
EVERY_DETECTOR = ["MSER", "HessianAffine", "DoG", "HarrisAffine"]


def _cfgmods():
    from mods_tpu_torch import config as pcfg
    from reference.mods import config as rcfg
    return {"program": pcfg, "reference": rcfg}


def _build_before(cfgmod, s):
    """build_config as it was before a schedule typed DoG and Harris."""
    cfg = cfgmod.Config()
    cfg.max_keypoints = int(s["max_keypoints"])
    cfg.max_octave_cands = int(s["max_octave_cands"])
    cfg.matching.minMatches = int(s["min_matches"])
    cfg.matching.knn = int(s["knn"])
    desc = s["descriptor"]
    steps = []
    for st in s["schedule"]:
        step = cfgmod.detector_step(st["detectors"], [float(t) for t in st["tilts"]],
                                    float(st["phi"]), desc)
        for det in st["detectors"]:
            step.detectors[det]["fginn"][desc] = float(s["fginn"])
        steps.append(step)
    cfg.iters = steps
    if s.get("weights"):
        cfg.hardnet.weights = str(ROOT / s["weights"])
    return cfg


@pytest.mark.parametrize("side", ["program", "reference"])
@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_existing_configurations_build_as_before(name, side):
    cfgmod = _cfgmods()[side]
    s = spec.config(BENCH, name)
    cfg = build_config(cfgmod, s)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(_build_before(cfgmod, s))
    assert cfg.dog.pyramid.detector_type == cfg.harris.pyramid.detector_type == "Hessian"
    if side == "program":
        assert cfgmod.to_dict(cfg) == cfgmod.to_dict(_build_before(cfgmod, s))


@pytest.mark.parametrize("side", ["program", "reference"])
def test_schedule_types_dog_and_harris(side):
    cfgmod = _cfgmods()[side]
    s = spec.config(BENCH, "hessaff-rootsift")
    s["schedule"] = [dict(detectors=["MSER"], tilts=[1.0], phi=360.0),
                     dict(detectors=["HessianAffine", "DoG", "HarrisAffine"],
                          tilts=[1.0, 2.0, 4.0], phi=72.0)]
    cfg = build_config(cfgmod, s)
    assert cfg.hessian.pyramid.detector_type == "Hessian"
    assert cfg.dog.pyramid.detector_type == "DoG"
    assert cfg.harris.pyramid.detector_type == "Harris"
    # everything else as Config() has it
    base = build_config(cfgmod, dict(s, schedule=[]))
    for field in ("hessian", "mser", "domori", "matching", "ransac", "filtering"):
        assert getattr(cfg, field) == getattr(base, field), field
    assert dataclasses.replace(cfg.dog.pyramid, detector_type="Hessian") == base.dog.pyramid
    assert dataclasses.replace(cfg.harris.pyramid, detector_type="Hessian") == base.harris.pyramid


def _spec(schedule, ver_type="LORANSAC"):
    s = spec.config(BENCH, "hessaff-rootsift")
    s.update(max_keypoints=512, max_octave_cands=512, schedule=schedule, ver_type=ver_type)
    return s


def _both(s, img1, img2, seed=SEED):
    """The program's and the reference's summaries of one pair on the CPU,
    with the same configuration file and the same draws."""
    import reference
    from mods_tpu_torch import config as pcfg
    from mods_tpu_torch.twoview import match_images
    res = match_images(img1, img2, build_config(pcfg, s), device="cpu", ver_type=s["ver_type"],
                       draws=PairDraws(seed, 0, "cpu"))
    ref = reference.match_pair(img1, img2, s, PairDraws(seed, 0, "cpu"), "cpu")
    return (compare.summarize(res, s["descriptor"]),
            compare.summarize(ref, s["descriptor"]))


def test_every_detector_matches_the_reference():
    s = _spec([dict(detectors=EVERY_DETECTOR, tilts=[1.0], phi=360.0)])
    img1, img2, H = pairs.warp_pair(160, 200, 5)
    prog, ref = _both(s, img1, img2)
    # every detector ran, on both sides, and found regions
    assert len(ref["images"][0]) == len(EVERY_DETECTOR)
    assert all(int(st["valid"].sum()) > 0 for st in ref["images"][0])
    n = compare.numbers(prog, ref, H, 160, 200)
    assert ref["inliers"] >= 15
    for name in ("steps", "regions", "tentatives", "rows_changed"):
        assert n[name] == 0.0, n
    assert "F_gap_px" not in n


def test_loransacf_matches_the_reference():
    from mods_tpu_torch.testing import two_plane_pair
    s = _spec([dict(detectors=["HessianAffine"], tilts=[1.0], phi=360.0)], "LORANSACF")
    img1, img2, F, _ = two_plane_pair(160, 200, 3)
    prog, ref = _both(s, img1, img2)
    n = compare.numbers(prog, ref, np.eye(3), 160, 200, ver_type="LORANSACF")
    assert ref["inliers"] >= 15 and n["steps"] == 0.0, n
    assert n["F_gap_px"] < 1e-3, n
    # the reference's inliers lie on the scene's true F
    assert np.median(compare.epipolar_px(F, ref["inlier_xy"])) < 1.0
    # an F altered where it is produced is seen
    prog["H"] = prog["H"] @ np.diag([1.0, 1.0 + 1e-2, 1.0])
    assert compare.numbers(prog, ref, np.eye(3), 160, 200,
                           ver_type="LORANSACF")["F_gap_px"] > 0.05


def test_f_gap_when_a_side_verifies_nothing():
    xy = np.array([[10.0, 20.0, 12.0, 21.0]])
    F = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])  # y2 = y1
    assert compare.epipolar_px(F, xy) == pytest.approx([1.0])
    none = dict(inliers=0, H=F, inlier_xy=np.zeros((0, 4)))
    some = dict(inliers=1, H=F, inlier_xy=xy)
    assert compare.f_gap_px(none, none) == 0.0
    assert compare.f_gap_px(none, some) == float("inf")
    assert compare.f_gap_px(some, none) == float("inf")
    assert compare.f_gap_px(some, some) == 0.0
    F_off = F + np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 3.0]])  # y2 = y1 + 3
    assert compare.f_gap_px(dict(some, H=F_off), some) == pytest.approx(1.0)
    assert compare.f_gap_px(dict(some, H=np.full((3, 3), np.nan)), some) == float("inf")


def test_dog_run_as_hessian_is_not_correct():
    s = _spec([dict(detectors=["DoG"], tilts=[1.0], phi=360.0)])
    traffic = dict(spec.traffic("mild_warp"), pool=1)
    traffic["params"] = dict(traffic["params"], h=160, w=200)
    limits = {"limits": {"steps": 0, "rows_changed": 0.04}}
    metrics = spec.cell_metrics(BENCH, "rootsift.easy", "end_to_end")
    from mods_tpu_torch.twoview import match_images

    def faulty(img1, img2, cfg, **k):
        cfg.dog.pyramid.detector_type = "Hessian"     # the program's DoG fault
        return match_images(img1, img2, cfg, **k)
    sound = run.run_cell(s, traffic, limits, SEED, 0.1, False, "cpu", metrics)
    assert sound["correct"], sound["checks"]
    out = run.run_cell(s, traffic, limits, SEED, 0.1, False, "cpu", metrics,
                       match_fn=faulty)
    assert not out["correct"], out["checks"]
    assert max(out["numbers"]["regions"], out["numbers"]["rows_changed"]) > 0.5, out["numbers"]


def test_importing_the_reference_builds_nothing():
    """Set-up counts the imports: the reference's MSER library is built at
    its first call, never at import."""
    code = (f"import sys, subprocess\nsys.path[:0] = [{str(PB.parent)!r}, {str(PB)!r}]\n"
            "calls = []\n"
            "subprocess.run = subprocess.Popen = lambda *a, **k: calls.append(a)\n"
            "import reference\nfrom reference.mods import twoview\n"
            "from reference.mods.detect import mser\n"
            "import ctypes\nprint(len(calls), mser._lib is None)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0", "True"]


def test_reference_mser_source_is_its_own():
    from reference.mods.detect import mser
    assert mser.SOURCE == PB / "reference" / "native" / "mser.cpp"
    assert mser.BUILD_DIR == ROOT / ".pbcache" / "reference_build"
    assert "mods_tpu" not in mser.SOURCE.read_text()
