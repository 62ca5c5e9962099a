"""The MODS loop of the port with every detector of the MODS schedules
(MSER, ReadAffs, DoG and iiDoG, Harris-Affine, Baumberg's Hessian
method) against the JAX package.

match_images on the CPU, one identity-view step a run, on a 128x160 pair
warped by a known homography, at 256 keypoints: the JAX package with
patch_source "engine" and its TPU route's detection
(`tpu_route_detection`), the port with the JAX package's RANSAC draws
(`JaxDraws`).  Two runs cover every detector and option, so that the JAX
package's loop compiles as little as it can:

- "separate": MSER, ReadAffs and DoG (iiDoG off, Baumberg's SMM), each
  matched on its own;
- "iidog_grouped": DoG with iiDoG and Baumberg's Hessian method, and
  Harris-Affine (SMM), matched as one group.

Each detector's regions and descriptors on each image within 1 %, and the
run's counts within the envelope of PERF.md section 2: n1, n2 within 1 %,
tentatives within 2 %, inliers within max(2, 3 %).  MSER's padded capacity
is cut from 4096 rows to 256 in both packages (the pair has fewer than 100
regions an image; the JAX package's MSER step over 4096 padded rows takes
minutes on the CPU).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu.detect import mser as jmser
from mods_tpu.synth import atlas as jatlas
from mods_tpu.twoview import match_images as jmatch_images
from mods_tpu_torch import config as tconfig
from mods_tpu_torch import twoview
from mods_tpu_torch.detect import detector as tdet
from mods_tpu_torch.detect import mser as tmser
from mods_tpu_torch.io import keys as tkeys
from mods_tpu_torch.synth import atlas as tatlas
from mods_tpu_torch.synth import vs as tvs
from mods_tpu_torch.testing import (detector_step, mods_all_detectors_schedule,
                                    mods_detectors_config, textured_image, tilted_pair,
                                    warp_pair)
from mods_tpu_torch.types import Features
from torch_parity_helpers import JaxDraws, tpu_route_detection

MAX_KP = 256


def _iidog_hessian_method(c):
    c.dog.pyramid.iiDoGMode = True
    c.dog.affine.method = "Hessian"


# run -> (detectors, matched as a group, change to Config())
RUNS = {
    "separate": (["MSER", "ReadAffs", "DoG"], False, None),
    "iidog_grouped": (["DoG", "HarrisAffine"], True, _iidog_hessian_method),
}
DETECTOR_CASES = [(run, det) for run, (dets, _, _) in RUNS.items() for det in dets]


def _configs(run, affs_fname=""):
    dets, group, change = RUNS[run]
    jcfg = jconfig.Config()
    jcfg.max_keypoints = jcfg.max_octave_cands = MAX_KP
    jcfg.patch_source = "engine"
    jcfg.dog.pyramid.detector_type = "DoG"
    jcfg.harris.pyramid.detector_type = "Harris"
    jcfg.matching.FGINNThreshold = {"RootSIFT": 0.8}
    jcfg.read_affs_fname = affs_fname
    if change is not None:
        change(jcfg)
    cfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    cfg.iters = [detector_step(dets, [1.0], 360.0, group=group)]
    jcfg.iters = [jconfig.IterationStep(**dataclasses.asdict(s)) for s in cfg.iters]
    return jcfg, cfg


def _counts(r):
    return dict(steps=r.steps_done, regions1=r.regions1, regions2=r.regions2,
                n1=r.descriptors1, n2=r.descriptors2, tentatives=r.tentatives,
                inliers=r.inliers)


def _detector_counts(r, det):
    """Regions and RootSIFT descriptors of one detector on each image."""
    return [sum(int(f.count()) for f in rep.get(det, desc))
            for rep in (r.rep1, r.rep2) for desc in ("None", "RootSIFT")]


def assert_envelope(t, j):
    assert t["steps"] == j["steps"], (t, j)
    for k in ("regions1", "regions2", "n1", "n2"):
        assert abs(t[k] - j[k]) <= 0.01 * j[k], (k, t, j)
    assert abs(t["tentatives"] - j["tentatives"]) <= 0.02 * j["tentatives"], (t, j)
    assert abs(t["inliers"] - j["inliers"]) <= max(2, 0.03 * j["inliers"]), (t, j)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path on one intra-op thread while this module runs:
    the suite runs several workers on a few cores, and intra-op threads
    here would contend with theirs for small tensors' sake."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def mser_capacity():
    """detect_mser at MAX_KP rows in both packages' loops."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jmser, "detect_mser",
               functools.partial(jmser.detect_mser, max_regions=MAX_KP))
    mp.setattr(twoview, "detect_mser",
               functools.partial(tmser.detect_mser, max_regions=MAX_KP))
    yield
    mp.undo()


def _pair():
    return warp_pair(128, 160, 3)


@pytest.fixture(scope="module")
def affs_fname(tmp_path_factory):
    """ReadAffs' files, written by the port's io.keys: each image's
    Hessian-Affine frames (the port's detection on the CPU), as npz."""
    d = tmp_path_factory.mktemp("affs")
    cfg = mods_detectors_config()
    for name, img in zip(("img1", "img2"), _pair()[:2]):
        kp = tdet.detect_keypoints(torch.from_numpy(img), cfg.hessian, MAX_KP, MAX_KP)
        tkeys.save_npz(str(d / f"{name}.npz"),
                       Features(det=kp, reproj=kp, desc=torch.zeros(kp.n, 128)))
    return str(d / "{name}.npz")


@pytest.fixture(scope="module")
def runs(affs_fname):
    """Every run through the JAX package's loop and the port's, once:
    {run: (JAX result, port result)}."""
    img1, img2, _ = _pair()
    mp = pytest.MonkeyPatch()
    tpu_route_detection(mp)
    try:
        jax_results = {run: jmatch_images(img1, img2, _configs(run, affs_fname)[0])
                       for run in RUNS}
    finally:
        mp.undo()
    out = {}
    for run in RUNS:
        cfg = _configs(run, affs_fname)[1]
        out[run] = (jax_results[run],
                    twoview.match_images(img1, img2, cfg, device="cpu",
                                         draws=JaxDraws(cfg.ransac.seed)))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_one_step_matches_jax(run, runs):
    j, t = runs[run]
    assert_envelope(_counts(t), _counts(j))
    assert t.steps_done == 1 and t.inliers >= 15
    assert sorted(t.rep1.store) == sorted(t.rep2.store) == sorted(RUNS[run][0])


@pytest.mark.parametrize("run, det", DETECTOR_CASES)
def test_detector_counts_match_jax(run, det, runs):
    j, t = runs[run]
    tc, jc = _detector_counts(t, det), _detector_counts(j, det)
    assert min(tc) > 0, (det, tc)
    for a, b in zip(tc, jc):
        assert abs(a - b) <= 0.01 * b, (det, tc, jc)


def test_read_affs_reads_the_identity_view_only(affs_fname):
    """ReadAffs' frames are in the image's frame: a tilted view gets none,
    and the identity view at most every row of the file."""
    _, cfg = _configs("separate", affs_fname)
    cfg.iters = [detector_step(["ReadAffs"], [1.0, 2.0], 72.0)]
    img1, img2, _ = _pair()
    r = twoview.match_images(img1, img2, cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    for name, rep in (("img1", r.rep1), ("img2", r.rep2)):
        assert len(rep.get("ReadAffs", "None")) == 1
        n_file = int(tkeys.load_affs(affs_fname.replace("{name}", name),
                                     device="cpu").count())
        assert 0 < int(rep.get("ReadAffs", "None")[0].count()) <= n_file


def test_all_detectors_schedule_runs():
    """The iters_MODS-shaped schedule of testing.py (an MSER step, then
    Hessian-Affine, DoG and Harris-Affine on 15 tilted views each) on a
    96x128 tilted pair: both steps run, every detector finds regions on
    both images, the scale-space detectors' step goes through the atlas."""
    cfg = mods_detectors_config()
    cfg.max_keypoints = cfg.max_octave_cands = MAX_KP
    cfg.patch_source = "engine"
    cfg.iters = mods_all_detectors_schedule()
    img1, img2, _ = tilted_pair(96, 128, 2, 3.0, 0.3)
    r = twoview.match_images(img1, img2, cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert r.steps_done == 2 and len(r.per_step) == 2
    for rep in (r.rep1, r.rep2):
        assert sorted(rep.store) == ["DoG", "HarrisAffine", "HessianAffine", "MSER"]
        for det in rep.store:
            assert sum(int(f.count()) for f in rep.get(det, "None")) > 0, det
        # one atlas a scale-space detector (one Features), MSER's one view
        assert all(len(rep.get(d, "RootSIFT")) == 1 for d in rep.store)
    s0, s1 = r.per_step
    assert s1["regions1"] > s0["regions1"] > 0 and s1["tentatives"] >= s0["tentatives"]
    assert r.H.shape == (3, 3) and np.isfinite(r.H).all()


def test_extract_step_atlas_matches(monkeypatch):
    """A tilted step's 15 views of an 80x96 image through one DoG atlas, as
    the JAX package's atlas takes it (every scale-space detector takes the
    same path, by its parameters): the same valid regions and described
    rows, at the same atlas positions within 5e-3 px (as for Hessian-Affine
    in test_torch_pipeline.py)."""
    det = "DoG"
    jcfg, cfg = _configs("separate")
    s = detector_step([det], [1.0, 2.0, 4.0], 72.0).detectors[det]
    args = (s["scale_set"], s["tilt_set"], s["phi"], s["descriptors"], s["fginn"],
            s["dist"], s["init_sigma"], s["do_blur"])
    views, _ = tvs.set_vs_pars(*args, tvs.set_vs_pars(*args[:1], [1.0], *args[2:],
                                                      [])[0])
    assert len(views) == 15 and tatlas.atlas_eligible(cfg, det, views, "cpu")
    img = textured_image(80, 96, 10)
    tpu_route_detection(monkeypatch)
    rj, dj = jatlas.extract_step_atlas(jnp.asarray(img), jcfg, det, views, 96, 80)
    rt, dt = tatlas.extract_step_atlas(torch.from_numpy(img), cfg, det, views, 96, 80)
    for tf, jf in ((rt, rj), (dt["RootSIFT"], dj["RootSIFT"])):
        v = np.asarray(jf.valid)
        np.testing.assert_array_equal(tf.valid.numpy(), v)
        np.testing.assert_allclose(tf.det.xy.numpy()[v], np.asarray(jf.det.xy)[v],
                                   atol=5e-3, rtol=0)
    assert int(dt["RootSIFT"].count()) > 10
