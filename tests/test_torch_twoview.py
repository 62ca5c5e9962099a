"""The MODS loop of the port (`twoview.match_images`) and the pieces it
adds to matching and verification, against the JAX package.

- knn_streaming (the JAX package's streamed route, which match_fginn does
  not take) gives the dense route's neighbours exactly, ties lower index
  first, and the JAX package's streaming lists where at least k database
  rows are valid.
- loransac_h, handed the JAX package's draws (`JaxDraws`), gives the same
  inliers and H within 1e-3 after normalization by H[2,2].
- match_images on the CPU, the JAX package with patch_source="engine" and
  its TPU route's detection (`tpu_route_detection`), both with the same
  draws: steps_done equal; regions and descriptors (n1, n2) within 1%,
  tentatives within 2%, inliers within max(2, 3%), the flagship's
  envelope.  (The JAX package samples descriptor patches on the CPU with
  its hat engine, the port with the kernels' plain versions, and matches
  with approx_min_k, whose ties the port orders otherwise, so counts are
  held to an envelope, not equality.)
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu import types as jtypes
from mods_tpu.match import matching as jm
from mods_tpu.twoview import match_images as jmatch_images
from mods_tpu.verify import homography as jh
from mods_tpu_torch import config as tconfig
from mods_tpu_torch import twoview
from mods_tpu_torch import types as ttypes
from mods_tpu_torch.match import matching as tm
from mods_tpu_torch.testing import mods_schedule, tilted_pair, warp_pair
from mods_tpu_torch.verify import homography as th
from torch_parity_helpers import JaxDraws, tpu_route_detection

DATA = os.path.join(os.path.dirname(__file__), "data")
T_FIELDS = ("xy1", "xy2", "A1", "A2", "s1", "s2", "d1", "d2", "ratio", "valid")
ITERS_MODS = """
[Iterations]
Steps=2
minMatches=15
[HessianAffine0]
TiltSet=1
ScaleSet=1
Phi=360
Descriptors=RootSIFT
FGINNThreshold=0.8
[Matching0]
SeparateDetectors=HessianAffine
SeparateDescriptors=RootSIFT
[HessianAffine1]
TiltSet=1,2,4
ScaleSet=1
Phi=72
Descriptors=RootSIFT
FGINNThreshold=0.8
[Matching1]
SeparateDetectors=HessianAffine
SeparateDescriptors=RootSIFT
"""


def test_mods_schedule_is_what_load_iters_reads(tmp_path):
    p = tmp_path / "iters_MODS.ini"
    p.write_text(ITERS_MODS)
    steps, n, min_matches = tconfig.load_iters(str(p))
    assert steps == mods_schedule() and (n, min_matches) == (2, 15)
    jsteps, _, _ = jconfig.load_iters(str(p))
    assert [dataclasses.asdict(s) for s in jsteps] == \
        [dataclasses.asdict(s) for s in steps]


def test_from_dict_carries_the_schedule(tmp_path):
    p = tmp_path / "iters_MODS.ini"
    p.write_text(ITERS_MODS)
    jcfg = jconfig.Config()
    jcfg.iters, jcfg.matching.maxSteps, jcfg.matching.minMatches = \
        jconfig.load_iters(str(p))
    cfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    assert cfg.iters == mods_schedule()
    assert all(isinstance(s, tconfig.IterationStep) for s in cfg.iters)
    assert tconfig.to_dict(cfg) == dataclasses.asdict(jcfg)


# --------------------------------------------------------------------------- #
# matching
# --------------------------------------------------------------------------- #
def _tie_heavy(seed, n1=300, n2=700):
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 3, (n2, 16)).astype(np.float32)
    d2[n2 // 2:] = d2[: n2 - n2 // 2]               # exact duplicate rows
    d1 = np.clip(d2[rng.integers(0, n2, n1)] + rng.integers(-1, 2, (n1, 16)),
                 0, 255).astype(np.float32)
    valid2 = rng.uniform(0, 1, n2) > 0.2
    return [torch.from_numpy(a) for a in (d1, d2, valid2)]


@pytest.mark.parametrize("int_exact", [True, False])
@pytest.mark.parametrize("block", [64, 100, 4096])
def test_knn_streaming_equals_dense(int_exact, block):
    d1, d2, v2 = _tie_heavy(1)
    dd, di = tm._knn(d1, d2, v2, 50, int_exact)
    sd, si = tm.knn_streaming(d1, d2, v2, 50, block, int_exact)
    assert torch.equal(si, di) and torch.equal(sd, dd)
    # few valid columns: the invalid ones follow at 1e12, lowest index first
    v_few = torch.zeros_like(v2)
    v_few[::70] = True
    dd, di = tm._knn(d1, d2, v_few, 50, int_exact)
    sd, si = tm.knn_streaming(d1, d2, v_few, 50, block, int_exact)
    assert torch.equal(si, di) and torch.equal(sd, dd)
    assert int((dd >= 1e12).sum()) > 0


def test_knn_streaming_matches_jax_streaming():
    d1, d2, v2 = _tie_heavy(2)
    jd, ji = jm.knn_streaming(jnp.asarray(d1.numpy()), jnp.asarray(d2.numpy()),
                              jnp.asarray(v2.numpy()), 50, 128, int_exact=True)
    sd, si = tm.knn_streaming(d1, d2, v2, 50, 128, int_exact=True)
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(sd.numpy(), np.asarray(jd))


def _features(seed, n, pos=None):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (n, 2)).astype(np.float32) if pos is None else pos
    A = rng.uniform(-1, 1, (n, 2, 2)).astype(np.float32)
    s = rng.uniform(1, 4, n).astype(np.float32)
    return xy, A, s


def _feature_pair(seed, n1=300, n2=700):
    d1, d2, v2 = _tie_heavy(seed, n1, n2)
    out = []
    for d, v, k in ((d1, torch.ones(n1, dtype=torch.bool), 0), (d2, v2, 1)):
        xy, A, s = _features(seed + 10 * k, d.shape[0])
        kp = ttypes.Keypoints(torch.from_numpy(xy), torch.from_numpy(A),
                              torch.from_numpy(s), torch.zeros(d.shape[0]), v)
        out.append(ttypes.Features(kp, kp, d))
    return out


def test_match_fginn_on_streamed_neighbours(monkeypatch):
    """match_fginn over knn_streaming's lists gives the dense route's
    tentatives field for field: the two kNN routes are interchangeable."""
    f1, f2 = _feature_pair(3)
    dense = tm.match_fginn(f1, f2, tconfig.MatchPars(), 0.9, int_exact=True)
    monkeypatch.setattr(tm, "_knn", lambda d1, d2, v2, k, int_exact:
                        tm.knn_streaming(d1, d2, v2, k, 96, int_exact))
    streamed = tm.match_fginn(f1, f2, tconfig.MatchPars(), 0.9, int_exact=True)
    for f in T_FIELDS:
        assert torch.equal(getattr(streamed, f), getattr(dense, f)), f
    assert int(dense.count()) > 10


def _jfeatures(f):
    kp = jtypes.Keypoints(*[jnp.asarray(getattr(f.det, a).numpy())
                            for a in ("xy", "A", "s", "response", "valid")])
    return jtypes.Features(kp, kp, jnp.asarray(f.desc.numpy()))


def test_match_distance_threshold_and_concat_match_jax():
    f1, f2 = _feature_pair(4)
    j = jm.match_distance_threshold(_jfeatures(f1), _jfeatures(f2), None, 2.0)
    t = tm.match_distance_threshold(f1, f2, tconfig.MatchPars(), 2.0)
    jc = jm.concat_tentatives([j, j])
    tc = tm.concat_tentatives([t, t])
    for f in T_FIELDS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)
    assert 0 < int(t.count()) < f1.n


# --------------------------------------------------------------------------- #
# verification
# --------------------------------------------------------------------------- #
def _fixture(name):
    d = np.load(os.path.join(DATA, f"fpath_graf_{name}.npz"))
    z = np.zeros_like(d["s1"])
    return [d[k] if k in d else z for k in T_FIELDS]


def _synthetic_low_ratio(m=512, share=0.12, seed=5):
    """A homography's correspondences with 88% outliers: the first core's
    inlier ratio asks nsamples for more hypotheses than it drew, so the
    adaptive loop runs several doubling sweeps."""
    rng = np.random.default_rng(seed)
    xy1 = rng.uniform(0, 400, (m, 2)).astype(np.float32)
    H = np.array([[0.9, 0.1, 20.0], [-0.08, 1.05, 5.0], [2e-4, 1e-4, 1.0]])
    p = np.c_[xy1, np.ones(m)] @ H.T
    xy2 = (p[:, :2] / p[:, 2:]).astype(np.float32)
    out = rng.uniform(0, 1, m) > share
    xy2[out] = rng.uniform(0, 400, (int(out.sum()), 2))
    xy2 += rng.normal(0, 0.3, xy2.shape).astype(np.float32)
    A = np.tile(np.eye(2, dtype=np.float32), (m, 1, 1))
    s = np.full(m, 2.0, np.float32)
    z = np.zeros(m, np.float32)
    valid = rng.uniform(0, 1, m) > 0.05
    return [xy1, xy2, A, A, s, s, z, z, z, valid]


@pytest.mark.parametrize("case", ["graf_fwd", "graf_rev", "low_inlier_ratio"])
def test_loransac_h_with_jax_draws(case):
    arrays = _synthetic_low_ratio() if case == "low_inlier_ratio" else \
        _fixture(case[5:])
    pars = jconfig.RANSACPars()
    jr = jh.loransac_h(jtypes.Tentatives(*[jnp.asarray(a) for a in arrays]), pars)
    draws = JaxDraws(pars.seed)
    tr = th.loransac_h(ttypes.Tentatives(*[torch.from_numpy(a) for a in arrays]),
                       tconfig.RANSACPars(), draws=draws)
    np.testing.assert_array_equal(tr.tentatives.valid.numpy(),
                                  np.asarray(jr.tentatives.valid))
    assert int(tr.n_inliers) == int(jr.n_inliers)
    if case == "graf_rev":
        # 11 of the reverse set's 78 correspondences fit one model; its best
        # hypotheses come from near-singular 4-point samples, whose pinned
        # 8x8 solves LAPACK and XLA round apart (the same samples score
        # 11.43 and 10.97), so H is not compared; no correspondence passes
        # the H-LAF check in either package
        assert int(tr.n_inliers) == 0
    else:
        assert int(tr.n_inliers) >= 8
        np.testing.assert_allclose(tr.H.numpy(), np.asarray(jr.H), rtol=1e-3,
                                   atol=1e-3)
    sweeps = [n for n in draws.names if n.startswith("sweep")]
    if case == "low_inlier_ratio":
        assert len(sweeps) >= 2 and "u_sweep2" in draws.names


def test_nsamples_required_matches():
    for args in ((10, 100, 4, 0.99), (0, 100, 4, 0.99), (100, 100, 4, 0.99),
                 (37, 512, 4, 0.95), (5, 0, 4, 0.99)):
        assert th.nsamples_required(*args) == jh.nsamples_required(*args)


def test_hmatrix_filter_matches():
    arrays = _fixture("fwd")
    H = np.array([[0.9, 0.05, 10.0], [-0.04, 1.1, 3.0], [1e-4, 0.0, 1.0]])
    xy1 = arrays[0]
    p = np.c_[xy1, np.ones(len(xy1))] @ H.T
    arrays[1] = (p[:, :2] / p[:, 2:] + np.random.default_rng(0).normal(
        0, 1.5, xy1.shape)).astype(np.float32)
    j = jh.hmatrix_filter(jtypes.Tentatives(*[jnp.asarray(a) for a in arrays]), H,
                          jconfig.RANSACPars())
    t = th.hmatrix_filter(ttypes.Tentatives(*[torch.from_numpy(a) for a in arrays]),
                          H, tconfig.RANSACPars())
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    assert 0 < int(t.count()) < int(arrays[-1].sum())


# --------------------------------------------------------------------------- #
# the MODS loop
# --------------------------------------------------------------------------- #
def _configs(max_kp=1024):
    jcfg = jconfig.Config()
    jcfg.max_keypoints = jcfg.max_octave_cands = max_kp
    jcfg.patch_source = "engine"
    cfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    cfg.iters = mods_schedule()
    jcfg.iters = [jconfig.IterationStep(**dataclasses.asdict(s)) for s in cfg.iters]
    return jcfg, cfg


def _counts(r):
    return dict(steps=r.steps_done, regions1=r.regions1, regions2=r.regions2,
                n1=r.descriptors1, n2=r.descriptors2, tentatives=r.tentatives,
                inliers=r.inliers, true_gt=r.true_matches_gt)


def assert_envelope(t, j):
    assert t["steps"] == j["steps"], (t, j)
    for k in ("regions1", "regions2", "n1", "n2"):
        assert abs(t[k] - j[k]) <= 0.01 * j[k], (k, t, j)
    assert abs(t["tentatives"] - j["tentatives"]) <= 0.02 * j["tentatives"], (t, j)
    assert abs(t["inliers"] - j["inliers"]) <= max(2, 0.03 * j["inliers"]), (t, j)


PAIRS = {
    # a wide-baseline pair: 15 inliers need the tilted views of step 1
    "tilted_128x160": lambda: tilted_pair(128, 160, 1, 4.0, 0.3),
    # a mild homography: step 0 verifies enough
    "warp_128x160": lambda: warp_pair(128, 160, 3),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Both pairs through the JAX package's loop once (LORANSAC, and
    GR_TRUTH on the mild pair), with its TPU route's detection."""
    mp = pytest.MonkeyPatch()
    tpu_route_detection(mp)
    try:
        jcfg, _ = _configs()
        out = {}
        for name, make in PAIRS.items():
            img1, img2, H = make()
            out[name] = _counts(jmatch_images(img1, img2, jcfg))
        img1, img2, H = PAIRS["warp_128x160"]()
        out["gr_truth"] = _counts(jmatch_images(img1, img2, jcfg, H_gt=H,
                                                ver_type="GR_TRUTH"))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("name", list(PAIRS))
def test_match_images_matches_jax(name, jax_runs):
    _, cfg = _configs()
    img1, img2, H = PAIRS[name]()
    r = twoview.match_images(img1, img2, cfg, device="cpu",
                             draws=JaxDraws(cfg.ransac.seed))
    t, j = _counts(r), jax_runs[name]
    assert_envelope(t, j)
    assert t["steps"] == (2 if name.startswith("tilted") else 1)
    assert t["inliers"] >= cfg.matching.minMatches
    assert r.H.shape == (3, 3) and np.isfinite(r.H).all()
    assert r.timelog.total() > 0 and r.final is not None


def test_match_images_gr_truth_matches_jax(jax_runs):
    _, cfg = _configs()
    img1, img2, H = PAIRS["warp_128x160"]()
    r = twoview.match_images(img1, img2, cfg, H_gt=H, ver_type="GR_TRUTH",
                             device="cpu", draws=JaxDraws(cfg.ransac.seed))
    t, j = _counts(r), jax_runs["gr_truth"]
    assert_envelope(t, j)
    assert abs(t["true_gt"] - j["true_gt"]) <= max(2, 0.03 * j["true_gt"]), (t, j)
    assert t["true_gt"] >= cfg.matching.minMatches


def test_match_images_pre_extracted_matches_jax():
    """Features given: one step, matching and verification only."""
    rng = np.random.default_rng(0)
    n = 120
    xy1 = rng.uniform(20, 300, (n, 2)).astype(np.float32)
    desc = rng.integers(0, 255, (n, 128)).astype(np.float32)
    d2 = np.clip(desc + rng.normal(0, 2, desc.shape), 0, 255).astype(np.float32)
    sets = []
    for xy, d in ((xy1, desc), (xy1 + np.float32([7.0, -3.0]), d2)):
        a = [xy, np.tile(np.eye(2, dtype=np.float32), (n, 1, 1)),
             np.full(n, 3.0, np.float32), rng.uniform(1, 100, n).astype(np.float32),
             np.ones(n, bool)]
        sets.append((a, d))
    jf = [jtypes.Features(jtypes.Keypoints(*map(jnp.asarray, a)),
                          jtypes.Keypoints(*map(jnp.asarray, a)), jnp.asarray(d))
          for a, d in sets]
    tf = [ttypes.Features(ttypes.Keypoints(*map(torch.from_numpy, a)),
                          ttypes.Keypoints(*map(torch.from_numpy, a)), torch.from_numpy(d))
          for a, d in sets]
    jcfg, cfg = _configs()
    img = np.zeros((16, 16), np.float32)
    j = _counts(jmatch_images(img, img, jcfg, pre_extracted=tuple(jf)))
    t = _counts(twoview.match_images(img, img, cfg, pre_extracted=tuple(tf),
                                     device="cpu", draws=JaxDraws(cfg.ransac.seed)))
    assert t == j and t["steps"] == 1 and t["inliers"] >= 100


def test_match_images_per_view_reference_route_runs():
    """patch_source "auto" on the CPU is the reference route: no atlas,
    each of step 1's 15 views synthesized and extracted on its own, the
    descriptors from the two-stage sampler."""
    _, cfg = _configs(256)
    cfg.patch_source = "auto"
    img1, img2, H = tilted_pair(96, 128, 2, 3.0, 0.3)
    r = twoview.match_images(img1, img2, cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert r.steps_done == 2 and len(r.per_step) == 2
    assert len(r.rep1.get("HessianAffine", "RootSIFT")) == 16
    s0, s1 = r.per_step
    assert s1["regions1"] > s0["regions1"] > 0 and s1["descriptors2"] > s0["descriptors2"]
    assert s0["inliers"] < 15 <= s1["inliers"] and np.isfinite(r.H).all()


def test_match_images_needs_the_card_or_the_cpu(monkeypatch):
    _, cfg = _configs()
    img = np.zeros((32, 32), np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        twoview.match_images(img, img, cfg)
    for ver_type in ("LORANSACF", "ORSA"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            twoview.match_images(img, img, cfg, ver_type=ver_type)
    with pytest.raises(ValueError, match="ver_type"):
        twoview.match_images(img, img, cfg, ver_type="RANSAC", device="cpu")
    cfg.iters[0].detectors["MSER"] = {}
    with pytest.raises(NotImplementedError, match="queue A item 4"):
        twoview.match_images(img, img, cfg, device="cpu")
