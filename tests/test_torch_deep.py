"""The CNN stages in the port's pipeline and its deep flagship
(models/deep.py) against the JAX package, on the same seeded images and
weight arrays: HardNet with its real weights, AffNet and OriNet at the
JAX package's seeded random weights (`_random_params`, under the opt-in
MODS_TPU_ALLOW_RANDOM_CNN and a weight path that does not exist).

Envelopes (PERF.md section 2; extract_view with the CNN stages is held
in tests/test_torch_cnn.py):
- extract_deep against extract_deep_jit, match_pair_deep against
  _match_pair_deep_impl given the JAX program's RANSAC uniforms, and
  match_images with the deep configuration and one step against the JAX
  match_images with its draws (`JaxDraws`): n1, n2 1 %; tentatives 2 %;
  inliers max(2, 3 %); extract_deep's descriptors as
  `assert_colocated_descriptors` says.
With Baumberg off (the deep configuration) detection has no engine
question; the CNN patches come from the engine on both sides.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu.models import deep as jdeep
from mods_tpu.models.flagship import FrozenConfig
from mods_tpu.twoview import match_images as jmatch_images
from mods_tpu_torch import config as tconfig
from mods_tpu_torch import twoview
from mods_tpu_torch.models import deep as tdeep
from mods_tpu_torch.testing import deep_config, mods_schedule, rolled_pair, warp_pair
from torch_parity_helpers import JaxDraws, assert_colocated_descriptors

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARDNET_NPZ = os.path.join(ROOT, "weights", "HardNetPS.npz")
MAX_KP = 512


def _configs(tmp_path, monkeypatch, max_kp=MAX_KP):
    """(JAX config, port config) with the deep toggles of
    `testing.deep_config` at `max_kp` keypoints: HardNet's real weights,
    AffNet and OriNet random (opt-in), the engine route."""
    jcfg = jconfig.Config()
    jcfg.hessian.affine.useZMQ = True
    jcfg.hessian.affine.doBaumberg = False
    jcfg.domori.useZMQ = True
    jcfg.patch_source = "engine"
    jcfg.max_keypoints = jcfg.max_octave_cands = max_kp
    jcfg.hardnet.weights = HARDNET_NPZ
    jcfg.affnet.weights = str(tmp_path / "absent_AffNet.pth")
    jcfg.orinet.weights = str(tmp_path / "absent_OriNet.pth")
    monkeypatch.setenv("MODS_TPU_ALLOW_RANDOM_CNN", "1")
    cfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    ref = deep_config()
    assert (cfg.hessian.affine, cfg.domori) == (ref.hessian.affine, ref.domori)
    return jcfg, cfg


def _n(f):
    return int(np.asarray(f.count()))


@pytest.fixture(scope="module")
def deep_pair(tmp_path_factory):
    """The 160x200 warp pair through the JAX deep program and the port's
    match_pair_deep with the JAX program's RANSAC uniforms."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("deep")
    try:
        jcfg, cfg = _configs(tmp, mp)
        img1, img2, H = warp_pair(160, 200, 4)
        key = jax.random.PRNGKey(0)
        jout = jdeep._match_pair_deep_impl(jnp.asarray(img1), jnp.asarray(img2), key,
                                           FrozenConfig(jcfg), MAX_KP,
                                           jdeep._params3(jcfg))
        (sb, sm), (lb, lm) = tdeep.ransac_draw_shapes(cfg, MAX_KP)
        k1, k2, _ = jax.random.split(key, 3)
        draws = {"u_sweep": torch.from_numpy(np.array(jax.random.uniform(k1, (sb, sm)))),
                 "u_lo": torch.from_numpy(np.array(jax.random.uniform(k2, (lb, lm))))}
        tout = tdeep.match_pair_deep(img1, img2, cfg, MAX_KP, draws=draws, device="cpu")
        jf = jax.jit(jdeep.extract_deep_jit, static_argnames=("cfg", "max_kp"))(
            jnp.asarray(img1), FrozenConfig(jcfg), MAX_KP, jdeep._params3(jcfg))
        tf = tdeep.extract_deep(img1, cfg, MAX_KP, tdeep.cnn.nets3(cfg, "cpu"),
                                device="cpu")
        yield dict(jout=jout, tout=tout, jf=jf, tf=tf, H=H)
    finally:
        mp.undo()


def check_envelope(t, j):
    """t, j: (inliers, tentatives, n1, n2)."""
    ti, tt, t1, t2 = t
    ji, jt, j1, j2 = j
    assert abs(t1 - j1) <= 0.01 * j1 and abs(t2 - j2) <= 0.01 * j2, (t, j)
    assert abs(tt - jt) <= 0.02 * jt, (t, j)
    assert abs(ti - ji) <= max(2, 0.03 * ji), (t, j)


def test_extract_deep_matches_jax(deep_pair):
    tf, jf = deep_pair["tf"], deep_pair["jf"]
    assert tf.desc.shape == (MAX_KP, 128) and tf.det.n == MAX_KP
    assert abs(_n(tf) - _n(jf)) <= 0.01 * _n(jf) and _n(tf) > 100
    assert_colocated_descriptors(tf, jf)
    assert bool((tf.desc[~tf.det.valid] == 0).all())


def test_match_pair_deep_matches_jax(deep_pair):
    counts = lambda out: [int(o) for o in out[1:]]
    j, t = counts(deep_pair["jout"]), counts(deep_pair["tout"])
    check_envelope(t, j)
    assert j[0] >= 50
    Hj, Ht = np.asarray(deep_pair["jout"][0]), deep_pair["tout"][0].numpy()
    c = np.array([[0, 0, 1], [199, 0, 1], [0, 159, 1], [199, 159, 1]], float).T
    pj, pt = Hj @ c, Ht @ c
    assert np.abs(pt[:2] / pt[2] - pj[:2] / pj[2]).max() < 0.5


def test_match_pairs_deep_loops_over_pairs(tmp_path, monkeypatch):
    _, cfg = _configs(tmp_path, monkeypatch, max_kp=256)
    a, b = rolled_pair()
    g = torch.Generator().manual_seed(3)
    H, ninl, nt, n1, n2 = tdeep.match_pairs_deep([a, b], [b, a], cfg, 256,
                                                 generator=g, device="cpu")
    assert H.shape == (2, 3, 3) and ninl.shape == (2,)
    assert (n1 > 0).all() and (n2 > 0).all() and (ninl > 0).all()
    assert int(n1[0]) == int(n2[1]) and int(n2[0]) == int(n1[1])


def test_deep_entry_points_need_cuda_or_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    _, cfg = _configs(tmp_path, monkeypatch, max_kp=64)
    img = np.zeros((64, 64), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdeep.match_pair_deep(img, img, cfg, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdeep.extract_deep(img, cfg, 64, None)


def test_match_images_deep_one_step_matches_jax(tmp_path, monkeypatch):
    """The MODS loop with the deep configuration and the identity step of
    `mods_schedule("ZMQ")`, both packages with the same draws."""
    jcfg, tcfg = _configs(tmp_path, monkeypatch)
    tcfg.iters = mods_schedule("ZMQ")[:1]
    jcfg.iters = [jconfig.IterationStep(**dataclasses.asdict(s)) for s in tcfg.iters]
    img1, img2, _ = warp_pair(160, 200, 4)
    j = jmatch_images(img1, img2, jcfg)
    t = twoview.match_images(img1, img2, tcfg, device="cpu",
                             draws=JaxDraws(tcfg.ransac.seed))
    assert t.steps_done == j.steps_done == 1
    for k in ("regions1", "regions2", "descriptors1", "descriptors2"):
        assert abs(getattr(t, k) - getattr(j, k)) <= 0.01 * getattr(j, k), k
    assert abs(t.tentatives - j.tentatives) <= 0.02 * j.tentatives
    assert abs(t.inliers - j.inliers) <= max(2, 0.03 * j.inliers), (t.inliers, j.inliers)
    assert t.inliers >= tcfg.matching.minMatches
