"""The port's Hessian detector against the JAX package, stage by stage.

Inputs are seeded textured images.  Tolerances: blur and response stacks
1e-5 relative to their largest value (the same separable taps, summed in
the same order; only fused multiply-adds may differ); candidate lists
and localization fed identical responses must be identical, positions
within 1e-5 px; a whole octave (Baumberg included) must accept the same
keypoints in the same order, with positions within 1e-3 px and shapes
within 1e-3 (the JAX package's CPU path samples Baumberg windows by
hat-matrix contraction, the port by 4-tap bilinear: the same values up
to float32 rounding).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu.config import Config as JConfig
from mods_tpu.detect import detector as jdet
from mods_tpu.detect import pyramid as jpyr
from mods_tpu.ops import image as jim
from mods_tpu.types import Keypoints as JKeypoints
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.detect import detector as tdet
from mods_tpu_torch.detect import pyramid as tpyr
from mods_tpu_torch.ops import image as tim
from mods_tpu_torch.testing import textured_image
from mods_tpu_torch.types import Keypoints

JCFG = JConfig()
CFG = from_dict(dataclasses.asdict(JCFG))


def _first_level(h, w, seed):
    img = textured_image(h, w, seed)
    sigma = float(np.sqrt(1.6 ** 2 - 0.5 ** 2))
    return np.asarray(jim.gaussian_blur(jnp.asarray(img), sigma))


def _rel_close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    assert np.max(np.abs(a - b)) <= rel * max(np.max(np.abs(b)), 1e-30)


def test_gaussian_blur_and_half_image_match():
    img = textured_image(50, 70, 1)
    for border in ("replicate", "reflect101"):
        ref = np.asarray(jim.gaussian_blur(jnp.asarray(img), 2.3, 1.1,
                                           border=border))
        got = tim.gaussian_blur(torch.from_numpy(img), 2.3, 1.1, border=border)
        _rel_close(got.numpy(), ref, 1e-6)
    ref = np.asarray(jim.half_image(jnp.asarray(img[:49, :69])))
    got = tim.half_image(torch.from_numpy(img[:49, :69].copy())).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_build_octave_matches():
    first = _first_level(64, 80, 2)
    par = JCFG.hessian.pyramid
    jb, jr, js, jn = jpyr.build_octave(jnp.asarray(first), par, 1.6)
    tb, tr, ts, tn = tpyr.build_octave(torch.from_numpy(first),
                                       CFG.hessian.pyramid, 1.6)
    assert ts == js
    _rel_close(tb.numpy(), jb, 1e-5)
    _rel_close(tr.numpy(), jr, 1e-5)
    _rel_close(tn.numpy(), jn, 1e-5)


@pytest.mark.parametrize("mode", ["FixedTh", "RelativeTh"])
def test_find_extrema_and_localize_match(mode):
    first = _first_level(64, 80, 3)
    jpar = dataclasses.replace(JCFG.hessian.pyramid, detector_mode=mode)
    tpar = dataclasses.replace(CFG.hessian.pyramid, detector_mode=mode)
    jb, jr, js, _ = jpyr.build_octave(jnp.asarray(first), jpar, 1.6)
    resp = torch.from_numpy(np.asarray(jr))
    blurs = torch.from_numpy(np.asarray(jb))
    cap = 300
    jl = jpyr.find_extrema(jr, jpar, cap)
    tl = tpyr.find_extrema(resp, tpar, cap)
    for a, b in zip(tl[:4], jl[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tl[4] == int(jl[4])
    assert int(jl[3].sum()) > 20
    jk, jr_, jc_ = jpyr.localize(jr, jb, *jl[:4], jpar, js)
    tk, tr_, tc_ = tpyr.localize(resp, blurs, *tl[:4], tpar, js)
    np.testing.assert_array_equal(tk.valid.numpy(), np.asarray(jk.valid))
    np.testing.assert_array_equal(tk.level.numpy(), np.asarray(jk.level))
    np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr_))
    np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc_))
    v = np.asarray(jk.valid)
    np.testing.assert_allclose(tk.rc.numpy()[v], np.asarray(jk.rc)[v], atol=1e-5)
    np.testing.assert_allclose(tk.scale.numpy()[v], np.asarray(jk.scale)[v],
                               rtol=1e-5)
    np.testing.assert_allclose(tk.response.numpy()[v],
                               np.asarray(jk.response)[v], rtol=1e-5)
    jd = jpyr.dedup_octave_map(jr_, jc_, jk.valid, 80)
    td = tpyr.dedup_octave_map(tr_, tc_, tk.valid, 80)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_solve3x3_matches():
    """Cramer's rule in float32, same formula: within 1e-5 relative."""
    rng = np.random.default_rng(6)
    A = rng.normal(size=(3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    b = rng.normal(size=3).astype(np.float32)
    ref = np.asarray(jpyr._solve3x3(jnp.asarray(A), jnp.asarray(b)))
    got = tpyr._solve3x3(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(A @ got, b, atol=1e-5)


@pytest.mark.parametrize("hw", [(64, 80), (120, 264)],
                         ids=["precropped", "dma_window"])
def test_detect_octave_matches(hw):
    """One octave end to end; 120x264 takes the DMA-window Baumberg
    kernel's plain version, 64x80 the precropped one."""
    first = _first_level(*hw, 4)
    jk, jn, jne = jdet._detect_octave(jnp.asarray(first), JCFG.hessian, 1.6,
                                      2.0, 512, engine=True)
    tk, tn, tne = tdet._detect_octave(torch.from_numpy(first), CFG.hessian,
                                      1.6, 2.0, 512)
    assert tne == int(jne)
    v = np.asarray(jk.valid)
    assert v.sum() > 10
    np.testing.assert_array_equal(tk.valid.numpy(), v)
    np.testing.assert_allclose(tk.xy.numpy()[v], np.asarray(jk.xy)[v], atol=1e-3)
    np.testing.assert_allclose(tk.A.numpy()[v], np.asarray(jk.A)[v], atol=1e-3)
    np.testing.assert_allclose(tk.s.numpy()[v], np.asarray(jk.s)[v], rtol=1e-3)
    np.testing.assert_allclose(tk.response.numpy()[v],
                               np.asarray(jk.response)[v], rtol=1e-5)
    _rel_close(tn.numpy(), jn, 1e-5)


@pytest.mark.parametrize("mode", ["FixedTh", "RelativeTh", "FixedRegNumber",
                                  "RelativeRegNumber", "NotLessThanRegions"])
def test_select_sort_matches_all_modes(mode):
    rng = np.random.default_rng(5)
    n = 300
    resp = rng.choice([-40.0, -30.0, 5.0, 30.0, 50.0, 70.0], n).astype(np.float32)
    resp += rng.choice([0.0, 0.5], n).astype(np.float32)   # many exact ties
    valid = rng.uniform(0, 1, n) > 0.3
    xy = rng.uniform(0, 100, (n, 2)).astype(np.float32)
    A = rng.uniform(-2, 2, (n, 2, 2)).astype(np.float32)
    s = rng.uniform(1, 5, n).astype(np.float32)
    args = (120, mode, 31.0, 0.6, 40, 0.3, True)
    j = jdet._select_sort_jit(
        JKeypoints(jnp.asarray(xy), jnp.asarray(A), jnp.asarray(s),
                   jnp.asarray(resp), jnp.asarray(valid)), *args)
    t = tdet._select_sort(
        Keypoints(torch.from_numpy(xy), torch.from_numpy(A), torch.from_numpy(s),
                  torch.from_numpy(resp), torch.from_numpy(valid)), *args)
    for name in ("xy", "A", "s", "response", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)
    assert 0 < int(t.valid.sum()) <= 120
