"""ORSA (`verify/orsa.py`) of the port against the JAX package, on the CPU.

Tolerances:
- the symmetric epipolar sum error: 1e-5 relative; log10 C(n, k) and the
  NFA curve: 1e-5 relative and 1e-4 absolute (torch's lgamma and XLA's
  round apart by an ulp or two, on values in the hundreds), the position
  of the curve's minimum equal, and equal to a direct scalar port of the
  reference (orsa.cpp);
- orsa_filter handed the JAX package's uniforms (`JaxDraws`, "orsa"
  tree): the decision equal (inliers kept or none), inlier counts within
  max(2, 3 %) of JAX's; on the well-conditioned two-camera scene F within
  1e-3 after normalizing norm and sign.  On the graf sets the best model
  comes from 7-point samples whose cubic roots round apart, so F is not
  compared there; JAX accepts the forward set (17 inliers) and rejects
  the reverse one (0).
The JAX results are computed once per module (`jax_orsa`).
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu.verify import orsa as jo
from mods_tpu_torch import config as tconfig
from mods_tpu_torch.verify import orsa as to
from torch_parity_helpers import (JaxDraws, assert_draws_answer, graf_tentatives,
                                  jax_tentatives, match_images_both, padded,
                                  recording_uniforms, tentative_arrays,
                                  torch_tentatives, two_camera_tentatives, within)

W, H = 800, 600


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _unit(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


def test_symm_epi_sum_sq_matches():
    arrays, F = two_camera_tentatives(seed=3)
    F = F.astype(np.float32)
    j = np.asarray(jo.symm_epi_sum_sq(jnp.asarray(F), jnp.asarray(arrays[0]),
                                      jnp.asarray(arrays[1])))
    t = to.symm_epi_sum_sq(_t(F), _t(arrays[0]), _t(arrays[1])).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-9)
    tb = to.symm_epi_sum_sq(_t(np.stack([F, F.T])), _t(arrays[0]), _t(arrays[1])).numpy()
    np.testing.assert_allclose(tb[0], j, rtol=1e-5, atol=1e-9)


def test_nfa_curve_matches_jax_and_the_reference():
    """The NFA of a mostly planar scene's errors under a random F (the
    JAX package's test_epipolar case): both packages' curves agree, and
    their minimum is where a scalar port of orsa.cpp:238-263, 449-469 and
    559-567 puts it."""
    rng = np.random.default_rng(3)
    w, h, n = 800, 640, 60
    xy1 = rng.uniform(0, (w, h), (n, 2))
    Hgt = np.array([[0.9, 0.05, 30], [-0.04, 1.1, -10], [1e-4, -5e-5, 1.0]])
    ph = np.c_[xy1, np.ones(n)] @ Hgt.T
    xy2 = ph[:, :2] / ph[:, 2:3] + rng.normal(0, 2.0, (n, 2))
    F = rng.normal(0, 1, (3, 3))
    F = F / np.linalg.norm(F)
    norm = 1.0 / math.sqrt(w * h)
    p1 = (xy1 - (0.5 * w, 0.5 * h)) * norm
    p2 = (xy2 - (0.5 * w, 0.5 * h)) * norm
    es = np.sort(to.symm_epi_sum_sq(_t(F), _t(p1), _t(p2)).numpy())[None, :]
    logalpha0 = math.log10(2.0) + 0.5 * math.log10((w * w + h * h) * norm * norm)
    k = np.arange(1.0, 40.0, dtype=np.float32)
    np.testing.assert_allclose(
        to._log10_comb(_t(np.float32(60.0)), _t(k)).numpy(),
        np.asarray(jo._log10_comb(jnp.float32(60.0), jnp.asarray(k))), rtol=1e-5, atol=1e-4)
    j = np.asarray(jo.nfa_curve(jnp.asarray(es), n, logalpha0))[0]
    t = to.nfa_curve(_t(es), n, logalpha0).numpy()[0]
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    ok = np.isfinite(j)
    np.testing.assert_allclose(t[ok], j[ok], rtol=1e-5, atol=1e-4)

    def logcombi(k, nn):
        if k >= nn or k <= 0:
            return 0.0
        k = min(k, nn - k)
        return sum(math.log10(nn - k + i) - math.log10(i) for i in range(1, k + 1))
    e = np.sort(es[0].astype(np.float64))
    ref = [math.log10(3.0 * (n - 7)) + (logalpha0 + 0.5 * math.log10(e[i])) * (i - 6)
           + logcombi(i + 1, n) + logcombi(7, i + 1) for i in range(7, n)]
    assert int(np.argmin(t)) == int(np.argmin(j)) == 7 + int(np.argmin(ref))
    assert abs(t.min() - min(ref)) < 0.05


def _noise():
    rng = np.random.default_rng(7)
    return tentative_arrays(rng.uniform([0, 0], [W, H], (60, 2)),
                            rng.uniform([0, 0], [W, H], (60, 2)))


CASES = {
    "graf_fwd": lambda: (graf_tentatives("fwd"), jconfig.RANSACPars(), (800, 640)),
    "graf_rev": lambda: (graf_tentatives("rev"), jconfig.RANSACPars(), (800, 640)),
    "two_camera": lambda: (padded(two_camera_tentatives()[0]),
                           jconfig.RANSACPars(err_threshold=2.0, LAFCoef=0.0), (W, H)),
    "pure_noise": lambda: (padded(_noise()),
                           jconfig.RANSACPars(err_threshold=2.0, LAFCoef=0.0), (W, H)),
}


@pytest.fixture(scope="module")
def jax_orsa():
    """JAX's orsa_filter on every case, once: (arrays, pars, (w, h), F,
    inlier mask, score, the uniforms it drew in order)."""
    out = {}
    with recording_uniforms() as seen:
        for name, make in CASES.items():
            arrays, pars, wh = make()
            start = len(seen)
            r = jo.orsa_filter(jax_tentatives(arrays), pars, *wh)
            keep = np.asarray(r.tentatives.valid)
            out[name] = (arrays, pars, wh, np.asarray(r.H), keep, float(r.score),
                         seen[start:])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_orsa_filter_with_jax_draws(case, jax_orsa):
    arrays, pars, wh, Fj, keep_j, score_j, _ = jax_orsa[case]
    draws = JaxDraws(pars.seed, "orsa")
    r = to.orsa_filter(torch_tentatives(arrays), tconfig.RANSACPars(**vars(pars)),
                       *wh, draws=draws)
    assert draws.names == ["orsa1", "orsa2"]
    n_t, n_j = int(r.n_inliers), int(keep_j.sum())
    assert (n_t > 0) == (n_j > 0) and within(n_t, n_j), (n_t, n_j)
    expect = {"graf_fwd": 17, "graf_rev": 0, "pure_noise": 0}
    if case in expect:
        assert n_j == expect[case]
    if case == "two_camera":
        assert n_t >= 60 and float(r.score) > 2.0 and score_j > 2.0
        np.testing.assert_allclose(_unit(r.H.numpy()), _unit(Fj), atol=1e-3)


def test_jax_draws_answer_what_orsa_draws(jax_orsa):
    """The uniforms JAX's orsa_filter drew on the forward graf set, in
    order, are JaxDraws' answers to "orsa1" and "orsa2"."""
    arrays, pars, *_, seen = jax_orsa["graf_fwd"]
    assert_draws_answer(JaxDraws(pars.seed, "orsa"), ["orsa1", "orsa2"], seen)


def test_match_images_orsa_matches_jax():
    """pre_extracted features of a two-plane scene through both packages'
    match_images with ver_type ORSA (w, h of img1): the same tentatives,
    the decision equal, inliers within max(2, 3 %), both planes kept."""
    (j, t), plane = match_images_both("ORSA")
    assert t.steps_done == j.steps_done == 1
    assert (t.tentatives, t.unique_tentatives) == (j.tentatives, j.unique_tentatives)
    assert (t.inliers > 0) == (j.inliers > 0) and within(t.inliers, j.inliers), \
        (t.inliers, j.inliers)
    assert t.inliers >= 15 and all(plane(t)[i] >= 8 for i in (0, 1)), plane(t)
