"""DEGENSAC (`verify/fundamental.py`) of the port against the JAX package,
on the CPU.

Tolerances:
- primitives (Sampson and symmetric errors, the cubic's roots, the 7x9
  nullspace, the 7-point solver, Hdetect) on well-conditioned inputs:
  1e-5 relative (H and F compared after normalizing scale and sign);
- pipelines handed the JAX package's uniforms (`JaxDraws`): inlier counts
  within max(2, 3 %) of JAX's; F within 1e-3 after normalizing norm and
  sign where the problem is well conditioned; the degeneracy flag equal;
- the JAX package reads 19 (forward) and 14 (reverse) DEGENSAC inliers on
  the graf fixtures at RANSACPars() defaults.
The JAX results are computed once per module (`jax_f`).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu.verify import fundamental as jf
from mods_tpu_torch import config as tconfig
from mods_tpu_torch.testing import epipolar_error, two_plane_pair
from mods_tpu_torch.verify import fundamental as tf
from mods_tpu_torch.verify import homography as th
from torch_parity_helpers import (JaxDraws, assert_draws_answer, graf_tentatives,
                                  jax_tentatives, match_images_both, padded,
                                  plane_scene_tentatives, recording_uniforms,
                                  tentative_arrays, torch_tentatives,
                                  two_camera_tentatives, within)

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _unit(F):
    """F scaled to unit norm, sign of its largest entry positive."""
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


# --------------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fn", ["sampson_f_sq", "symm_epi_sq"])
def test_epipolar_errors_match(fn):
    arrays, F = two_camera_tentatives(seed=2)
    F = F.astype(np.float32)
    j = np.asarray(getattr(jf, fn)(jnp.asarray(F), jnp.asarray(arrays[0]),
                                   jnp.asarray(arrays[1])))
    t = getattr(tf, fn)(_t(F), _t(arrays[0]), _t(arrays[1])).numpy()
    np.testing.assert_allclose(t, j, rtol=RTOL, atol=1e-9)
    # batched F [B,3,3] against [M,2] points, as the sweeps call it
    Fs = np.stack([F, 2 * F, F.T]).astype(np.float32)
    tb = getattr(tf, fn)(_t(Fs), _t(arrays[0]), _t(arrays[1])).numpy()
    for b in range(3):
        jb = np.asarray(getattr(jf, fn)(jnp.asarray(Fs[b]), jnp.asarray(arrays[0]),
                                        jnp.asarray(arrays[1])))
        np.testing.assert_allclose(tb[b], jb, rtol=RTOL, atol=1e-9)


def test_cubic_roots_match():
    """Cubics with three well-separated real roots, and with one real root
    beside a complex pair (the NaN-padded branch)."""
    rng = np.random.default_rng(0)
    r = np.sort(rng.uniform(-3, 3, (200, 3)), 1)
    r = r[np.min(np.diff(r, axis=1), 1) > 0.3]
    a = rng.uniform(0.5, 2, len(r)) * rng.choice([-1, 1], len(r))
    three = np.stack([a, -a * r.sum(1), a * (r[:, 0] * r[:, 1] + r[:, 0] * r[:, 2]
                                             + r[:, 1] * r[:, 2]), -a * r.prod(1)])
    x0, re, im = rng.uniform(-2, 2, (3, 200))
    im = np.abs(im) + 0.5
    # (x - x0)((x - re)^2 + im^2)
    one = np.stack([np.ones(200), -(x0 + 2 * re), 2 * re * x0 + re ** 2 + im ** 2,
                    -x0 * (re ** 2 + im ** 2)])
    c = np.concatenate([three, one], 1).astype(np.float32)
    j = np.asarray(jf._cubic_roots(*map(jnp.asarray, c)))
    t = tf._cubic_roots(*map(_t, c)).numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t[len(r):, 1:]).all() and np.isfinite(t[:len(r)]).all()
    ok = np.isfinite(j)
    np.testing.assert_allclose(t[ok], j[ok], rtol=RTOL, atol=1e-5)


def _seven_point_samples(n=64, seed=4):
    """7-point samples of the two-camera scene's true correspondences in
    Hartley-normalized coordinates, as the sweeps see them."""
    arrays, _ = two_camera_tentatives(n_in=120, n_out=0, noise=0.0, seed=seed)
    xy1, xy2 = _t(arrays[0]), _t(arrays[1])
    valid = torch.ones(len(xy1), dtype=torch.bool)
    _, _, xy1n, xy2n, _ = th._normalize_pair(xy1, xy2, valid, torch.tensor(4.0))
    idx = np.stack([np.random.default_rng(seed + i).choice(120, 7, replace=False)
                    for i in range(n)])
    return xy1n.numpy()[idx], xy2n.numpy()[idx]


def test_nullspace2_elim_matches():
    p, q = _seven_point_samples()
    A = np.asarray(jf.f_rows(jnp.asarray(p), jnp.asarray(q)))
    np.testing.assert_array_equal(tf.f_rows(_t(p), _t(q)).numpy(), A)
    j1, j2 = jf._nullspace2_elim(jnp.asarray(A))
    t1, t2 = tf._nullspace2_elim(_t(A))
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=RTOL, atol=1e-6)
    # both basis vectors solve the system
    assert np.abs(A @ t1.numpy().reshape(-1, 9, 1)).max() < 1e-4


def test_fs_from_sample_matches():
    """The three candidates of each sample, NaN where the cubic has one
    real root; the candidate that fits the sample's geometry agrees to 1e-5
    after normalization, and the oriented test and the SVD-free epipole
    agree."""
    p, q = _seven_point_samples()
    j = np.asarray(jf._fs_from_sample(jnp.asarray(p), jnp.asarray(q)))
    t = tf._fs_from_sample(_t(p), _t(q)).numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    ok = np.isfinite(j).all((2, 3))
    for jj, tt in zip(j[ok], t[ok]):
        np.testing.assert_allclose(_unit(tt), _unit(jj), rtol=RTOL, atol=1e-5)
    Fs = np.nan_to_num(j, nan=0.0).reshape(-1, 3, 3)
    rep = lambda x: np.repeat(x, 3, axis=0)
    np.testing.assert_array_equal(
        tf._oriented_f_ok(_t(Fs), _t(rep(p)), _t(rep(q))).numpy(),
        np.asarray(jax.vmap(jf._oriented_f_ok)(jnp.asarray(Fs), jnp.asarray(rep(p)),
                                               jnp.asarray(rep(q)))))
    np.testing.assert_allclose(tf._epipole2_cross(_t(Fs)).numpy(),
                               np.asarray(jf._epipole2_cross(jnp.asarray(Fs))),
                               rtol=RTOL, atol=1e-6)


def test_hdetect_matches():
    """H from F and three plane correspondences; its sign follows the SVD's
    epipole, so H is compared after scaling by H[2,2]."""
    arrays, F = plane_scene_tentatives()
    xy1, xy2 = arrays[0], arrays[1]
    Fj = jnp.asarray(F, jnp.float32)
    for s in (0, 3, 10):
        j = np.asarray(jf._hdetect(Fj, jnp.asarray(xy1[s:s + 3]), jnp.asarray(xy2[s:s + 3])))
        t = tf._hdetect(_t(F), _t(xy1[s:s + 3]), _t(xy2[s:s + 3])).numpy()
        np.testing.assert_allclose(t / t[2, 2], j / j[2, 2], rtol=RTOL, atol=1e-5)
    # batched over the five checksample triples, as the degeneracy pass calls it
    tri = jf._DEGEN_TRIPLES
    tb = tf._hdetect(_t(F), _t(xy1[:7][tri]), _t(xy2[:7][tri])).numpy()
    for k, tr in enumerate(tri):
        j = np.asarray(jf._hdetect(Fj, jnp.asarray(xy1[tr]), jnp.asarray(xy2[tr])))
        np.testing.assert_allclose(tb[k] / tb[k, 2, 2], j / j[2, 2], rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("sample", ["plane", "mixed"])
def test_degeneracy_pass_matches(sample):
    """The JAX package's test_degensac cases: a plane-induced F from a
    plane-only 7-sample (degenerate; F_pp must recover the off-plane
    points) and the true F from a mixed sample."""
    arrays, F_true = plane_scene_tentatives()
    n_plane, n_off = 70, 15
    xy1, xy2 = arrays[0], arrays[1]
    M = len(xy1)
    th4 = 4.0
    if sample == "plane":
        sidx = np.arange(7)
        Fs = np.nan_to_num(np.asarray(jf._fs_from_sample(
            jnp.asarray(xy1[sidx][None]), jnp.asarray(xy2[sidx][None])))[0], nan=0.0)
        scores = [int(np.sum(np.asarray(jf.sampson_f_sq(jnp.asarray(Fs[i]),
                                                        jnp.asarray(xy1[:n_plane]),
                                                        jnp.asarray(xy2[:n_plane]))) < th4))
                  for i in range(3)]
        F0 = Fs[int(np.argmax(scores))]
    else:
        sidx = np.array([0, 1, 2, n_plane, n_plane + 1, n_plane + 2, n_plane + 3])
        F0 = F_true.astype(np.float32)
    key = jax.random.PRNGKey(0)
    valid = np.ones(M, bool)
    Fj, Jj, dj = jax.jit(jf._degeneracy_pass)(jnp.asarray(F0), jnp.asarray(xy1[sidx]),
                                     jnp.asarray(xy2[sidx]), jnp.asarray(xy1),
                                     jnp.asarray(xy2), jnp.asarray(valid),
                                     jnp.float32(th4), key)
    k_h, k_pp = jax.random.split(key)
    u_h = torch.from_numpy(np.array(jax.random.uniform(k_h, (tf.H_BATCH, M))))
    u_pp = torch.from_numpy(np.array(jax.random.uniform(k_pp, (tf.PP_BATCH, M))))
    Ft, Jt, dt = tf._degeneracy_pass(_t(F0), _t(xy1[sidx]), _t(xy2[sidx]), _t(xy1),
                                     _t(xy2), torch.from_numpy(valid),
                                     torch.tensor(th4), u_h, u_pp)
    assert bool(dt) == bool(dj)
    np.testing.assert_allclose(float(Jt), float(Jj), rtol=1e-3)
    if sample == "mixed":
        np.testing.assert_allclose(_unit(Ft.numpy()), _unit(np.asarray(Fj)), atol=1e-3)
        return
    # the plane-and-parallax F is the best of 256 epipoles from pairs of
    # off-plane lines, several of which score within rounding of the best,
    # so which one wins is not well conditioned: F is held to what it
    # must do, cover the off-plane points, in both packages
    assert bool(dt)
    for F in (Ft, _t(Fj)):
        d_off = tf.sampson_f_sq(F, _t(xy1[n_plane:n_plane + n_off]),
                                _t(xy2[n_plane:n_plane + n_off])).numpy()
        assert np.sum(d_off < 16.0) >= n_off * 0.6, d_off


# --------------------------------------------------------------------------- #
# loransac_f with the JAX package's draws
# --------------------------------------------------------------------------- #
CASES = {
    "graf_fwd": lambda: (graf_tentatives("fwd"), jconfig.RANSACPars()),
    "graf_rev": lambda: (graf_tentatives("rev"), jconfig.RANSACPars()),
    "two_camera": lambda: (padded(two_camera_tentatives()[0]),
                           jconfig.RANSACPars(err_threshold=2.0, LAFCoef=0.0)),
    "dominant_plane": lambda: (padded(plane_scene_tentatives(85, 8, 15, seed=5)[0]),
                               jconfig.RANSACPars(err_threshold=2.0, LAFCoef=0.0)),
}


@pytest.fixture(scope="module")
def jax_f():
    """JAX's loransac_f on every case, once: (arrays, pars, F, inlier mask,
    the uniforms it drew in order)."""
    out = {}
    with recording_uniforms() as seen:
        for name, make in CASES.items():
            arrays, pars = make()
            start = len(seen)
            r = jf.loransac_f(jax_tentatives(arrays), pars)
            keep = np.asarray(r.tentatives.valid)
            jax.effects_barrier()
            out[name] = (arrays, pars, np.asarray(r.H), keep, seen[start:])
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_loransac_f_with_jax_draws(case, jax_f):
    arrays, pars, Fj, keep_j, _ = jax_f[case]
    draws = JaxDraws(pars.seed)
    r = tf.loransac_f(torch_tentatives(arrays),
                      tconfig.RANSACPars(**dataclasses.asdict(pars)), draws=draws)
    n_t, n_j = int(r.n_inliers), int(keep_j.sum())
    assert within(n_t, n_j), (n_t, n_j)
    assert {"u_sweep", "u_lo", "u_degen_h", "u_degen_pp"} <= set(draws.names)
    if case == "graf_fwd":
        assert n_j == 19
    if case == "graf_rev":
        # 11-14 of the reverse set's 78 correspondences fit one F, from
        # near-singular 7-point samples whose cubic roots round apart
        # (ROADMAP.md C): the counts are held to the envelope, F is not
        # compared
        assert n_j == 14
        return
    np.testing.assert_allclose(_unit(r.H.numpy()), _unit(Fj), atol=1e-3)
    if case == "two_camera":
        assert 70 <= n_t <= 85
    if case == "dominant_plane":
        keep = r.tentatives.valid.numpy()
        assert keep[85:93].sum() >= 4 and keep[:85].sum() >= 68


def test_two_plane_pair_geometry():
    """The pair's grid fits F, each plane its own homography and not the
    other's (by the parallax), and img2 shows img1's texture there."""
    from scipy import ndimage
    img1, img2, F, g = two_plane_pair(160, 200, 3)
    assert img1.shape == img2.shape == (160, 200) and (np.bincount(g.plane) >= 15).all()
    assert epipolar_error(F, g.xy1, g.xy2) < 1e-3
    np.testing.assert_array_equal(g.plane_of(g.xy1, g.xy2), g.plane)
    for i in (0, 1):
        p = np.c_[g.xy1, np.ones(len(g.xy1))] @ g.H[i].T
        off = np.linalg.norm(p[:, :2] / p[:, 2:] - g.xy2, axis=1)[g.plane != i]
        assert np.median(off) > 3.0
    v1, v2 = (ndimage.map_coordinates(im.astype(np.float64), [xy[:, 1], xy[:, 0]], order=1)
              for im, xy in ((img1, g.xy1), (img2, g.xy2)))
    assert np.median(np.abs(v1 - v2)) < 5.0


def test_loransac_f_own_draws_on_two_planes():
    """The port's own generator on the true correspondences of both planes
    of a two_plane_pair with 30 % outliers: F covers both planes (an H
    would fit one) and is the true F within a pixel."""
    _, _, F_true, g = two_plane_pair(160, 200, 3)
    rng = np.random.default_rng(1)
    xy1, xy2 = g.xy1.copy(), g.xy2 + rng.normal(0, 0.3, g.xy2.shape).astype(np.float32)
    n_out = int(0.3 * len(xy1))
    xy2[:n_out] = rng.uniform(0, 160, (n_out, 2))
    arrays = tentative_arrays(xy1, xy2)
    pars = tconfig.RANSACPars(LAFCoef=0.0)
    r = tf.loransac_f(torch_tentatives(arrays), pars,
                      generator=torch.Generator().manual_seed(0))
    keep = r.tentatives.valid.numpy()
    assert all(keep[n_out:][g.plane[n_out:] == i].sum() >= 8 for i in (0, 1))
    assert epipolar_error(r.H.numpy(), g.xy1, g.xy2) <= 1.0
    assert epipolar_error(F_true, g.xy1, g.xy2) < 1e-3


def test_jax_draws_answer_what_loransac_f_draws(jax_f):
    """Every uniform JAX's loransac_f drew on the forward graf set (the
    first core, one adaptive sweep, the second core), in its order, is
    JaxDraws' answer to the port's name."""
    arrays, pars, _, _, seen = jax_f["graf_fwd"]
    assert_draws_answer(JaxDraws(pars.seed), [
        "u_sweep", "u_degen_h", "u_degen_pp", "u_lo", "sweep0",
        "u_sweep2", "u_degen_h2", "u_degen_pp2", "u_lo2"], seen)


# --------------------------------------------------------------------------- #
# match_images with ver_type LORANSACF
# --------------------------------------------------------------------------- #
def test_match_images_loransacf_matches_jax():
    """pre_extracted features of a two-plane scene through both packages'
    match_images with ver_type LORANSACF, one step: the same tentatives,
    inliers within max(2, 3 %), and both planes' matches kept."""
    (j, t), plane = match_images_both("LORANSACF")
    assert t.steps_done == j.steps_done == 1
    assert (t.tentatives, t.unique_tentatives) == (j.tentatives, j.unique_tentatives)
    assert within(t.inliers, j.inliers) and t.inliers >= 15, (t.inliers, j.inliers)
    assert all(plane(t)[i] >= 8 for i in (0, 1)), plane(t)
    assert t.H.shape == (3, 3) and np.isfinite(t.H).all()
