"""FGINN matching, duplicate filtering and LO-RANSAC-H of the port against
the JAX package.

Descriptors are integers (as SIFT's are), so that neighbor distances
tie often.  FGINN's accept decision and second distance do not depend on
the order of tied neighbors after the first; the first one does, and
there the JAX package's CPU approx_min_k returns ties in an order of its
own (not lower index first), while the port takes the lower index as
lax.top_k does.  So the parity inputs have no exact duplicate rows, and
`test_knn_tie_order_lower_index_first` pins the port's rule.
Tolerances: tentatives identical (distances of integer descriptors are
exact in both), but for the ratio sqrt(d1/d2), within 1e-6 relative
(XLA may round the quotient's square root one ulp apart); RANSAC, given the JAX package's uniforms, identical inliers and H
within 1e-3 (relative and absolute) after normalization by H[2,2].
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mods_tpu import types as jtypes
from mods_tpu.config import Config as JConfig
from mods_tpu.match import matching as jm
from mods_tpu.verify import homography as jh
from mods_tpu_torch import types as ttypes
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.match import matching as tm
from mods_tpu_torch.verify import homography as th

JCFG = JConfig()
CFG = from_dict(dataclasses.asdict(JCFG))
FIELDS = ("xy1", "xy2", "A1", "A2", "s1", "s2", "d1", "d2", "ratio", "valid")


def _features(seed, n1=300, n2=280):
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 40, (n1, 128)).astype(np.float32)
    src = rng.permutation(n1)[:n2]
    d2 = d1[src] + rng.integers(-2, 3, (n2, 128))
    d2 = np.clip(d2, 0, 255).astype(np.float32)
    d2[n2 - 30:] = rng.integers(0, 40, (30, 128))
    out = []
    for n, d in ((n1, d1), (n2, d2)):
        xy = rng.uniform(0, 300, (n, 2)).astype(np.float32)
        A = rng.uniform(-1, 1, (n, 2, 2)).astype(np.float32)
        s = rng.uniform(1, 4, n).astype(np.float32)
        r = rng.uniform(0, 50, n).astype(np.float32)
        v = rng.uniform(0, 1, n) > 0.1
        out.append((xy, A, s, r, v, d))
    return out


def _jfeat(xy, A, s, r, v, d):
    kp = jtypes.Keypoints(*[jnp.asarray(a) for a in (xy, A, s, r, v)])
    return jtypes.Features(kp, kp, jnp.asarray(d))


def _tfeat(xy, A, s, r, v, d):
    kp = ttypes.Keypoints(*[torch.from_numpy(a) for a in (xy, A, s, r, v)])
    return ttypes.Features(kp, kp, torch.from_numpy(d))


def _assert_same(t, j):
    for name in FIELDS:
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        if name == "ratio":
            np.testing.assert_allclose(a, b, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def tentatives():
    a, b = _features(3)
    jt = jm.match_fginn(_jfeat(*a), _jfeat(*b), JCFG.matching, 0.8,
                        int_exact=True)
    tt = tm.match_fginn(_tfeat(*a), _tfeat(*b), CFG.matching, 0.8,
                        int_exact=True)
    return jt, tt


def test_match_fginn_identical(tentatives):
    jt, tt = tentatives
    _assert_same(tt, jt)
    assert 50 < int(tt.count()) < tt.m


def test_knn_tie_order_lower_index_first():
    d2 = torch.tensor([[1.0, 0], [0, 0], [1, 0], [1, 0], [0, 0]])
    d1 = torch.tensor([[1.0, 0]])
    valid = torch.tensor([True, True, True, False, True])
    for exact in (True, False):
        dist, idx = tm._knn(d1, d2, valid, 4, exact)
        assert idx.tolist() == [[0, 2, 1, 4]]
        assert dist.tolist() == [[0.0, 0.0, 1.0, 1.0]]
        dist, idx = tm._knn(d1, d2, valid, 5, exact)
        assert idx[0, 4] == 3 and dist[0, 4] == 1e12


def test_knn_float_route_equals_a_stable_sort():
    """The float route's int64 keys (float32 bits and column) give what a
    stable sort of the distances gives: HardNet-like real descriptors with
    repeated rows (zero and tied distances), invalid columns at 1e12, and
    more rows than one block."""
    rng = np.random.default_rng(9)
    d2 = rng.uniform(0, 255, (300, 128)).astype(np.float32)
    d2[150:] = d2[:150]
    d1 = np.concatenate([d2[:40], rng.uniform(0, 255, (4100, 128)).astype(np.float32)])
    valid2 = torch.from_numpy(rng.uniform(0, 1, 300) > 0.1)
    t1, t2 = torch.from_numpy(d1), torch.from_numpy(d2)
    k = 290
    dist, idx = tm._knn(t1, t2, valid2, k, False)
    ref = torch.where(valid2[None, :], tm.distance_matrix_sq(t1, t2), 1e12)
    rd, ri = torch.sort(ref, dim=1, stable=True)
    assert torch.equal(dist, rd[:, :k]) and torch.equal(idx, ri[:, :k])
    assert bool((dist[:40, :-1] == dist[:40, 1:]).any(dim=1).all())   # ties
    assert int((~valid2).sum()) > 300 - k and bool((dist[:, -1] == 1e12).all())


def test_knn_matches_jax_up_to_tie_order():
    """On tie-heavy integer descriptors the port's neighbor lists hold the
    same distances as the JAX package's CPU approx_min_k, and the same
    neighbors below the k-th distance; only the order within a group of
    equal distances may differ (the port's is lower index first)."""
    rng = np.random.default_rng(8)
    d1 = rng.integers(0, 3, (64, 128)).astype(np.float32)
    d2 = rng.integers(0, 3, (300, 128)).astype(np.float32)
    valid2 = rng.uniform(0, 1, 300) > 0.1
    k = 50
    dj = jm.distance_matrix_sq(jnp.asarray(d1), jnp.asarray(d2), True)
    dj = jnp.where(jnp.asarray(valid2)[None, :], dj, jnp.float32(1e12))
    jd, ji = (np.asarray(a) for a in jax.lax.approx_min_k(dj, k,
                                                           recall_target=0.999))
    td, ti = (a.numpy() for a in tm._knn(torch.from_numpy(d1),
                                         torch.from_numpy(d2),
                                         torch.from_numpy(valid2), k, True))
    np.testing.assert_array_equal(td, jd)
    for r in range(64):
        below = td[r] < td[r, -1]
        assert set(ti[r][below]) == set(ji[r][below])
        order = np.lexsort((ti[r], td[r]))      # distance, then index
        np.testing.assert_array_equal(order, np.arange(k))


@pytest.mark.parametrize("mode", ["bestFGINN", "bestDistance", "biggerRegion",
                                  "random"])
@pytest.mark.parametrize("cap", [None, 128])
def test_duplicate_filter_identical(tentatives, mode, cap):
    jt, tt = tentatives
    # pull some matches together so that duplicates exist
    xy1 = np.asarray(jt.xy1).copy()
    xy2 = np.asarray(jt.xy2).copy()
    xy1[1::7] = xy1[0::7][: len(xy1[1::7])] + 1.0
    xy2[1::7] = xy2[0::7][: len(xy2[1::7])] - 1.0
    jt = dataclasses.replace(jt, xy1=jnp.asarray(xy1), xy2=jnp.asarray(xy2))
    tt = dataclasses.replace(tt, xy1=torch.from_numpy(xy1),
                             xy2=torch.from_numpy(xy2))
    jf = jm.duplicate_filter(jt, 3.0, mode, cap=cap)
    tf = tm.duplicate_filter(tt, 3.0, mode, cap=cap)
    _assert_same(tf, jf)
    assert int(tf.count()) < int(tt.count())


def _h_tentatives(seed, M=512):
    rng = np.random.default_rng(seed)
    H = np.array([[0.95, 0.08, 12.0], [-0.06, 1.02, -7.0], [2e-4, -1e-4, 1.0]])
    xy1 = np.stack([rng.uniform(0, 320, M), rng.uniform(0, 256, M)], -1)
    p = H @ np.concatenate([xy1, np.ones((M, 1))], -1).T
    xy2 = (p[:2] / p[2]).T + rng.normal(0, 0.4, (M, 2))
    out = rng.uniform(0, 1, M) < 0.4
    xy2[out] = np.stack([rng.uniform(0, 320, out.sum()),
                         rng.uniform(0, 256, out.sum())], -1)
    valid = rng.uniform(0, 1, M) > 0.1
    return xy1.astype(np.float32), xy2.astype(np.float32), valid


@pytest.mark.parametrize("error_type", ["Sampson", "SymmMax", "SymmSum"])
def test_h_errors_match(error_type):
    """Sampson and symmetric transfer errors within 1e-4 relative or
    1e-4 px^2 absolute, and the same NaiveHCheck count.  The formulas
    are the same in float32, but the inverse of H may differ in its last
    bits: on coordinates up to 320 px (float32 spacing ~3e-5 px) that
    moves a transferred point by ~1e-5 px and a squared error near 0.2
    px^2 by ~2e-5."""
    xy1, xy2, valid = _h_tentatives(2, M=200)
    H = np.array([[0.95, 0.08, 12.0], [-0.06, 1.02, -7.0], [2e-4, -1e-4, 1.0]],
                 np.float32)
    ref = np.asarray(jh.h_error_sq(jnp.asarray(H), jnp.asarray(xy1),
                                   jnp.asarray(xy2), error_type))
    got = th.h_error_sq(torch.from_numpy(H), torch.from_numpy(xy1),
                        torch.from_numpy(xy2), error_type).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    z = np.zeros_like(xy1)
    jt = jtypes.Tentatives(*[jnp.asarray(a) for a in (xy1, xy2)],
                           *[jnp.zeros((200, 2, 2))] * 2,
                           *[jnp.asarray(z[:, 0])] * 5, jnp.asarray(valid))
    tt = ttypes.Tentatives(*[torch.from_numpy(a) for a in (xy1, xy2)],
                           *[torch.zeros((200, 2, 2))] * 2,
                           *[torch.from_numpy(z[:, 0])] * 5,
                           torch.from_numpy(valid))
    n_j = int(jh.naive_h_check(jt, jnp.asarray(H), 2.0))
    assert int(th.naive_h_check(tt, torch.from_numpy(H), 2.0)) == n_j > 50


def test_ransac_h_core_with_jax_draws():
    xy1, xy2, valid = _h_tentatives(4)
    M = xy1.shape[0]
    batch, lo_batch = JCFG.ransac.batch_hypotheses, JCFG.ransac.lo_batch
    key = jax.random.PRNGKey(5)
    H_j, inl_j, I_j, J_j = jh._ransac_h_core(
        jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid),
        jnp.float32(4.0), key, batch, lo_batch, "Sampson")
    k1, k2, _ = jax.random.split(key, 3)
    u_sweep = torch.from_numpy(np.array(jax.random.uniform(k1, (batch, M))))
    u_lo = torch.from_numpy(np.array(jax.random.uniform(k2, (lo_batch, M))))
    H_t, inl_t, I_t, J_t = th._ransac_h_core(
        torch.from_numpy(xy1), torch.from_numpy(xy2), torch.from_numpy(valid),
        4.0, batch, lo_batch, u_sweep=u_sweep, u_lo=u_lo)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(I_t) == int(I_j) > 200
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(J_t), float(J_j), rtol=1e-4)


def test_ransac_h_core_own_draws_finds_model():
    xy1, xy2, valid = _h_tentatives(6)
    g = torch.Generator().manual_seed(0)
    H, inl, I, J = th._ransac_h_core(torch.from_numpy(xy1), torch.from_numpy(xy2),
                                     torch.from_numpy(valid), 4.0, 256, 16,
                                     generator=g)
    assert int(I) > 200 and bool(torch.isfinite(H).all())
    assert abs(float(H[2, 2]) - 1.0) < 1e-6


def test_sweep_survives_singular_samples():
    """Collinear points make every pinned 8x8 solve singular: the sweep
    marks those hypotheses non-finite instead of raising, and only the
    eigh-nullspace sub-batch can win."""
    M = 8
    xy = torch.stack([torch.arange(M, dtype=torch.float32),
                      torch.zeros(M)], -1)
    u = torch.rand((64, M), generator=torch.Generator().manual_seed(1))
    H, I, J = th._sweep_h(xy, xy, torch.ones(M, dtype=torch.bool),
                          torch.tensor(1.0), u)
    assert bool(torch.isfinite(H).all()) and int(I) == M
