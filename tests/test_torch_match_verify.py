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


def _padded_pair(columns, route, n1=300, n2=280):
    """Two feature sets whose database side (image 2) has valid columns as
    `columns` says; image 2's descriptors are perturbed copies of image 1's.
    The float route's entries are multiples of 1/64 in [-1, 1] (HardNet's
    range), so that its distances are exact and tie; the others' are
    integers as SIFT's are."""
    rng = np.random.default_rng(17)
    k = CFG.matching.knn
    valid2 = {"scattered": rng.uniform(0, 1, n2) < 0.4,
              "fewer_than_k": np.isin(np.arange(n2), rng.permutation(n2)[:k - 30]),
              "none_valid": np.zeros(n2, bool),
              "all_valid": np.ones(n2, bool)}[columns]
    d1 = rng.integers(0, 40, (n1, 128))
    d2 = np.clip(d1[rng.permutation(n1)[:n2]] + rng.integers(-2, 3, (n2, 128)), 0, 255)
    d2[1::9] = d2[::9][:len(d2[1::9])]           # tied distances
    if route == "float":
        d1, d2 = ((d - 20) / 64.0 for d in (d1, d2))
    out = []
    for n, d, v in ((n1, d1, rng.uniform(0, 1, n1) > 0.1), (n2, d2, valid2)):
        xy = rng.uniform(0, 60, (n, 2)).astype(np.float32)
        A = rng.uniform(-1, 1, (n, 2, 2)).astype(np.float32)
        s = rng.uniform(1, 4, n).astype(np.float32)
        r = rng.uniform(0, 50, n).astype(np.float32)
        out.append(_tfeat(xy, A, s, r, v, d.astype(np.float32)))
    return out


@pytest.mark.parametrize("route", ["int", "float", "distance"])
@pytest.mark.parametrize("columns", ["scattered", "fewer_than_k", "none_valid",
                                     "all_valid"])
def test_kept_columns_give_the_dense_tentatives(columns, route):
    """match_fginn (both kNN routes) and match_distance_threshold, which
    search image 2's valid columns only (plus the first invalid ones where
    fewer than k are valid), give on every field of every row what the
    dense search over all padded columns gives: `_knn`, or the blocked
    argmin, called here on the whole database."""
    f1, f2 = _padded_pair(columns, route)
    par, v2 = CFG.matching, f2.valid
    k = 1 if route == "distance" else min(par.knn, f2.n)
    n_valid = int(v2.sum())
    desc2, valid2, kept = tm._kept_columns(f2.desc, v2, k)
    if columns == "all_valid":
        assert kept is None and desc2 is f2.desc and valid2 is v2
    else:
        assert kept.tolist() == sorted(kept.tolist()) and len(kept) == max(n_valid, k)
        assert torch.equal(desc2, f2.desc[kept]) and int(valid2.sum()) == n_valid
    if route == "distance":
        got = tm.match_distance_threshold(f1, f2, par, 20.0)
        d = torch.where(v2[None, :], tm.distance_matrix_sq(f1.desc, f2.desc), 1e12)
        d0, i0 = d.amin(dim=1), torch.argmin(d, dim=1)
        accept = f1.valid & (d0 <= 20.0 ** 2) & (v2.sum() > 0)
        want = tm._tentatives(f1, f2, accept, i0, d0, d0, ratio=torch.ones_like(d0))
    else:
        got = tm.match_fginn(f1, f2, par, 0.8, int_exact=route == "int")
        dists, idx = tm._knn(f1.desc, f2.desc, v2, k, route == "int")
        f32 = dict(dtype=torch.float32)
        want = tm._tentatives(f1, f2, *tm._fginn_from_knn(
            dists, idx, f1.valid, v2, f2.reproj.xy, torch.tensor(0.8, **f32),
            torch.tensor(par.contradDist, **f32)))
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (int(got.count()) > 0) == (columns != "none_valid")


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


@pytest.fixture
def one_torch_thread():
    """The port's CPU path on one intra-op thread: the suite runs several
    workers on a few cores, and intra-op threads here would contend with
    theirs for small tensors' sake."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrowing_tentatives(m=256, share=0.5, seed=9):
    """A homography's correspondences, half of them outliers, 5 % padding,
    and near-duplicates (the first 16 rows, 0.5 px from rows 16-31 on
    both sides); every row distinct.  Returns (Tentatives, H)."""
    g = torch.Generator().manual_seed(seed)
    H = torch.tensor([[0.9, 0.1, 20.0], [-0.08, 1.05, 5.0], [2e-4, 1e-4, 1.0]])
    xy1 = torch.rand((m, 2), generator=g) * 400.0
    xy1[:16] = xy1[16:32] + 0.5
    p = torch.cat([xy1, torch.ones((m, 1))], 1) @ H.T
    xy2 = p[:, :2] / p[:, 2:]
    out = torch.rand(m, generator=g) > share
    out[:32] = False
    xy2[out] = torch.rand((int(out.sum()), 2), generator=g) * 400.0
    xy2 = xy2 + 0.3 * torch.randn((m, 2), generator=g)
    xy2[:16] = xy2[16:32] + 0.5
    A = torch.eye(2).expand(m, 2, 2).clone()
    s = torch.full((m,), 2.0)
    d1 = torch.rand(m, generator=g) * 100.0
    d2 = d1 + torch.rand(m, generator=g) * 100.0 + 1.0
    valid = torch.rand(m, generator=g) > 0.05
    valid[:32] = True
    t = ttypes.Tentatives(xy1, xy2, A, A.clone(), s, s.clone(), d1, d2,
                          torch.sqrt(d1 / d2), valid)
    return t, H.numpy()


@pytest.mark.parametrize("verifier", ["loransac_h", "hmatrix_filter",
                                      "ransac_h_2el", "orsa_filter",
                                      "loransac_f", "duplicate_filter"])
def test_verifiers_narrow_only_valid(verifier, one_torch_thread):
    """A verifier's or the duplicate filter's output is its input with a
    narrower `valid`: every other field is the input's own tensor (the
    duplicate filter's, the input's rows in its quality order), and no
    row becomes valid that was not."""
    from mods_tpu_torch.verify import fundamental as tf
    from mods_tpu_torch.verify import orsa as to
    t, H = _narrowing_tentatives()
    pars = CFG.ransac
    g = torch.Generator().manual_seed(0)
    out = {"loransac_h": lambda: th.loransac_h(t, pars, generator=g).tentatives,
           "hmatrix_filter": lambda: th.hmatrix_filter(t, H, pars),
           "ransac_h_2el": lambda: th.ransac_h_2el(t, pars, generator=g).tentatives,
           "orsa_filter": lambda: to.orsa_filter(t, pars, 400, 400,
                                                 generator=g).tentatives,
           "loransac_f": lambda: tf.loransac_f(t, pars, generator=g).tentatives,
           "duplicate_filter": lambda: tm.duplicate_filter(t, 3.0)}[verifier]()
    assert type(out) is ttypes.Tentatives
    if verifier == "duplicate_filter":
        same = ((out.xy1[:, None] == t.xy1[None]).all(-1)
                & (out.xy2[:, None] == t.xy2[None]).all(-1))
        assert bool((same.sum(1) == 1).all())
        perm = same.to(torch.uint8).argmax(1)
        assert len(set(perm.tolist())) == t.m
        for name in FIELDS[:-1]:
            assert torch.equal(getattr(out, name), getattr(t, name)[perm]), name
        before = t.valid[perm]
    else:
        for name in FIELDS[:-1]:
            assert getattr(out, name) is getattr(t, name), name
        before = t.valid
    assert out.valid.dtype == torch.bool and out.valid.shape == before.shape
    assert not bool((out.valid & ~before).any())
    assert 0 < int(out.valid.sum()) < int(before.sum())
