"""Ellipse overlap and repeatability (`ops/ellipse.py`) of the port: the JAX
package's own cases (test_ellipse), and parity with it on random affine
keypoints, on the CPU.

Tolerances: overlap distances 1e-5 relative (1e-4 absolute near 0), the
same +inf entries; reprojected centres, affines and scales 1e-5 relative;
repeatability counts equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu.ops import ellipse as je
from mods_tpu.types import Keypoints as JKeypoints
from mods_tpu_torch.ops import ellipse as te
from mods_tpu_torch.types import Keypoints


def _arrays(xy, A=None, s=None, valid=None):
    n = len(xy)
    A = np.tile(np.eye(2, dtype=np.float32), (n, 1, 1)) if A is None else A
    s = np.full(n, 2.0, np.float32) if s is None else s
    valid = np.ones(n, bool) if valid is None else valid
    return [np.asarray(xy, np.float32), np.asarray(A, np.float32),
            np.asarray(s, np.float32), np.ones(n, np.float32), np.asarray(valid)]


def _kp(*args, **kw):
    return Keypoints(*[torch.from_numpy(a) for a in _arrays(*args, **kw)])


def _jkp(arrays):
    return JKeypoints(*[jnp.asarray(a) for a in arrays])


def _random_set(rng, n, invalid=0.1):
    """Keypoints with random unit-det affines (anisotropy up to 3) and
    scales 1-6 over a 300 x 200 image, some invalid."""
    th, ph = rng.uniform(0, np.pi, (2, n))
    r = rng.uniform(1.0, 3.0, n)
    R = lambda a: np.stack([np.stack([np.cos(a), -np.sin(a)], -1),
                            np.stack([np.sin(a), np.cos(a)], -1)], -2)
    D = np.zeros((n, 2, 2))
    D[:, 0, 0], D[:, 1, 1] = np.sqrt(r), 1 / np.sqrt(r)
    A = R(th) @ D @ R(ph)
    return _arrays(rng.uniform([0, 0], [300, 200], (n, 2)), A,
                   rng.uniform(1, 6, n), rng.uniform(0, 1, n) > invalid)


# the JAX package's cases, on the port
def test_identical_ellipses_zero_distance():
    k = _kp([[50.0, 60.0], [100.0, 30.0]])
    D = te.ellipse_overlap_matrix(k, k).numpy()
    assert D[0, 0] < 1e-5 and D[1, 1] < 1e-5
    assert D[0, 1] > 1.0


def test_shape_discrepancy_grows_with_anisotropy():
    k1 = _kp([[50.0, 50.0]])
    d = [float(te.ellipse_overlap_matrix(
        k1, _kp([[50.0, 50.0]], A=np.array([[[a, 0.0], [0.0, 1 / a]]])))[0, 0])
        for a in (1.5, 2.5)]
    assert 0 < d[0] < d[1]


def test_rotation_of_circle_is_free():
    th = 0.7
    R = np.array([[[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]])
    assert float(te.ellipse_overlap_matrix(_kp([[50.0, 50.0]]),
                                           _kp([[50.0, 50.0]], A=R))[0, 0]) < 1e-4


def test_reproject_h_affine():
    H = np.array([[1.2, 0.1, 5.0], [-0.05, 0.9, -3.0], [0, 0, 1.0]])
    k = _kp([[10.0, 20.0], [40.0, 15.0]])
    r = te.reproject_keypoints_h(k, H)
    exp = (np.c_[k.xy.numpy(), np.ones(2)] @ H.T)[:, :2]
    np.testing.assert_allclose(r.xy.numpy(), exp, atol=1e-4)
    np.testing.assert_allclose(np.abs(np.linalg.det(r.A.numpy())), 1.0, atol=1e-4)


def test_repeatability_perfect_under_identity():
    k = _kp(np.random.default_rng(0).uniform(20, 200, (30, 2)))
    assert te.repeatability(k, k, np.eye(3)) == (30, 30, 30)


# parity with the JAX package
H_TEST = np.array([[0.95, 0.08, 12.0], [-0.05, 1.02, -6.0], [1e-4, -5e-5, 1.0]])


@pytest.mark.parametrize("seed", [0, 1])
def test_overlap_matrix_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ref, tst = _random_set(rng, 90), _random_set(rng, 70)
    # some test regions near copies of reference ones, so small distances occur
    tst[0][:30] = ref[0][:30] + rng.normal(0, 0.5, (30, 2))
    tst[1][:30], tst[2][:30] = ref[1][:30], ref[2][:30] * 1.1
    j = np.asarray(je.ellipse_overlap_matrix(_jkp(ref), _jkp(tst)))
    t = te.ellipse_overlap_matrix(Keypoints(*map(torch.from_numpy, ref)),
                                  Keypoints(*map(torch.from_numpy, tst))).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    ok = np.isfinite(j)
    np.testing.assert_allclose(t[ok], j[ok], rtol=1e-5, atol=1e-4)
    assert (j[ok] < 0.3).sum() >= 10


def test_reproject_keypoints_h_matches_jax():
    arrays = _random_set(np.random.default_rng(2), 64)
    j = je.reproject_keypoints_h(_jkp(arrays), H_TEST)
    t = te.reproject_keypoints_h(Keypoints(*map(torch.from_numpy, arrays)), H_TEST)
    for f in ("xy", "A", "s"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


def test_repeatability_matches_jax():
    """Test regions = reference regions mapped by H (with noise), plus
    extras: the greedy assignment counts equal in both packages."""
    rng = np.random.default_rng(4)
    ref = _random_set(rng, 80, invalid=0.0)
    Hi = np.linalg.inv(H_TEST)
    mapped = te.reproject_keypoints_h(Keypoints(*map(torch.from_numpy, ref)), Hi)
    tst = [np.array(getattr(mapped, f).numpy()) for f in ("xy", "A", "s", "response",
                                                            "valid")]
    tst[0] += rng.normal(0, 0.3, tst[0].shape).astype(np.float32)
    extra = _random_set(rng, 40)
    tst = [np.concatenate([a, b]) for a, b in zip(tst, extra)]
    j = je.repeatability(_jkp(ref), _jkp(tst), H_TEST)
    t = te.repeatability(Keypoints(*map(torch.from_numpy, ref)),
                         Keypoints(*map(torch.from_numpy, tst)), H_TEST)
    assert t == tuple(j) and t[0] >= 40, (t, j)
