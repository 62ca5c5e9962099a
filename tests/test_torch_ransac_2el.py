"""RANSAC-H from two affine correspondences (`ransac_h_2el`) of the port
against the JAX package, on the CPU, on the JAX package's own synthetic
2-AC case (test_homography): the affine rows equal to the bit; with
JAX's uniforms (`JaxDraws`, "2el" tree, checked against what JAX draws)
inliers within max(2, 3 %), H within 1e-3 after scaling by H[2,2].
"""
import numpy as np
import torch

import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu.verify import homography as jh
from mods_tpu_torch import config as tconfig
from mods_tpu_torch.verify import homography as th
from torch_parity_helpers import (JaxDraws, assert_draws_answer, jax_tentatives,
                                  recording_uniforms, torch_tentatives, within)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _two_ac_case():
    """The JAX package's test_homography 2-AC case: 60 LAF-consistent
    inliers of a homography, 30 outliers with junk affines."""
    rng = np.random.default_rng(11)
    Hgt = np.array([[0.95, 0.08, 20.0], [-0.06, 1.05, -12.0], [8e-5, -6e-5, 1.0]])
    n_in, n_out = 60, 30
    n = n_in + n_out
    xy1 = rng.uniform(30, 450, (n, 2)).astype(np.float32)
    ph = np.concatenate([xy1, np.ones((n, 1))], 1) @ Hgt.T
    xy2 = (ph[:, :2] / ph[:, 2:3]).astype(np.float32)
    xy2[n_in:] = rng.uniform(30, 450, (n_out, 2))
    xy2[:n_in] += rng.normal(0, 0.3, (n_in, 2))
    ang = rng.uniform(0, np.pi, n)
    A1 = np.stack([np.stack([np.cos(ang), -np.sin(ang)], -1),
                   np.stack([np.sin(ang), np.cos(ang)], -1)], -2).astype(np.float32)
    w = Hgt[2, 0] * xy1[:, 0] + Hgt[2, 1] * xy1[:, 1] + Hgt[2, 2]
    u, v = xy2[:, 0], xy2[:, 1]
    J = np.stack([np.stack([Hgt[0, 0] - u * Hgt[2, 0], Hgt[0, 1] - u * Hgt[2, 1]], -1),
                  np.stack([Hgt[1, 0] - v * Hgt[2, 0], Hgt[1, 1] - v * Hgt[2, 1]], -1)],
                 -2) / w[:, None, None]
    A2 = np.einsum("nij,njk->nik", J, A1).astype(np.float32)
    A2[n_in:] = A1[n_in:]
    z = np.zeros(n, np.float32)
    return [xy1, xy2, A1, A2, np.ones(n, np.float32), np.ones(n, np.float32), z, z, z,
            np.ones(n, bool)], Hgt, n_in


def test_affine_rows_match():
    arrays, _, _ = _two_ac_case()
    M = np.einsum("nij,njk->nik", arrays[3], np.linalg.inv(arrays[2])).astype(np.float32)
    j = np.asarray(jh._affine_rows(*map(jnp.asarray, (arrays[0], arrays[1], M))))
    t = th._affine_rows(*map(_t, (arrays[0], arrays[1], M))).numpy()
    np.testing.assert_array_equal(t, j)


def test_ransac_h_2el_with_jax_draws():
    arrays, Hgt, n_in = _two_ac_case()
    pars = jconfig.RANSACPars()
    with recording_uniforms() as seen:
        j = jh.ransac_h_2el(jax_tentatives(arrays), pars)
        j_H = np.asarray(j.H)
    # the uniforms JAX drew are JaxDraws' answers to the port's names
    assert_draws_answer(JaxDraws(pars.seed, "2el"), ["u_2el", "u_sweep", "u_lo"], seen)
    draws = JaxDraws(pars.seed, "2el")
    t = th.ransac_h_2el(torch_tentatives(arrays), tconfig.RANSACPars(), draws=draws)
    assert draws.names == ["u_2el", "u_sweep", "u_lo"]
    n_t, n_j = int(t.n_inliers), int(j.n_inliers)
    assert within(n_t, n_j) and n_t >= 0.85 * n_in, (n_t, n_j)
    Ht, Hj = t.H.numpy(), j_H
    np.testing.assert_allclose(Ht / Ht[2, 2], Hj / Hj[2, 2], rtol=1e-3, atol=1e-3)
    pred = np.c_[arrays[0][:n_in], np.ones(n_in)] @ (Ht / Ht[2, 2]).T
    err = np.linalg.norm(pred[:, :2] / pred[:, 2:] - arrays[1][:n_in], axis=1)
    assert np.median(err) < 1.5
