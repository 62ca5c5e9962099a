"""The port's flagship matcher against the JAX flagship on the 96x128
rolled pair, which takes the precropped-window kernels (plain versions on
the CPU), given the JAX program's RANSAC uniforms.

Envelope: n1 and n2 within 1%, tentatives within 2%, inliers within 2 or
3%, whichever is larger (the JAX package's CPU path samples by hat-matrix
contraction over other windows, so a keypoint at a decision threshold may
go the other way).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mods_tpu.config import Config as JConfig
from mods_tpu.models import flagship as jflag
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.models import flagship as tflag
from mods_tpu_torch.testing import rolled_pair

MAX_KP = 256


def run_both(img1, img2, max_kp, max_octave_cands, seed=0):
    """(JAX counts, port counts, JAX H, port H) with shared uniforms."""
    jcfg = JConfig()
    jcfg.max_octave_cands = max_octave_cands
    cfg = from_dict(dataclasses.asdict(jcfg))
    key = jax.random.PRNGKey(seed)
    jout = jflag.match_pair_fn(jcfg, max_kp=max_kp)(jnp.asarray(img1),
                                                    jnp.asarray(img2), key)
    (sb, sm), (lb, lm) = tflag.ransac_draw_shapes(cfg, max_kp)
    k1, k2, _ = jax.random.split(key, 3)
    draws = {"u_sweep": torch.from_numpy(np.array(jax.random.uniform(k1, (sb, sm)))),
             "u_lo": torch.from_numpy(np.array(jax.random.uniform(k2, (lb, lm))))}
    tout = tflag.match_pair(img1, img2, cfg, max_kp, draws=draws, device="cpu")
    counts = lambda out: [int(o) for o in out[1:]]
    return counts(jout), counts(tout), np.asarray(jout[0]), tout[0].numpy()


def check_envelope(j, t):
    """j, t: (inliers, tentatives, n1, n2)."""
    ji, jt, j1, j2 = j
    ti, tt, t1, t2 = t
    assert abs(t1 - j1) <= 0.01 * j1, (t, j)
    assert abs(t2 - j2) <= 0.01 * j2, (t, j)
    assert abs(tt - jt) <= 0.02 * jt, (t, j)
    assert abs(ti - ji) <= max(2, 0.03 * ji), (t, j)


@pytest.fixture(scope="module")
def rolled():
    a, b = rolled_pair()
    return run_both(a, b, MAX_KP, 256)


def test_rolled_pair_counts_match_jax(rolled):
    j, t, _, _ = rolled
    assert j[0] >= 8
    check_envelope(j, t)


def test_rolled_pair_homography_matches_jax(rolled):
    _, _, Hj, Ht = rolled
    assert np.isfinite(Ht).all()
    c = np.array([[0, 0, 1], [127, 0, 1], [0, 95, 1], [127, 95, 1]], float).T
    pj, pt = Hj @ c, Ht @ c
    assert np.abs(pt[:2] / pt[2] - pj[:2] / pj[2]).max() < 0.5


def test_match_pairs_loops_over_pairs():
    a, b = rolled_pair()
    cfg = from_dict(dataclasses.asdict(JConfig()))
    cfg.max_octave_cands = 256
    g = torch.Generator().manual_seed(3)
    H, ninl, nt, n1, n2 = tflag.match_pairs([a, b], [b, a], cfg, MAX_KP,
                                            generator=g, device="cpu")
    assert H.shape == (2, 3, 3) and ninl.shape == (2,)
    assert (n1 > 0).all() and (n2 > 0).all() and (ninl > 0).all()
    assert int(n1[0]) == int(n2[1]) and int(n2[0]) == int(n1[1])


if __name__ == "__main__":
    # PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_flagship.py
    # prints the counts (inliers, tentatives, n1, n2) of both packages on
    # the two parity pairs
    from mods_tpu_torch.testing import warp_pair
    jax.config.update("jax_platforms", "cpu")
    for name, (a, b), kp in (("96x128 rolled", rolled_pair(), MAX_KP),
                             ("256x320 warp", warp_pair(256, 320, 3)[:2], 1024)):
        j, t, _, _ = run_both(a, b, kp, kp)
        print(f"{name}: jax {j} port {t}")
