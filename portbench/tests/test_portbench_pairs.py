"""The frozen pair generators repeat exactly for a seed, and agree today
with the program's testing.py, which they were copied from."""
import numpy as np
import pytest

from pbcore import pairs, spec


@pytest.mark.parametrize("traffic", ["wide_tilt", "mild_warp"])
def test_pool_repeats_for_a_seed(traffic):
    t = spec.traffic(traffic)
    gen = spec.generator(t["generator"])
    params = dict(t["params"], h=96, w=128)
    seed = 2 ** 31 + 977
    a = [gen.make(params, s) for s in pairs.pool_seeds(seed, t["pool"])]
    b = [gen.make(params, s) for s in pairs.pool_seeds(seed, t["pool"])]
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert not np.array_equal(a[0][0], a[1][0])


def test_two_plane_generator_repeats_for_a_seed():
    gen = spec.generator("two_plane_pair")
    a, b = (gen.make(dict(h=96, w=128), 2 ** 31 + 977) for _ in range(2))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    # its third item is the scene's F, of unit norm and rank 2
    assert np.linalg.norm(a[2]) == pytest.approx(1.0)
    assert np.linalg.matrix_rank(a[2], tol=1e-9) == 2


def test_pool_seeds_and_sample():
    s = pairs.pool_seeds(2 ** 31 + 5, 4)
    assert s == pairs.pool_seeds(2 ** 31 + 5, 4) and len(set(s)) == 4
    assert s != pairs.pool_seeds(2 ** 31 + 6, 4)
    assert all(0 <= pairs.sampled_index(x, 4) < 4 for x in range(50))
    assert len({pairs.sampled_index(x, 4) for x in range(50)}) == 4


def test_frozen_copies_match_the_program_today():
    from mods_tpu_torch import testing
    for fn in ("warp_pair", "two_plane_pair"):
        # zip stops at the frozen copy's (img1, img2, H or F): not the grid
        for u, v in zip(getattr(pairs, fn)(64, 80, 3), getattr(testing, fn)(64, 80, 3)):
            np.testing.assert_array_equal(u, v)
    for u, v in zip(pairs.tilted_pair(64, 80, 3, 5.0, 0.3),
                    testing.tilted_pair(64, 80, 3, 5.0, 0.3)):
        np.testing.assert_array_equal(u, v)
    H = pairs.true_homography(64, 80)
    assert pairs.corner_error(H, H, 64, 80) == 0.0
    assert pairs.corner_error(None, H, 64, 80) == float("inf")
