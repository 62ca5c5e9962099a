"""The port's flagship matcher against the JAX flagship on a 256x320 pair
warped by a known homography, which takes the DMA-window kernels (plain
versions on the CPU), given the JAX program's RANSAC uniforms.  Envelope
as in test_torch_flagship.py; both must also recover the homography
within 1 px at the image corners.
"""
import pytest

from mods_tpu_torch.testing import corner_error, warp_pair
from test_torch_flagship import check_envelope, run_both


@pytest.fixture(scope="module")
def warped():
    img1, img2, H = warp_pair(256, 320, 3)
    return run_both(img1, img2, 1024, 1024) + (H,)


def test_warp_pair_counts_match_jax(warped):
    j, t = warped[:2]
    assert j[0] > 100
    check_envelope(j, t)


def test_warp_pair_recovers_homography(warped):
    _, _, Hj, Ht, H = warped
    assert corner_error(Hj, H, 256, 320) < 1.0
    assert corner_error(Ht, H, 256, 320) < 1.0
