"""Patch sampling, orientation and SIFT of the port against the JAX package,
fed identical keypoints.

Tolerances: patches 2e-3 absolute on 0..255 data.  The JAX package's CPU
path contracts hat matrices over a centred 96x96 crop, the port takes
4-tap samples in the kernels' windows: the same values for every sample
the fit test admits, up to rounding.  The two compute a sample position
by different float formulas ((x + A.(i,j) - shift) / spacing - origin
against (x - shift) / spacing - origin + (A / spacing).(i,j)), which
agree to ~1e-5 px; on the unblurred level, with gradients up to ~100 per
px, that alone moves a sample by up to ~1e-3.  Orientation histograms 1e-4 relative with the same
peaks; quantized SIFT entries within +-1 level on >= 99% of entries
(the descriptors sum thousands of products in another order before
rounding to uint8 levels).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mods_tpu.config import Config as JConfig
from mods_tpu.desc import sift as jsift
from mods_tpu.detect import orientation as jori
from mods_tpu.ops import image as jim
from mods_tpu.ops import patch_engine as jpe
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.desc import sift as tsift
from mods_tpu_torch.detect import orientation as tori
from mods_tpu_torch.ops import image as tim
from mods_tpu_torch.ops import patch_engine as tpe
from mods_tpu_torch.testing import textured_image

JCFG = JConfig()
CFG = from_dict(dataclasses.asdict(JCFG))


def _keypoints(seed, n, h, w, scale):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(4, w - 4, n), rng.uniform(4, h - 4, n)],
                  -1).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, n)
    an = rng.uniform(1.0, 2.5, n)
    s = rng.uniform(0.3, 1.0, n) * scale
    A = np.stack([np.stack([an * np.cos(th), -np.sin(th) / an], -1),
                  np.stack([an * np.sin(th), np.cos(th) / an], -1)], -2)
    A = (A * s[:, None, None]).astype(np.float32)
    valid = rng.uniform(0, 1, n) > 0.15
    return xy, A, valid


@pytest.mark.parametrize("hw", [(96, 128), (128, 288)],
                         ids=["precropped", "dma_window"])
@pytest.mark.parametrize("mode,aa,P", [("fit", "topup", 19),
                                       ("antialias", "topup", 41),
                                       ("antialias", "blend", 41),
                                       ("antialias", "single", 41)])
def test_sample_patches_matches(hw, mode, aa, P):
    h, w = hw
    img = textured_image(h, w, 6)
    jpyr = jpe.build_mip_pyramid(jnp.asarray(img))
    tpyr = tpe.build_mip_pyramid(torch.from_numpy(img))
    np.testing.assert_allclose(tpyr.numpy(), np.asarray(jpyr), rtol=1e-5,
                               atol=1e-3)
    xy, A, valid = _keypoints(7, 64, h, w, 2.5 if P == 19 else 3.0)
    ref = np.asarray(jpe.sample_patches(jpyr, jnp.asarray(xy), jnp.asarray(A),
                                        P, mode=mode, valid=jnp.asarray(valid),
                                        blend=aa))
    got = tpe.sample_patches(tpyr, torch.from_numpy(xy), torch.from_numpy(A), P,
                             mode=mode, valid=torch.from_numpy(valid),
                             blend=aa).numpy()
    # rows the DMA path does not sample (valid=False) are zero there
    np.testing.assert_allclose(got[valid], ref[valid], rtol=0, atol=2e-3)
    assert np.abs(got[valid]).mean() > 10.0


def test_sample_patches_rejects_unknown_aa_mode():
    pyr = torch.zeros((20, 32, 32))
    with pytest.raises(ValueError):
        tpe.sample_patches(pyr, torch.zeros((1, 2)), torch.eye(2)[None], 9,
                           blend="trilinear")


def _patches(n, P, seed):
    """Seeded patches in the range the describers see."""
    img = textured_image(n * P, P, seed)
    return img.reshape(n, P, P)


def test_orientation_matches():
    patches = _patches(200, 19, 8)
    mask = jim.circular_gauss_mask(19, 19 / 3.0)
    jh = np.asarray(jori.orientation_histogram(jnp.asarray(patches),
                                               jnp.asarray(mask)))
    th = tori.orientation_histogram(torch.from_numpy(patches),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-4,
                               atol=1e-4 * np.abs(jh).max())
    jang, jok = jori.dominant_angles(jnp.asarray(jh), 0.8, 8)
    tang, tok = tori.dominant_angles(torch.from_numpy(jh), 0.8, 8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tang.numpy(), np.asarray(jang), atol=1e-5)
    assert int(tok.sum()) > 200
    A = np.random.default_rng(1).uniform(-2, 2, (200, 2, 2)).astype(np.float32)
    jrot = np.asarray(jax.vmap(lambda Ai, angs: jax.vmap(
        lambda a: jori.apply_rotation(Ai, a))(angs))(jnp.asarray(A), jang))
    trot = tori.apply_rotation(torch.from_numpy(A)[:, None], tang).numpy()
    np.testing.assert_allclose(trot, jrot, atol=1e-5)


@pytest.mark.parametrize("kind", ["rootsift", "sift", "halfsift"])
def test_sift_matches(kind):
    patches = _patches(300, 41, 9)
    mask = jim.circular_gauss_mask(41)
    patches = np.asarray(jim.photometric_normalize(jnp.asarray(patches),
                                                   jnp.asarray(mask)))
    tp = tim.photometric_normalize(torch.from_numpy(_patches(300, 41, 9)),
                                   torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(tp, patches, atol=1e-3)
    jpar = getattr(JCFG, kind)
    tpar = getattr(CFG, kind)
    jd = np.asarray(jsift.describe_patches(jnp.asarray(patches), jpar))
    td = tsift.describe_patches(torch.from_numpy(patches), tpar).numpy()
    assert td.shape == jd.shape == (300, tpar.dims)
    diff = np.abs(td - jd)
    assert diff.max() <= 1.0
    assert np.mean(diff == 0) >= 0.99
