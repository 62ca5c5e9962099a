"""The port's DoG, iiDoG and Harris detectors and Baumberg's Hessian
method against the JAX package.

- dog_response, iidog_response, harris_response and build_octave's DoG,
  iiDoG and Harris stacks: within 1e-5 relative to the largest finite
  value, NaN at the same positions.  Inputs are a seeded textured image
  and a tilted view of one with black corners (`tilted_pair`'s second
  image, 0 outside the warped plane), where iiDoG divides 0 by 0: the JAX
  package gives NaN there and spreads it through the 3x3x3 extremum test,
  and so must the port.
- detect_keypoints for DoG (iiDoG off and on) on the tilted view, Harris
  and Harris with Baumberg's Hessian method on the textured image, held
  against the JAX package's TPU route (its
  Baumberg in Pallas interpret mode, `torch_parity_helpers`): counts
  within 1 %, each keypoint of the JAX package with a port keypoint within
  1e-3 px, and the shapes of those within 1e-4.
- _baumberg_hessian on the localized keypoints of an octave: U within
  1e-4 where both accept, at least 99 % of the accept flags equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu.config import Config as JConfig
from mods_tpu.detect import affine_shape as jaff
from mods_tpu.detect import pyramid as jpyr
from mods_tpu.ops import image as jim
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.detect import affine_shape as taff
from mods_tpu_torch.detect import detector as tdet
from mods_tpu_torch.detect import pyramid as tpyr
from mods_tpu_torch.testing import textured_image, tilted_pair
from torch_parity_helpers import jax_detect_engine

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path on one intra-op thread while this module runs:
    the suite runs several workers on a few cores, and intra-op threads
    here would contend with theirs for small tensors' sake."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


IMAGES = {
    "textured": lambda: textured_image(96, 128, 11),
    "tilted_black_corners": lambda: tilted_pair(96, 128, 12, 2.0, 0.3)[1],
}


def _configs(detector: str, iidog: bool = False, method: str = "SMM"):
    """The JAX package's Config() and the port's copy of it, with
    `detector`'s parameters typed as load_config types them."""
    jcfg = JConfig()
    jcfg.dog.pyramid.detector_type = "DoG"
    jcfg.dog.pyramid.iiDoGMode = iidog
    jcfg.harris.pyramid.detector_type = "Harris"
    for par in (jcfg.hessian, jcfg.dog, jcfg.harris):
        par.affine.method = method
    pick = lambda c: {"DoG": c.dog, "Harris": c.harris, "Hessian": c.hessian}[detector]
    return pick(jcfg), pick(from_dict(dataclasses.asdict(jcfg)))


def _first_level(img):
    sigma = float(np.sqrt(1.6 ** 2 - 0.5 ** 2))
    return np.asarray(jim.gaussian_blur(jnp.asarray(img), sigma))


def assert_close_nan(got, ref, rel=1e-5):
    """NaN at the same positions; elsewhere within rel of the largest
    finite magnitude."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    fin = ~np.isnan(ref)
    scale = max(float(np.max(np.abs(ref[fin]))), 1e-30)
    assert np.max(np.abs(got[fin] - ref[fin])) <= rel * scale


@pytest.mark.parametrize("image", list(IMAGES))
def test_single_level_responses_match(image):
    img = _first_level(IMAGES[image]())
    t = torch.from_numpy(img)
    assert_close_nan(tpyr.dog_response(t, 1.3).numpy(),
                     jpyr.dog_response(jnp.asarray(img), 1.3))
    ref = np.asarray(jpyr.iidog_response(jnp.asarray(img), 1.3))
    assert_close_nan(tpyr.iidog_response(t, 1.3).numpy(), ref)
    if image == "tilted_black_corners":
        assert np.isnan(ref).mean() > 0.2      # 0/0 on the black corners
    assert_close_nan(tpyr.harris_response(t, 2.56).numpy(),
                     jpyr.harris_response(jnp.asarray(img), 2.56))


@pytest.mark.parametrize("image", list(IMAGES))
@pytest.mark.parametrize("kind", ["DoG", "iiDoG", "Harris"])
def test_build_octave_and_extrema_match(kind, image):
    """The blur and response stacks, the 3x3x3 extremum candidates and
    their localization, fed the same first level."""
    jpar, tpar = _configs("Harris" if kind == "Harris" else "DoG", kind == "iiDoG")
    first = _first_level(IMAGES[image]())
    jb, jr, js, jn = jpyr.build_octave(jnp.asarray(first), jpar.pyramid, 1.6)
    tb, tr, ts, tn = tpyr.build_octave(torch.from_numpy(first), tpar.pyramid, 1.6)
    assert ts == js
    assert_close_nan(tb.numpy(), jb)
    assert_close_nan(tr.numpy(), jr)
    assert_close_nan(tn.numpy(), jn)
    if kind == "iiDoG" and image == "tilted_black_corners":
        assert np.isnan(np.asarray(jr)).any()
    # the candidates and their localization on the JAX package's responses
    resp, blurs = torch.from_numpy(np.asarray(jr)), torch.from_numpy(np.asarray(jb))
    jl = jpyr.find_extrema(jr, jpar.pyramid, 400)
    tl = tpyr.find_extrema(resp, tpar.pyramid, 400)
    for a, b in zip(tl[:4], jl[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tl[4] == int(jl[4]) and int(jl[3].sum()) > 5
    jk, jr_, jc_ = jpyr.localize(jr, jb, *jl[:4], jpar.pyramid, js)
    tk, tr_, tc_ = tpyr.localize(resp, blurs, *tl[:4], tpar.pyramid, js)
    v = np.asarray(jk.valid)
    np.testing.assert_array_equal(tk.valid.numpy(), v)
    np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr_))
    np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc_))
    np.testing.assert_allclose(tk.rc.numpy()[v], np.asarray(jk.rc)[v], atol=1e-5)
    np.testing.assert_allclose(tk.response.numpy()[v], np.asarray(jk.response)[v],
                               rtol=1e-5)


def assert_colocated_keypoints(t, j, n_tol=0.01, xy_tol=1e-3, A_tol=1e-4):
    """Counts within n_tol; each JAX keypoint has a port keypoint within
    xy_tol px, and the closest one's shape (of those at the same place)
    within A_tol."""
    tv, jv = t.valid.numpy(), np.asarray(j.valid)
    nt, nj = int(tv.sum()), int(jv.sum())
    assert abs(nt - nj) <= n_tol * nj, (nt, nj)
    xt, xj = t.xy.numpy()[tv], np.asarray(j.xy)[jv]
    At, Aj = t.A.numpy()[tv], np.asarray(j.A)[jv]
    dist = np.linalg.norm(xj[:, None] - xt[None], axis=-1)
    assert dist.min(1).max() <= xy_tol, dist.min(1).max()
    errs = [np.abs(At[dist[i] <= xy_tol] - Aj[i]).max(axis=(1, 2)).min()
            for i in range(nj)]
    assert max(errs) <= A_tol, max(errs)


@pytest.mark.parametrize("case, image", [
    ("DoG", "tilted_black_corners"), ("iiDoG", "tilted_black_corners"),
    ("Harris", "textured"), ("Harris_hessian_method", "textured")])
def test_detect_keypoints_matches_tpu_route(case, image):
    jpar, tpar = _configs("DoG" if "DoG" in case else "Harris", case == "iiDoG",
                          "Hessian" if case.endswith("hessian_method") else "SMM")
    img = IMAGES[image]()
    j = jax_detect_engine(img, jpar, 512, 512, jit=False)
    t = tdet.detect_keypoints(torch.from_numpy(img), tpar, 512, 512)
    assert int(np.asarray(j.valid).sum()) > 10
    assert_colocated_keypoints(t, j)


def test_baumberg_hessian_matches():
    """The Hessian method on an octave's localized keypoints (no Pallas
    kernel in either package: both sample 3x3 patches exactly)."""
    jpar, tpar = _configs("Hessian", method="Hessian")
    first = _first_level(textured_image(96, 128, 13))
    jb, jr, js, _ = jpyr.build_octave(jnp.asarray(first), jpar.pyramid, 1.6)
    jl = jpyr.find_extrema(jr, jpar.pyramid, 400)
    jk, _, _ = jpyr.localize(jr, jb, *jl[:4], jpar.pyramid, js)
    lev = np.asarray(jk.level) - 1
    lx, ly = np.asarray(jk.rc[:, 1]), np.asarray(jk.rc[:, 0])
    ratio = np.asarray(jk.scale) / jpar.affine.initialSigma
    valid = np.asarray(jk.valid)
    jU, jok = jaff._baumberg_hessian(jb, jnp.asarray(lev), jnp.asarray(lx),
                                     jnp.asarray(ly), jnp.asarray(ratio),
                                     jnp.asarray(valid), jpar.affine)
    tU, tok = taff.baumberg_batch(
        torch.from_numpy(np.asarray(jb)), torch.from_numpy(lev), torch.from_numpy(lx),
        torch.from_numpy(ly), torch.from_numpy(ratio), torch.from_numpy(valid),
        tpar.affine)
    jok, tok = np.asarray(jok), tok.numpy()
    assert valid.sum() > 20 and jok.sum() > 5
    assert (jok == tok)[valid].mean() >= 0.99
    both = jok & tok
    np.testing.assert_allclose(tU.numpy()[both], np.asarray(jU)[both], atol=1e-4)
