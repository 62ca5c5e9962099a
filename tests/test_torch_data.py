"""The port's patch-pair generator (mods_tpu_torch/desc/data.py) against
the JAX package's (mods_tpu/desc/data.py), on the CPU.

Tolerances:
- base images, textures and every numpy draw (`_jitter_frames`,
  `_photometric`, `_random_homography`, `_aa_preblur`,
  `_photometric_image`, `_correspondences`): equal, bit for bit (numpy and
  cv2 on both sides, one Generator in one order);
- `detect_anchor_frames` on two 128x128 base images against the JAX
  package's jitted TPU route (its Config(), the Pallas kernels in
  interpret mode): counts equal, rows in order, xy 1e-2 px, A 1e-3, s
  1e-4 of the largest (the test says why these are wider than the
  detector tests' 1e-3 / 1e-4 against the op-by-op route);
- `_sample`: 2e-3 on the 0..255 scale (the patch-engine tests', blend
  anti-aliasing);
- `generate_pairs`, both packages given the same frames: ids and keep
  masks equal, patches within 2e-3 * 1.4 (the largest photometric gain);
- `_deep_patches`: rounded patches equal but for flips of 1 on at most
  0.1 % of the pixels (the CNN tests');
- `generate_pairs_pipeline`, both packages given the same frames: ids
  equal, patches as `_deep_patches`.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu.config import Config as JConfig
from mods_tpu.desc import data as jdata
from mods_tpu.ops import patch_engine as jpe
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.desc import data as tdata
from mods_tpu_torch.ops import patch_engine as tpe
from mods_tpu_torch.testing import deep_config
from torch_parity_helpers import one_torch_thread, tpu_route_detection  # noqa: F401

SIZE = 128


@pytest.fixture(scope="module")
def bases():
    """Two 128x128 base images with texture enough for Config()'s Hessian
    threshold (collage tiles 18 and 20: 79 and 101 detections; the first
    tiles give none at this size)."""
    return tdata.make_base_images(21, size=SIZE, include_graf=False)[18::2]


@pytest.fixture(scope="module")
def jax_frames(bases):
    """The JAX package's detect_anchor_frames on each base image, on its TPU
    route with its Config() in place of the reference's INIs."""
    with pytest.MonkeyPatch.context() as mp:
        tpu_route_detection(mp)
        mp.setattr(jconfig, "load_config", lambda *a, **k: JConfig())
        return [jdata.detect_anchor_frames(img) for img in bases]


def test_make_base_images_equal():
    got = tdata.make_base_images(6, size=SIZE, include_graf=False)
    ref = jdata.make_base_images(6, size=SIZE, include_graf=False)
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32 and g.shape == (SIZE, SIZE)
        np.testing.assert_array_equal(g, r)
    assert tdata._discover_photos(8) == jdata._discover_photos(8)


@pytest.mark.parametrize("name", ["_perlin_like", "_shapes", "_text_texture",
                                  "_lines_texture"])
def test_textures_equal(name):
    """The procedural textures (make_base_images draws them once the
    collage and the photos run out) from one seed."""
    got = getattr(tdata, name)(np.random.default_rng(5), 96)
    ref = getattr(jdata, name)(np.random.default_rng(5), 96)
    np.testing.assert_array_equal(got, ref)
    assert got.std() > 5.0


def _frames(seed, n=40):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(10, SIZE - 10, (n, 2)).astype(np.float32)
    th = rng.uniform(-np.pi, np.pi, n)
    A = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2).astype(np.float32)
    s = rng.uniform(1.5, 4.0, n).astype(np.float32)
    return xy, A, s


def _draws(mod, name, seed, img):
    """What `name` of module `mod` returns from default_rng(seed) (on `img`
    where it takes an image), and one draw after it (the Generator's state
    must match too)."""
    rng = np.random.default_rng(seed)
    if name == "_jitter_frames":
        xy, A, s = _frames(seed)
        out = mod._jitter_frames(rng, A, s, xy, max_rot=0.2)
    elif name == "_photometric":
        out = mod._photometric(rng, _frames(seed)[1].repeat(16, 1).reshape(40, 8, 8) * 90)
    elif name == "_random_homography":
        out = [mod._random_homography(rng, SIZE) for _ in range(12)]
        out = [h for h, _ in out] + [aa for _, aa in out if aa is not None]
    elif name == "_aa_preblur":
        out = [mod._aa_preblur(img, aa) for aa in (None, (1.1, 0.3), (2.5, 0.7),
                                                    (5.0, 2.0))]
    elif name == "_photometric_image":
        out = [mod._photometric_image(rng, img) for _ in range(6)]
    else:
        H = np.array([[0.9, 0.1, 5.0], [-0.05, 1.1, -3.0], [1e-4, -2e-4, 1.0]])
        xy1, _, s1 = _frames(seed, 80)
        ph = np.concatenate([xy1, np.ones((80, 1))], 1) @ H.T
        xy2 = (ph[:, :2] / ph[:, 2:]) + rng.normal(0, 0.5, (80, 2))
        out = [mod._correspondences(rng, xy1, s1, xy2[::-1].copy(), s1[::-1] * 1.1, H),
               mod._correspondences(rng, xy1[:0], s1[:0], xy2, s1, H)]
    return out, rng.random()


@pytest.mark.parametrize("name", ["_jitter_frames", "_photometric", "_random_homography",
                                  "_aa_preblur", "_photometric_image",
                                  "_correspondences"])
def test_numpy_draws_equal(name, bases):
    got, g_next = _draws(tdata, name, 7, bases[0])
    ref, r_next = _draws(jdata, name, 7, bases[0])
    assert g_next == r_next
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    if name == "_correspondences":
        assert len(got[0]) > 20 and got[1].shape == (0, 2)


def test_detect_anchor_frames_matches_jax(bases, jax_frames):
    """Two 128x128 base images: Config().hessian in both packages (JAX's
    load_config answers its Config()), max_kp 512 from 2048 candidates an
    octave; the same count and row order, xy within 1e-2 px, A within
    1e-3, s within 1e-4 of the largest.  The JAX detection is its jitted
    TPU route, which trains there; XLA's fusions move it from the JAX
    package's own op-by-op detection by up to 4e-3 px and 1.4e-4 in A on
    these images, where the port agrees with the op-by-op one to 4e-6
    (test_torch_pipeline holds detect_keypoints to that at 1e-3)."""
    for img, (jxy, jA, js) in zip(bases, jax_frames):
        xy, A, s = tdata.detect_anchor_frames(img, device="cpu")
        assert len(js) > 30 and len(s) == len(js), (len(s), len(js))
        np.testing.assert_allclose(xy, jxy, rtol=0, atol=1e-2)
        np.testing.assert_allclose(A, jA, rtol=0, atol=1e-3)
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-4 * js.max())


def test_sample_matches_jax(bases, jax_frames):
    img = bases[0]
    xy, A, s = jax_frames[0]
    got = tdata._sample(img, xy, A, s, device="cpu")
    ref = jdata._sample(img, xy, A, s)
    assert got.shape == ref.shape == (len(s), 32, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    assert got.std() > 10.0
    # the blend anti-aliasing, not the port's default topup
    topup = tpe.sample_patches(
        tpe.build_mip_pyramid(torch.from_numpy(img)), torch.from_numpy(xy),
        torch.from_numpy(A * (s * 11.0 / 32)[:, None, None]), 32).numpy()
    assert np.abs(topup - ref).max() > 1e-2


def _same_frames(monkeypatch, bases, frames):
    """Both packages' make_base_images answer `bases`, and their
    detect_anchor_frames the JAX package's frames of the image given."""
    table = {img.tobytes(): f for img, f in zip(bases, frames)}
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "make_base_images",
                            lambda *a, **k: [b.copy() for b in bases])
        monkeypatch.setattr(mod, "detect_anchor_frames",
                            lambda img, *a, **k: table[img.tobytes()])


def test_generate_pairs_matches_jax(monkeypatch, bases, jax_frames):
    _same_frames(monkeypatch, bases, jax_frames)
    a, p, i = tdata.generate_pairs(256, seed=3, n_images=2, include_graf=False,
                                   device="cpu")
    ja, jp, ji = jdata.generate_pairs(256, seed=3, n_images=2, include_graf=False)
    np.testing.assert_array_equal(i, ji)
    assert a.shape == ja.shape == p.shape == (256, 32, 32) and i.dtype == np.int64
    np.testing.assert_allclose(a, ja, rtol=0, atol=2e-3 * 1.4)
    np.testing.assert_allclose(p, jp, rtol=0, atol=2e-3 * 1.4)
    # drawn with replacement: duplicate ids
    assert len(np.unique(i)) < len(i) and a.std(axis=(1, 2)).min() > 4.0


def _flips_ok(got, ref):
    d = np.abs(got - ref)
    assert d.max() <= 1.0 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def _deep_cfgs(route):
    jcfg = JConfig()
    jcfg.patch_source = route
    cfg = from_dict(dataclasses.asdict(jcfg))
    return jcfg, cfg


@pytest.mark.parametrize("route", ["engine", "reference"])
def test_deep_patches_match_jax(route, bases, jax_frames):
    """Given frames: the engine route with the blend anti-aliasing (the
    JAX package's _cnn_patches_jit default) and the reference route."""
    jcfg, cfg = _deep_cfgs(route)
    img = bases[1]
    xy, A, s = jax_frames[1]
    dimg = torch.from_numpy(img)
    pyr = tpe.build_mip_pyramid(dimg) if route == "engine" else None
    got = tdata._deep_patches(dimg, pyr, xy, A, s, cfg)
    jimg = jnp.asarray(img)
    jpyr = jpe.build_mip_pyramid(jimg) if route == "engine" else None
    ref = np.asarray(jdata._deep_patches(jimg, jpyr, xy, A, s, jcfg))
    assert got.shape == ref.shape == (len(s), 32, 32)
    assert (got == np.round(got)).all() and got.std() > 10.0
    _flips_ok(got, ref)


def test_generate_pairs_pipeline_matches_jax(monkeypatch, bases):
    """The two base images (`bases`) and three warped views of each at
    128x128, both packages given
    the same deep frames (the port's detection, AffNet and OriNet at random
    weights, on each view): every draw, warp, correspondence, keep and id
    equal, patches as _deep_patches."""
    monkeypatch.setenv("MODS_TPU_ALLOW_RANDOM_CNN", "1")
    cfg = deep_config()
    cfg.patch_source = "engine"
    cfg.affnet.weights = cfg.orinet.weights = "absent.pth"
    jcfg = JConfig()
    jcfg.patch_source = "engine"
    table, port_deep_frames = {}, tdata._deep_frames

    def shared(img):
        key = img.tobytes()
        if key not in table:
            table[key] = port_deep_frames(img, cfg, 256, "cpu")[2:]
        return table[key]

    def port_frames(img, c, max_kp, device=None):
        d = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        return (d, tpe.build_mip_pyramid(d), *shared(img))

    def jax_deep_frames(img, c, max_kp):
        d = jnp.asarray(img)
        return (d, jpe.build_mip_pyramid(d), *shared(img))

    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "make_base_images",
                            lambda *a, **k: [b.copy() for b in bases])
    monkeypatch.setattr(tdata, "_deep_frames", port_frames)
    monkeypatch.setattr(jdata, "_deep_frames", jax_deep_frames)
    monkeypatch.setattr(jconfig, "load_config", lambda *a, **k: jcfg)
    a, p, i = tdata.generate_pairs_pipeline(10_000, seed=4, n_images=2,
                                            views_per_image=3, max_kp=256, size=SIZE,
                                            cfg=cfg, device="cpu")
    ja, jp, ji = jdata.generate_pairs_pipeline(10_000, seed=4, n_images=2,
                                               views_per_image=3, max_kp=256, size=SIZE)
    np.testing.assert_array_equal(i, ji)
    assert len(i) > 10 and a.shape == ja.shape == (len(i), 32, 32)
    _flips_ok(a, ja)
    _flips_ok(p, jp)
