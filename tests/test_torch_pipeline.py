"""The port's per-view chain against the JAX package: the detector's
octave loop, orientation and descriptor patches, extract_view on both
patch routes, and the step atlas.

The port's Baumberg always has the kernels' semantics (their plain
versions here).  The JAX package's `detect_keypoints` takes the exact
gather sampler on the CPU and the Pallas kernels only on a TPU, so the
port's `detect_keypoints` is held against the JAX octave loop run with
`engine="pallas"` (its kernels in interpret mode, `torch_parity_helpers`)
and `_select_sort_jit`: the same keypoints in the same order, positions,
shapes and scales within 1e-3, responses within 1e-5 relative.  Patches within 1e-3 on 0..255 (XLA and PyTorch may
round a sample position one ulp apart).  Where a stage downstream of
detection is compared, both packages get the same keypoints; extract_view
and the atlas with their own detection are compared with the JAX package
on its TPU route's detection (`tpu_route_detection`): extract_view's
counts within 1%, the atlas's rows equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu import pipeline as jpipe
from mods_tpu.config import Config as JConfig
from mods_tpu.detect import detector as jdet
from mods_tpu.detect import orientation as jori
from mods_tpu.ops import patches as jpatches
from mods_tpu.synth import atlas as jatlas
from mods_tpu.synth import vs as jvs
from mods_tpu_torch import pipeline as tpipe
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.detect import detector as tdet
from mods_tpu_torch.detect import orientation as tori
from mods_tpu_torch.ops import patches as tpatches
from mods_tpu_torch.synth import atlas as tatlas
from mods_tpu_torch.synth import vs as tvs
from mods_tpu_torch.testing import mods_schedule, textured_image
from torch_parity_helpers import jax_detect_engine, to_jax_kp, tpu_route_detection

def assert_same_keypoints(t, j, tol=1e-3):
    v = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), v)
    for f, rtol in (("xy", 0), ("A", 0), ("s", tol), ("response", 1e-5)):
        np.testing.assert_allclose(getattr(t, f).numpy()[v], np.asarray(getattr(j, f))[v],
                                   atol=tol if rtol == 0 else 0, rtol=rtol, err_msg=f)


@pytest.mark.parametrize("case", ["fixed_th", "reg_number_tilt4", "upscaled"])
def test_detect_keypoints_matches_engine_octave_loop(case):
    """FixedTh on a 96x128 image; FixedRegNumber at tilt 4, where the
    region count is rescaled to floor(200 / 4); the doubled input image."""
    jcfg = JConfig()
    par = jcfg.hessian
    h, w, tilt = 96, 128, 1.0
    if case == "reg_number_tilt4":
        par.pyramid.detector_mode = "FixedRegNumber"
        par.pyramid.reg_number = 200
        tilt = 4.0
    if case == "upscaled":
        par.pyramid.upscaleInputImage = 1
        h, w = 48, 64
    tpar = from_dict(dataclasses.asdict(jcfg)).hessian
    img = textured_image(h, w, 21)
    j = jax_detect_engine(img, par, 512, 512, tilt=tilt, jit=False)
    t = tdet.detect_keypoints(torch.from_numpy(img), tpar, 512, 512, tilt=tilt)
    assert_same_keypoints(t, j)
    n = int(t.valid.sum())
    assert n == 50 if case == "reg_number_tilt4" else n > 40


def test_octave_cap_schedule_matches():
    for cands, n in ((8192, 7), (4096, 3), (100, 2)):
        assert tdet.octave_cap_schedule(cands, n) == jdet.octave_cap_schedule(cands, n)


def _keypoints(seed, n, h, w):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(8, w - 8, n), rng.uniform(8, h - 8, n)], -1)
    th = rng.uniform(-3, 3, n)
    an = rng.uniform(1, 2, n)
    A = np.stack([np.stack([np.cos(th) * an, -np.sin(th) / an], -1),
                  np.stack([np.sin(th) * an, np.cos(th) / an], -1)], -2)
    s = rng.choice([0.8, 1.5, 3.0, 6.0, 12.0], n) * rng.uniform(0.9, 1.1, n)
    return [a.astype(np.float32) for a in (xy, A, s)]


def test_orientation_patches_match():
    img = textured_image(100, 120, 8)
    xy, A, s = _keypoints(1, 40, 100, 120)
    ref = np.asarray(jori.orientation_patches(jnp.asarray(img), jnp.asarray(xy),
                                              jnp.asarray(A), jnp.asarray(s), 5.196, 19))
    got = tori.orientation_patches(*[torch.from_numpy(a) for a in (img, xy, A, s)],
                                   5.196, 19)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("fast,photo_norm", [(False, True), (True, False)],
                         ids=["two_stage_normalized", "fast"])
def test_extract_patches_host_matches(fast, photo_norm):
    """Keypoints of every size bucket and of the single-stage route."""
    img = textured_image(120, 150, 3)
    xy, A, s = _keypoints(2, 40, 120, 150)
    ref = jpatches.extract_patches_host(jnp.asarray(img), xy, A, s, 5.1962, 41,
                                        photo_norm, fast=fast)
    got = tpatches.extract_patches_host(*[torch.from_numpy(a) for a in (img, xy, A, s)],
                                        5.1962, 41, photo_norm, fast=fast)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)
    if not fast:
        k = tpatches.patch_image_size(torch.from_numpy(s), 5.1962).numpy() / 41
        assert (k <= 0.4).any() and (k > 0.4).any()


def _pair_cfgs(patch_source):
    jcfg = JConfig()
    jcfg.max_keypoints = jcfg.max_octave_cands = 512
    jcfg.patch_source = patch_source
    return jcfg, from_dict(dataclasses.asdict(jcfg))


def _count(f):
    return int(np.asarray(f.count()))


@pytest.mark.parametrize("patch_source", ["engine", "reference"])
def test_extract_view_matches(patch_source, monkeypatch):
    """A tilt-2 view of a 120x160 image.  Given the same keypoints, both
    packages keep the same rows at every filter, their descriptors agree
    to within one quantization level in 0.5% of the entries at most; with
    their own detection, the counts within 1%."""
    jcfg, cfg = _pair_cfgs(patch_source)
    img = textured_image(120, 160, 9)
    sj = jvs.generate_synth_view(jnp.asarray(img), 2.0, 0.6, 1.0, 0.5, True, 1)
    st = tvs.generate_synth_view(torch.from_numpy(img), 2.0, 0.6, 1.0, 0.5, True, 1)
    kp = tdet.detect_keypoints(st.pixels, cfg.hessian, 512, 512, tilt=2.0)
    args = (160, 120)
    j = jpipe.extract_view(sj.pixels, sj.H, *args, jcfg, "HessianAffine", ["RootSIFT"],
                           tilt=2.0, keypoints=to_jax_kp(kp))
    t = tpipe.extract_view(st.pixels, st.H, *args, cfg, "HessianAffine", ["RootSIFT"],
                           tilt=2.0, keypoints=kp)
    for name, tf, jf in (("regions", t.regions, j.regions),
                         ("RootSIFT", t.by_desc["RootSIFT"], j.by_desc["RootSIFT"])):
        assert_same_keypoints(tf.det, jf.det)
        assert_same_keypoints(tf.reproj, jf.reproj)
    dt = t.by_desc["RootSIFT"].desc.numpy()
    dj = np.asarray(j.by_desc["RootSIFT"].desc)
    assert np.abs(dt - dj).max() <= 1.0 and (dt != dj).mean() <= 0.005
    assert _count(t.by_desc["RootSIFT"]) > 50

    tpu_route_detection(monkeypatch)
    j = jpipe.extract_view(sj.pixels, sj.H, *args, jcfg, "HessianAffine", ["RootSIFT"],
                           tilt=2.0)
    t = tpipe.extract_view(st.pixels, st.H, *args, cfg, "HessianAffine", ["RootSIFT"],
                           tilt=2.0)
    for tf, jf in ((t.regions, j.regions), (t.by_desc["RootSIFT"], j.by_desc["RootSIFT"])):
        assert abs(_count(tf) - _count(jf)) <= 0.01 * _count(jf)


def test_extract_step_atlas_matches(monkeypatch):
    """Step 1 of mods_schedule (15 views) of an 80x96 image: the same
    valid keypoints, regions and described rows, at the same atlas
    positions within 5e-3 px (the JAX package's detection here is one
    jitted program, and XLA fuses its sub-pixel 3x3 solves: positions up to
    2.7e-3 px apart where op by op they agree to 1e-5)."""
    jcfg, cfg = _pair_cfgs("engine")
    img = textured_image(80, 96, 10)
    s = mods_schedule()[1].detectors["HessianAffine"]
    args = (s["scale_set"], s["tilt_set"], s["phi"], s["descriptors"], s["fginn"],
            s["dist"], s["init_sigma"], s["do_blur"])
    views, _ = tvs.set_vs_pars(*args, [dataclasses.replace(v) for v in
                                       tvs.set_vs_pars(*args[:1], [1.0], *args[2:], [])[0]])
    assert tatlas.atlas_eligible(cfg, "HessianAffine", views, "cpu")
    assert not tatlas.atlas_eligible(_pair_cfgs("reference")[1], "HessianAffine", views,
                                     "cpu")
    tpu_route_detection(monkeypatch)
    rj, dj = jatlas.extract_step_atlas(jnp.asarray(img), jcfg, "HessianAffine", views,
                                       96, 80)
    rt, dt = tatlas.extract_step_atlas(torch.from_numpy(img), cfg, "HessianAffine",
                                       views, 96, 80)
    plan = tatlas.plan_step_atlas(96, 80, views)

    def per_view(f):
        vid = np.searchsorted(plan.y_end, np.asarray(f.det.xy)[:, 1], side="right")
        return np.bincount(vid[np.asarray(f.valid)], minlength=len(views))

    for tf, jf in ((rt, rj), (dt["RootSIFT"], dj["RootSIFT"])):
        v = np.asarray(jf.valid)
        np.testing.assert_array_equal(tf.valid.numpy(), v)
        np.testing.assert_allclose(tf.det.xy.numpy()[v], np.asarray(jf.det.xy)[v],
                                   atol=5e-3, rtol=0)
    assert per_view(rt).min() > 0 and per_view(dt["RootSIFT"]).sum() > 50


def test_keypoint_containers_match_jax():
    """concat / pad / compact (stable, valid first), the empty
    constructors and features_to_numpy."""
    from mods_tpu import types as jtypes
    from mods_tpu_torch import types as ttypes
    rng = np.random.default_rng(3)
    sets = []
    for n in (5, 7):
        xy, A, s = _keypoints(n, n, 50, 60)
        sets.append([xy, A, s, rng.uniform(0, 9, n).astype(np.float32),
                     rng.uniform(0, 1, n) > 0.5])
    jk = [jtypes.Keypoints(*map(jnp.asarray, a)) for a in sets]
    tk = [ttypes.Keypoints(*map(torch.from_numpy, a)) for a in sets]

    def same(t, j):
        for f in ("xy", "A", "s", "response", "valid"):
            np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                          err_msg=f)

    same(ttypes.concat_keypoints(tk, total=16), jtypes.concat_keypoints(jk, total=16))
    cat_t, cat_j = ttypes.concat_keypoints(tk), jtypes.concat_keypoints(jk)
    for n in (None, 4, 20):
        same(ttypes.compact_keypoints(cat_t, n), jtypes.compact_keypoints(cat_j, n))
    with pytest.raises(ValueError):
        ttypes.pad_keypoints(cat_t, 3)
    same(ttypes.Keypoints.empty(4), jtypes.Keypoints.empty(4))
    for f in ("xy1", "A1", "s1", "valid"):
        np.testing.assert_array_equal(getattr(ttypes.Tentatives.empty(3), f).numpy(),
                                      np.asarray(getattr(jtypes.Tentatives.empty(3), f)))
    assert ttypes.Features.empty(4, 8).desc.shape == (4, 8)
    desc = rng.uniform(0, 255, (12, 8)).astype(np.float32)
    jf = jtypes.features_to_numpy(jtypes.Features(cat_j, cat_j, jnp.asarray(desc)))
    tf = ttypes.features_to_numpy(ttypes.Features(cat_t, cat_t, torch.from_numpy(desc)))
    assert jf.keys() == tf.keys()
    for k in jf:
        np.testing.assert_array_equal(tf[k], np.asarray(jf[k]), err_msg=k)
