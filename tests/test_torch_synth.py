"""View synthesis, the image gathers and the step atlas of the port
against the JAX package.

Tolerances: the view schedule and every view's size and 3x3 map are
float64 host math in both packages and must be equal, not close; the
warps (the same float32 taps in the same order) within 1e-3 on 0..255;
the gathers and double_image within 1e-4.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu.config import Config as JConfig
from mods_tpu.ops import image as jim
from mods_tpu.synth import atlas as jatlas
from mods_tpu.synth import vs as jvs
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.ops import image as tim
from mods_tpu_torch.synth import atlas as tatlas
from mods_tpu_torch.synth import vs as tvs
from mods_tpu_torch.testing import mods_schedule, textured_image

JCFG = JConfig()
CFG = from_dict(dataclasses.asdict(JCFG))
TILTS = (1.0, 2.0, 4.0, 6.0, -1.0, -2.0, -4.0, -6.0)


def _vp_tuple(v):
    return (v.tilt, v.phi, v.zoom, v.InitSigma, v.doBlur, tuple(v.descriptors),
            tuple(sorted(v.FGINNThreshold.items())),
            tuple(sorted(v.DistanceThreshold.items())))


@pytest.mark.parametrize("phi_base", [72.0, 36.0, 360.0, -90.0])
def test_set_vs_pars_matches(phi_base):
    """Every tilt of ±{1, 2, 4, 6} at zoom 0.5 and 1, then a second step
    deduplicated against the first's views."""
    args = (["RootSIFT"], {"RootSIFT": 0.8}, {"RootSIFT": 0.0}, 0.5, True)
    j_prev, t_prev = [], []
    for scales, tilts in (([1.0], [1.0, 2.0]), ([0.5, 1.0], list(TILTS))):
        jv, j_prev = jvs.set_vs_pars(scales, tilts, phi_base, *args, j_prev)
        tv, t_prev = tvs.set_vs_pars(scales, tilts, phi_base, *args,
                                     [dataclasses.replace(p) for p in t_prev])
        assert [_vp_tuple(v) for v in tv] == [_vp_tuple(v) for v in jv]
        assert [_vp_tuple(v) for v in t_prev] == [_vp_tuple(v) for v in j_prev]
    assert len(tv) > 0


def _schedule_views(set_vs_pars):
    """The new views of each step of mods_schedule."""
    prev, out = [], []
    for st in mods_schedule():
        s = st.detectors["HessianAffine"]
        views, prev = set_vs_pars(s["scale_set"], s["tilt_set"], s["phi"],
                                  s["descriptors"], s["fginn"], s["dist"],
                                  s["init_sigma"], s["do_blur"], prev)
        out.append(views)
    return out


def test_mods_schedule_expands_to_fifteen_new_views():
    jv, tv = _schedule_views(jvs.set_vs_pars), _schedule_views(tvs.set_vs_pars)
    assert [[_vp_tuple(v) for v in s] for s in tv] == \
        [[_vp_tuple(v) for v in s] for s in jv]
    assert [(len(s), sorted({v.tilt for v in s})) for s in tv] == \
        [(1, [1.0]), (15, [2.0, 4.0])]


@pytest.mark.parametrize("zoom", [0.5, 1.0])
@pytest.mark.parametrize("tilt", TILTS)
def test_synth_view_geometry_equal(tilt, zoom):
    for phi_deg in range(0, 171, 10):
        phi = math.radians(phi_deg)
        gj = jvs.synth_view_geometry(160, 120, tilt, phi, zoom, 0.5, True)
        gt = tvs.synth_view_geometry(160, 120, tilt, phi, zoom, 0.5, True)
        for f in dataclasses.fields(gj):
            a, b = getattr(gj, f.name), getattr(gt, f.name)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                np.testing.assert_array_equal(b, a, err_msg=f.name)
            else:
                assert a == b, (f.name, a, b)


@pytest.mark.parametrize("tilt,phi,zoom", [(2.0, 0.3, 1.0), (4.0, 2.0, 1.0),
                                           (-2.0, 0.0, 1.0), (6.0, 1.2, 0.5),
                                           (2.0, math.pi / 2, 1.0)])
def test_warp_view_matches(tilt, phi, zoom):
    img = textured_image(70, 90, 3)
    g = jvs.synth_view_geometry(90, 70, tilt, phi, zoom, 0.5, True)
    ref = np.asarray(jvs.warp_view(jnp.asarray(img), g))
    got = tvs.warp_view(torch.from_numpy(img),
                        tvs.synth_view_geometry(90, 70, tilt, phi, zoom, 0.5, True))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)
    sj = jvs.generate_synth_view(jnp.asarray(img), tilt, phi, zoom, 0.5, True, 3)
    st = tvs.generate_synth_view(torch.from_numpy(img), tilt, phi, zoom, 0.5, True, 3)
    assert (st.tilt, st.phi, st.zoom, st.id) == (sj.tilt, sj.phi, sj.zoom, sj.id)
    np.testing.assert_array_equal(st.H, sj.H)


@pytest.mark.parametrize("do_blur", [True, False])
def test_generate_synth_view_by_h_matches(do_blur):
    img = textured_image(70, 90, 4)
    H = np.array([[0.9, 0.1, 5.0], [-0.05, 1.1, 3.0], [1e-4, 2e-4, 1.0]])
    ref = np.asarray(jvs.generate_synth_view_by_h(jnp.asarray(img), H, 0.7,
                                                  do_blur).pixels)
    got = tvs.generate_synth_view_by_h(torch.from_numpy(img), H, 0.7, do_blur).pixels
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3, rtol=0)


def test_gaussian_blur_xy_matches():
    img = textured_image(40, 52, 5)
    for sx, sy in ((0.25, 1.0), (2.0, 0.25), (0.1, 0.1)):
        ref = np.asarray(jim.gaussian_blur_xy(jnp.asarray(img), sx, sy))
        got = tim.gaussian_blur_xy(torch.from_numpy(img), sx, sy).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def _affines(rng, n, scale):
    th = rng.uniform(-3, 3, n)
    an = rng.uniform(1, 2, n)
    return (np.stack([np.stack([np.cos(th) * an, -np.sin(th) / an], -1),
                      np.stack([np.sin(th) * an, np.cos(th) / an], -1)], -2)
            * scale).astype(np.float32)


def test_gathers_match():
    """affine_sample (per keypoint in JAX, batched in the port),
    affine_sample_level, bilinear_gather(_constant) at positions inside,
    across and outside the border, and double_image."""
    img = textured_image(50, 60, 6)
    rng = np.random.default_rng(0)
    n = 24
    xy = rng.uniform(-5, 65, (n, 2)).astype(np.float32)
    A = _affines(rng, n, 1.5)
    ref = np.stack([np.asarray(jim.affine_sample(jnp.asarray(img), p[0], p[1],
                                                 jnp.asarray(a), 9, 11))
                    for p, a in zip(xy, A)])
    got = tim.affine_sample(torch.from_numpy(img), torch.from_numpy(xy[:, 0]),
                            torch.from_numpy(xy[:, 1]), torch.from_numpy(A), 9, 11)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)

    stack = np.stack([img, img[::-1].copy(), 0.5 * img])
    lev = rng.integers(0, 3, n)
    ref = np.stack([np.asarray(jim.affine_sample_level(
        jnp.asarray(stack), l, p[0], p[1], jnp.asarray(a), 7, 7))
        for l, p, a in zip(lev, xy, A)])
    got = tim.affine_sample_level(torch.from_numpy(stack), torch.from_numpy(lev),
                                  torch.from_numpy(xy[:, 0]), torch.from_numpy(xy[:, 1]),
                                  torch.from_numpy(A), 7, 7)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)

    wx = rng.uniform(-3, 63, (30, 40)).astype(np.float32)
    wy = rng.uniform(-3, 53, (30, 40)).astype(np.float32)
    for fn, kw in (("bilinear_gather", {}), ("bilinear_gather_constant",
                                             {"fill": 128.0})):
        ref = np.asarray(getattr(jim, fn)(jnp.asarray(img), jnp.asarray(wx),
                                          jnp.asarray(wy), **kw))
        got = getattr(tim, fn)(torch.from_numpy(img), torch.from_numpy(wx),
                               torch.from_numpy(wy), **kw).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0, err_msg=fn)

    M = np.array([[0.8, 0.3, 4.0], [-0.2, 1.1, -2.0]])
    ref = np.asarray(jim.warp_affine(jnp.asarray(img), M, 45, 70))
    got = tim.warp_affine(torch.from_numpy(img), M, 45, 70).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    ref = np.asarray(jim.double_image(jnp.asarray(img)))
    np.testing.assert_allclose(tim.double_image(torch.from_numpy(img)).numpy(), ref,
                               atol=1e-4, rtol=0)


def test_build_atlas_matches():
    """The step-1 atlas of mods_schedule: the same plan and canvas."""
    img = textured_image(64, 80, 7)
    views = _schedule_views(tvs.set_vs_pars)[1]
    pj = jatlas.plan_step_atlas(80, 64, views)
    pt = tatlas.plan_step_atlas(80, 64, views)
    assert (pt.H, pt.W, pt.y_off) == (pj.H, pj.W, pj.y_off)
    np.testing.assert_array_equal(pt.y_end, pj.y_end)
    np.testing.assert_array_equal(pt.Hs, pj.Hs)
    ref = np.asarray(jatlas.build_atlas(jnp.asarray(img), pj))
    got = tatlas.build_atlas(torch.from_numpy(img), pt).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)

    rng = np.random.default_rng(2)
    xy = np.stack([rng.uniform(0, pt.W, 200), rng.uniform(0, pt.H, 200)],
                  -1).astype(np.float32)
    vj, yj, whj = jatlas.assign_views(jnp.asarray(xy), pj)
    vt, yt, wht = tatlas.assign_views(torch.from_numpy(xy), pt)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(wht.numpy(), np.asarray(whj))
