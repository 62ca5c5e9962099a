"""Plain PyTorch versions of the four patch kernels against their Pallas
entries (interpret mode on the CPU).

Tolerances: resample 1e-3 absolute on 0..255 data (the two compute the
same 4-tap bilinear sums in another association); Baumberg identical
accept flags and U within 1e-4 (the same iteration in float32, where the
SMM sums are reduced in another order).  The images are blurred noise,
as the pyramid levels that the kernels sample are: on raw uniform noise
(gradients ~100 per px) a one-ulp difference in a sample position, from
the compiler's choice of fused multiply-adds, alone moves a sample by
more than 1e-3.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu.detect import affine_shape as jas
from mods_tpu.ops import image as jim
from mods_tpu.ops import pallas_patch as pp
from mods_tpu.ops import patch_engine as jpe
from mods_tpu_torch.ops import patch_kernels as pk
from mods_tpu_torch.testing import textured_image

RESAMPLE_ATOL = 1e-3
U_ATOL = 1e-4


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _keypoints(rng, n, H, W):
    """Positions over the whole level, some on the image border."""
    x = rng.uniform(0, W, n).astype(np.float32)
    y = rng.uniform(0, H, n).astype(np.float32)
    x[:3] = [0.5, W - 1.5, W / 2]
    y[:3] = [H / 2, 1.0, H - 0.7]
    return x, y


def _affines(rng, n, max_extent):
    """Random rotation + anisotropic stretch, scaled so that the patch
    footprint reaches up to `max_extent` px."""
    th = rng.uniform(-np.pi, np.pi, n)
    an = rng.uniform(1.0, 3.0, n)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    D = np.zeros((n, 2, 2))
    D[:, 0, 0] = an
    D[:, 1, 1] = 1.0 / an
    A = R @ D
    sc = rng.uniform(0.2, 1.0, n) * max_extent / np.abs(A).sum(-1).max(-1)
    return (A * sc[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("P", [19, 41])
def test_dma_hat_resample_matches_pallas(P):
    rng = np.random.default_rng(10 + P)
    L, H, W = 3, 128, 288
    pyr = np.stack([textured_image(H, W, 100 * P + l) for l in range(L)])
    n = 20
    x, y = _keypoints(rng, n, H, W)
    lw = np.full(n, W, np.int32)
    lh = np.full(n, H, np.int32)
    lw[5:8] = W // 2                     # coarser levels: smaller extent
    lh[5:8] = H // 2
    x[5:8] = rng.uniform(0, W // 2, 3)
    y[5:8] = rng.uniform(0, H // 2, 3)
    oy_j, ox_j = pp.dma_window_origins(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(lw), jnp.asarray(lh))
    oy, ox = pk.dma_window_origins(_t(x), _t(y), _t(lw), _t(lh))
    np.testing.assert_array_equal(oy.numpy(), np.asarray(oy_j))
    np.testing.assert_array_equal(ox.numpy(), np.asarray(ox_j))
    A = _affines(rng, n, 50.0 / (P // 2))
    lev = rng.integers(0, L, n).astype(np.int32)
    live = np.ones(n, np.float32)
    live[[4, 11, 17]] = 0.0
    params = np.stack([x - ox.numpy(), y - oy.numpy(), A[:, 0, 0], A[:, 0, 1],
                       A[:, 1, 0], A[:, 1, 1], ox.numpy(), oy.numpy(),
                       lw, lh, live], -1).astype(np.float32)
    ref = np.asarray(pp.dma_hat_resample(
        jnp.asarray(pyr), jnp.asarray(lev), oy_j, ox_j, jnp.asarray(params), P))
    got = pk.dma_hat_resample(_t(pyr), _t(lev), oy, ox, _t(params), P).numpy()
    assert got.shape == (n, P, P)
    assert np.all(got[[4, 11, 17]] == 0.0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESAMPLE_ATOL)
    assert np.count_nonzero(got) > n * P * P // 2


@pytest.mark.parametrize("P", [19, 41])
def test_hat_resample_matches_pallas(P):
    rng = np.random.default_rng(20 + P)
    n, Wn = 18, 96
    wins = textured_image(n * Wn, Wn, P).reshape(n, Wn, Wn)
    img_w, img_h = 128.0, 96.0
    ox = rng.integers(0, 33, n).astype(np.float32)
    oy = np.zeros(n, np.float32)
    cx = rng.uniform(-2, Wn + 2, n).astype(np.float32)   # window-local
    cy = rng.uniform(-2, Wn + 2, n).astype(np.float32)
    cx[:2] = [Wn / 2, Wn / 2]
    cy[:2] = [Wn / 2, Wn / 2]
    A = _affines(rng, n, 46.0 / (P // 2))
    params = np.stack([cx, cy, A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1],
                       ox, oy, np.full(n, img_w), np.full(n, img_h)],
                      -1).astype(np.float32)
    ref = np.asarray(pp.hat_resample(jnp.asarray(wins), jnp.asarray(params), P))
    got = pk.hat_resample(_t(wins), _t(params), P).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESAMPLE_ATOL)
    assert np.count_nonzero(got) > n * P * P // 4


@pytest.mark.parametrize("P,Wn", [(19, 64), (41, 64), (19, 50)])
def test_hat_resample_matches_pallas_on_narrow_windows(P, Wn):
    """Windows narrower than the default 96 (an image smaller than the
    window: `crop_windows` takes min(win, H, W)); 50 is no multiple of 4."""
    rng = np.random.default_rng(30 + P + Wn)
    n = 12
    wins = textured_image(n * Wn, Wn, P + Wn).reshape(n, Wn, Wn)
    ox = rng.integers(0, 17, n).astype(np.float32)
    oy = np.zeros(n, np.float32)
    cx = rng.uniform(-2, Wn + 2, n).astype(np.float32)
    cy = rng.uniform(-2, Wn + 2, n).astype(np.float32)
    cx[:2] = [Wn / 2, Wn - 1.5]
    cy[:2] = [Wn / 2, 0.5]
    A = _affines(rng, n, (Wn - 4) / 2.0 / (P // 2))
    params = np.stack([cx, cy, A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1],
                       ox, oy, np.full(n, Wn + 16.0), np.full(n, float(Wn))],
                      -1).astype(np.float32)
    ref = np.asarray(pp.hat_resample(jnp.asarray(wins), jnp.asarray(params), P))
    got = pk.hat_resample(_t(wins), _t(params), P).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESAMPLE_ATOL)
    assert np.count_nonzero(got) > n * P * P // 4


def _baumberg_inputs(seed, n, H, W):
    rng = np.random.default_rng(seed)
    L = 3
    stack = np.stack([textured_image(H, W, seed + l) for l in range(L)])
    x, y = _keypoints(rng, n, H, W)
    ratio = rng.uniform(1.0, 2.5, n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[[3, 9]] = False
    lev = rng.integers(0, L, n).astype(np.int32)
    ws = 19
    mask = jim.gauss_mask(ws)
    return stack, x, y, ratio, valid, lev, mask, ws


def _check_baumberg(U, ok, U_ref, ok_ref, valid):
    np.testing.assert_array_equal(ok, ok_ref)
    assert not ok[~valid].any()
    assert ok.sum() >= 3
    np.testing.assert_allclose(U, U_ref, rtol=0, atol=U_ATOL)


def test_dma_baumberg_matches_pallas():
    n, H, W = 22, 128, 288
    stack, x, y, ratio, valid, lev, mask, ws = _baumberg_inputs(31, n, H, W)
    lw = np.full(n, W, np.int32)
    lh = np.full(n, H, np.int32)
    oy, ox = pk.dma_window_origins(_t(x), _t(y), _t(lw), _t(lh))
    params = np.stack([x - ox.numpy(), y - oy.numpy(), ratio,
                       valid.astype(np.float32), ox.numpy(), oy.numpy(),
                       np.full(n, W), np.full(n, H)], -1).astype(np.float32)
    U_ref, ok_ref = pp.dma_baumberg(
        jnp.asarray(stack), jnp.asarray(lev), jnp.asarray(oy.numpy()),
        jnp.asarray(ox.numpy()), jnp.asarray(params), jnp.asarray(mask),
        ws, 16, 0.05)
    U, ok = pk.dma_baumberg(_t(stack), _t(lev), oy, ox, _t(params), _t(mask),
                            ws, 16, 0.05)
    _check_baumberg(U.numpy(), ok.numpy(), np.asarray(U_ref),
                    np.asarray(ok_ref), valid)


def test_baumberg_windows_matches_pallas():
    n, H, W = 20, 80, 100
    stack, x, y, ratio, valid, lev, mask, ws = _baumberg_inputs(41, n, H, W)
    xy = np.stack([x, y], -1)
    wins_j, wox_j, woy_j = jpe.crop_windows(jnp.asarray(stack), jnp.asarray(lev),
                                            jnp.asarray(xy), jas.BAUMBERG_WIN)
    from mods_tpu_torch.ops import patch_engine as pe
    wins, wox, woy = pe.crop_windows(_t(stack), _t(lev), _t(xy), jas.BAUMBERG_WIN)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(wins_j))
    np.testing.assert_array_equal(wox.numpy(), np.asarray(wox_j))
    np.testing.assert_array_equal(woy.numpy(), np.asarray(woy_j))
    wox, woy = wox.numpy().astype(np.float32), woy.numpy().astype(np.float32)
    params = np.stack([x - wox, y - woy, ratio, valid.astype(np.float32),
                       wox, woy, np.full(n, W), np.full(n, H)],
                      -1).astype(np.float32)
    U_ref, ok_ref = pp.baumberg_pallas(wins_j, jnp.asarray(params),
                                       jnp.asarray(mask), ws, 16, 0.05)
    U, ok = pk.baumberg_windows(wins, _t(params), _t(mask), ws, 16, 0.05)
    _check_baumberg(U.numpy(), ok.numpy(), np.asarray(U_ref),
                    np.asarray(ok_ref), valid)


def test_baumberg_windows_matches_pallas_on_narrow_windows():
    """A 48x60 octave: `crop_windows` cuts 48x48 windows, not 104x104."""
    n, H, W = 16, 48, 60
    stack, x, y, ratio, valid, lev, mask, ws = _baumberg_inputs(51, n, H, W)
    ratio = np.minimum(ratio, 1.3).astype(np.float32)   # patches that fit
    xy = np.stack([x, y], -1)
    from mods_tpu_torch.ops import patch_engine as pe
    wins_j, wox_j, woy_j = jpe.crop_windows(jnp.asarray(stack), jnp.asarray(lev),
                                            jnp.asarray(xy), jas.BAUMBERG_WIN)
    wins, wox, woy = pe.crop_windows(_t(stack), _t(lev), _t(xy), jas.BAUMBERG_WIN)
    assert tuple(wins.shape) == (n, 48, 48)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(wins_j))
    wox, woy = wox.numpy().astype(np.float32), woy.numpy().astype(np.float32)
    params = np.stack([x - wox, y - woy, ratio, valid.astype(np.float32),
                       wox, woy, np.full(n, W), np.full(n, H)],
                      -1).astype(np.float32)
    U_ref, ok_ref = pp.baumberg_pallas(wins_j, jnp.asarray(params),
                                       jnp.asarray(mask), ws, 16, 0.05)
    U, ok = pk.baumberg_windows(wins, _t(params), _t(mask), ws, 16, 0.05)
    _check_baumberg(U.numpy(), ok.numpy(), np.asarray(U_ref),
                    np.asarray(ok_ref), valid)


def test_bound_entries_are_the_sources_entries(monkeypatch):
    """bind_library declares argument types for exactly the extern "C"
    kernel entries of csrc/patch_kernels.cu: one design for each of the
    four wrappers and octave_extrema's entry, all in the one build the
    source has (no preprocessor conditionals)."""
    import re
    import types

    class FakeLibrary:
        def __init__(self):
            self.bound = {}

        def __getattr__(self, name):
            return self.bound.setdefault(name, types.SimpleNamespace())

    lib = FakeLibrary()
    monkeypatch.setattr(pk.ctypes, "CDLL", lambda path: lib)
    assert pk.bind_library("unused") is lib
    src = pk.SOURCE.read_text()
    entries = set(re.findall(r"^int (\w+)\(", src[src.index('extern "C"'):], re.M))
    assert set(lib.bound) == entries == {
        "resample_pyr", "resample_win", "baumberg_pyr", "baumberg_win",
        "octave_extrema"}
    assert not re.search(r"^\s*#\s*if(n?def)?\b", src, re.M)
    for name, fn in lib.bound.items():
        assert fn.restype is pk.ctypes.c_int and len(fn.argtypes) >= 8, name
    # the wrappers' signatures are the main path's: no argument picks a body
    import inspect
    assert list(inspect.signature(pk.baumberg_windows).parameters) == [
        "wins", "params", "mask", "ws", "max_iter", "conv"]
    assert list(inspect.signature(pk.hat_resample).parameters) == [
        "wins", "params", "P"]


@pytest.mark.parametrize("P,staged", [(5, False), (19, False), (31, False),
                                      (32, True), (41, True), (129, True)])
def test_win_stage_floats_by_patch_width(P, staged):
    """hat_resample stages a patch's box from WIN_STAGE_MIN_P on; narrower
    patches get no buffer (their taps come from global memory)."""
    assert 19 < pk.WIN_STAGE_MIN_P <= 41     # orientation unstaged, descriptor staged
    assert pk.win_stage_floats(P) == (pk.STAGE_FLOATS if staged else 0)


def test_baumberg_windows_on_cpu_takes_plain_and_refuses_mixed_devices():
    wins = torch.zeros((2, 8, 8))
    params = torch.zeros((2, 8))
    mask = torch.ones((3, 3))
    U, ok = pk.baumberg_windows(wins, params, mask, 3, 2, 0.05)
    assert tuple(U.shape) == (2, 2, 2) and not ok.any()
    with pytest.raises(ValueError):
        pk.baumberg_windows(wins.to("meta"), params, mask, 3, 2, 0.05)


def test_wrappers_take_plain_version_only_on_cpu():
    """CPU tensors take the plain version and launch nothing."""
    pk.reset_launches()
    wins = torch.zeros((2, 8, 8))
    params = torch.zeros((2, 10))
    pk.hat_resample(wins, params, 5)
    assert all(v == 0 for v in pk.LAUNCHES.values())
    with pytest.raises(ValueError):
        pk.hat_resample(wins.to("meta"), params.to("meta"), 5)


def _box_case(seed, n, P, W, kind):
    """Resample params [n, 10] on a 160 x W level, made with numpy: `kind`
    picks interior keypoints, keypoints on the level's borders and
    corners, or patches too large for the staging buffer (some degenerate:
    overflowing, infinite and NaN steps)."""
    rng = np.random.default_rng(seed)
    H = 160
    x = rng.uniform(0, W, n).astype(np.float32)
    y = rng.uniform(0, H, n).astype(np.float32)
    extent = 46.0
    if kind == "border":
        x[0::4] = rng.choice([0.0, 0.5, W - 1.5, W - 1.0, W + 3.0, -4.0], len(x[0::4]))
        y[1::4] = rng.choice([0.0, 0.5, H - 1.5, H - 1.0, H + 3.0, -4.0], len(y[1::4]))
        x[2::8] = 0.25
        y[2::8] = 0.25
        x[6::8] = W - 1.25
        y[6::8] = H - 1.25
    A = _affines(rng, n, extent / (P // 2))
    if kind == "oversize":
        A *= rng.uniform(1.5, 6.0, n).astype(np.float32)[:, None, None]
        A[0] = [[3e37, 0.0], [0.0, 1.0]]          # overflows off the centre column
        A[1] = [[np.inf, 0.0], [0.0, 1.0]]
        A[2] = [[np.nan, 0.0], [0.0, 1.0]]
        A[3] = [[3e37, -3e37], [1.0, 0.5]]
    lw = np.full(n, W, np.int32)
    lh = np.full(n, H, np.int32)
    oy, ox = pk.dma_window_origins(_t(x), _t(y), _t(lw), _t(lh))
    params = np.stack([x - ox.numpy(), y - oy.numpy(), A[:, 0, 0], A[:, 0, 1],
                       A[:, 1, 0], A[:, 1, 1], ox.numpy(), oy.numpy(), lw, lh],
                      -1).astype(np.float32)
    return _t(params), ox


@pytest.mark.parametrize("kind", ["interior", "border", "oversize"])
@pytest.mark.parametrize("P,W,aligned", [(41, 800, True), (19, 800, True),
                                         (41, 802, False), (20, 400, True)])
def test_footprint_boxes_hold_every_admitted_tap(kind, P, W, aligned):
    """The box that resample_pyr stages holds the four taps of every sample
    that `_footprint` admits; an empty box admits none; an aligned box
    starts and ends on 16-byte lines inside the stack's row; the box of a
    patch that a pyramid level fits (+-46 px) is no larger than that
    extent allows, and most have room in the staging buffer."""
    n = 96
    params, ox = _box_case(7 * P + W + len(kind), n, P, W, kind)
    WY, WX = pk.DMA_WIN_Y, pk.DMA_WIN_X
    xlo, xhi, ylo, yhi, empty = pk.footprint_boxes(params, ox, P, WY, WX,
                                                   aligned)
    ig, jg = pk._grid(P, params.device)
    px = params[:, 0:1] + ig * params[:, 2:3] + jg * params[:, 3:4]
    py = params[:, 1:2] + ig * params[:, 4:5] + jg * params[:, 5:6]
    inb, _, _, x0, y0 = pk._footprint(px, py, params[:, 6], params[:, 7],
                                      params[:, 8], params[:, 9], WY, WX)
    assert int(inb.sum()) > n * P * P // 8
    assert not inb[empty].any()
    inside = ((x0 >= xlo[:, None]) & (x0 + 1 <= xhi[:, None]) &
              (y0 >= ylo[:, None]) & (y0 + 1 <= yhi[:, None]))
    assert bool(inside[inb].all())
    live = ~empty
    assert bool((ylo[live] >= 0).all()) and bool((yhi[live] <= WY - 1).all())
    gx0, gx1 = ox.long() + xlo, ox.long() + xhi + 1
    assert bool((gx0[live] >= 0).all()) and bool((gx1[live] <= W).all())
    if aligned:
        assert bool((gx0[live] % 4 == 0).all()) and bool((gx1[live] % 4 == 0).all())
    else:
        assert bool((xlo[live] >= 0).all()) and bool((xhi[live] <= WX - 1).all())
    area = (xhi - xlo + 1) * (yhi - ylo + 1)
    if kind == "oversize":      # some find no room in the staging buffer
        assert int((live & (area > pk.STAGE_FLOATS)).sum()) >= n // 8
    else:                       # +-46 px and the taps, widened to 16-byte lines
        assert bool((area[live] <= (2 * 46 + 3) * (2 * 46 + 3 + 6)).all())
        assert int((live & (area <= pk.STAGE_FLOATS)).sum()) >= n // 2


def _window_box_case(seed, n, P, Wn, kind):
    """hat_resample params [n, 10] on windows of width Wn, made with numpy:
    `kind` picks patches inside their window, centres on and beyond the
    window's borders, or patches larger than the window (some degenerate:
    overflowing, infinite and NaN steps)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(4, Wn - 4, n).astype(np.float32)
    cy = rng.uniform(4, Wn - 4, n).astype(np.float32)
    if kind == "border":
        cx[0::4] = rng.choice([0.0, 0.5, Wn - 1.5, Wn - 1.0, Wn + 3.0, -4.0], len(cx[0::4]))
        cy[1::4] = rng.choice([0.0, 0.5, Wn - 1.5, Wn - 1.0, Wn + 3.0, -4.0], len(cy[1::4]))
        cx[2::8] = 0.25
        cy[2::8] = 0.25
        cx[6::8] = Wn - 1.25
        cy[6::8] = Wn - 1.25
        cx[3], cy[3] = -3.0 * Wn, Wn / 2      # off its window
        cx[7], cy[7] = Wn / 2, 4.0 * Wn
    A = _affines(rng, n, (Wn - 4) / 2.0 / (P // 2))
    if kind == "oversize":
        A *= rng.uniform(1.5, 6.0, n).astype(np.float32)[:, None, None]
        A[0] = [[3e37, 0.0], [0.0, 1.0]]
        A[1] = [[np.inf, 0.0], [0.0, 1.0]]
        A[2] = [[np.nan, 0.0], [0.0, 1.0]]
        A[3] = [[3e37, -3e37], [1.0, 0.5]]
        A[4] = [[1.0, 0.5], [np.nan, np.nan]]
    ox = rng.integers(0, 33, n).astype(np.float32)
    oy = rng.integers(0, 9, n).astype(np.float32)
    # the level ends inside some windows
    lw = np.where(np.arange(n) % 5 == 0, ox + Wn / 2, ox + Wn + 8.0)
    lh = np.full(n, oy + Wn)
    return _t(np.stack([cx, cy, A[:, 0, 0], A[:, 0, 1], A[:, 1, 0], A[:, 1, 1],
                        ox, oy, lw, lh], -1).astype(np.float32))


@pytest.mark.parametrize("kind", ["interior", "border", "oversize"])
@pytest.mark.parametrize("P", [19, 41])
@pytest.mark.parametrize("Wn", [96, 64, 50])
def test_footprint_boxes_on_windows_hold_every_admitted_tap(kind, P, Wn):
    """The box that resample_win stages for a precropped window (origin
    column 0, WY = WX = Wn, 16-byte copies when Wn is a multiple of 4)
    holds the four taps of every sample that `_footprint` admits; an empty
    box admits none; the box lies in the window, on 16-byte lines where
    aligned."""
    n = 64
    params = _window_box_case(11 * P + Wn + len(kind), n, P, Wn, kind)
    aligned = Wn % 4 == 0
    zero = torch.zeros(n, dtype=torch.int32)
    xlo, xhi, ylo, yhi, empty = pk.footprint_boxes(params, zero, P, Wn, Wn,
                                                   aligned)
    ig, jg = pk._grid(P, params.device)
    px = params[:, 0:1] + ig * params[:, 2:3] + jg * params[:, 3:4]
    py = params[:, 1:2] + ig * params[:, 4:5] + jg * params[:, 5:6]
    inb, _, _, x0, y0 = pk._footprint(px, py, params[:, 6], params[:, 7],
                                      params[:, 8], params[:, 9], Wn, Wn)
    assert int(inb.sum()) > n * P * P // 16
    assert not inb[empty].any()
    if kind == "border":
        assert bool(empty[3]) and bool(empty[7])
    inside = ((x0 >= xlo[:, None]) & (x0 + 1 <= xhi[:, None]) &
              (y0 >= ylo[:, None]) & (y0 + 1 <= yhi[:, None]))
    assert bool(inside[inb].all())
    live = ~empty
    assert bool((ylo[live] >= 0).all()) and bool((yhi[live] <= Wn - 1).all())
    assert bool((xlo[live] >= 0).all()) and bool((xhi[live] <= Wn - 1).all())
    if aligned:
        assert bool((xlo[live] % 4 == 0).all())
        assert bool(((xhi[live] + 1) % 4 == 0).all())
    if kind == "oversize":      # some boxes are the whole window
        area = (xhi - xlo + 1) * (yhi - ylo + 1)
        assert int((live & (area == Wn * Wn)).sum()) >= 2
