"""The port's CNN stages (desc/cnn.py: HardNet, AffNet, OriNet, their
weights, patches and pipeline adapters, and extract_view with them)
against the JAX package's, on the same numpy-seeded inputs and the same
weight arrays.

Tolerances:
- weights (`_random_params`, the .npz, a .pth round trip): bit-equal;
- `hardnet_forward`: 1e-3 on the 0..255 scale, real and random weights
  (XLA's and PyTorch's convolutions sum in another order; ~1e-4 read);
- `hardnet_embed_raw`, with and without a whitening: 1e-5;
- `affnet_forward`, `orinet_forward`: 1e-5 relative to the output's scale;
- `cnn_patches` on both routes: equal but for rounding flips of 1 on at
  most 0.1 % of the pixels (the samplers agree to ~2e-3 before rounding,
  tests/test_torch_describe.py);
- `hardnet_describe` on both routes and with hardnet_tta = 3: descriptors
  within 1 (tests/test_deep_flagship.py:72-73), zero rows equal;
- `affnet_adapt`, `orinet_orient`: valid masks equal, A within 1e-4 on the
  rows whose patches round alike (~1e-6 read), within 1e-2 on the few
  others (one pixel rounded apart moves a random-weight net's output by
  up to ~5e-4);
- `extract_view` with ["HardNet"] (the classic detector's keypoints) and
  with the deep toggles ["ZMQ"]: given the same detections, descriptors
  within 1; with the deep toggles and each package's own detection, counts
  within 1 % and descriptors of co-located keypoints as
  `assert_colocated_descriptors` says.
Where random weights are meant, both packages get a weight path that does
not exist and the opt-in MODS_TPU_ALLOW_RANDOM_CNN.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu.config import Config as JConfig
from mods_tpu.desc import cnn as jcnn
from mods_tpu import pipeline as jpipe
from mods_tpu.ops import patch_engine as jpe
from mods_tpu_torch import pipeline as tpipe
from mods_tpu_torch.config import from_dict
from mods_tpu_torch.desc import cnn as tcnn
from mods_tpu_torch.detect import detector as tdet
from mods_tpu_torch.ops import patch_engine as tpe
from mods_tpu_torch.testing import deep_config, textured_image
from mods_tpu_torch.types import Keypoints
from torch_parity_helpers import assert_colocated_descriptors, to_jax_kp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARDNET_NPZ = os.path.join(ROOT, "weights", "HardNetPS.npz")
FORWARDS = {"hardnet": jcnn.hardnet_forward, "affnet": jcnn.affnet_forward,
            "orinet": jcnn.orinet_forward}


def _n(f):
    return int(np.asarray(f.count()))


def _jax_layers(layers):
    return {i: {k: jnp.asarray(v) for k, v in p.items()} for i, p in layers.items()}


def _patches(seed, n=192):
    """Seeded 32x32 patches: rounded textured crops, 0..255."""
    img = textured_image(8 * 32, n // 8 * 32, seed)
    p = img.reshape(8, 32, n // 8, 32).transpose(0, 2, 1, 3).reshape(n, 32, 32)
    return np.round(p).astype(np.float32)


def _keypoints(seed, n, h, w):
    """Keypoints with det-1 anisotropic shapes, scales 1.2-5 px, 15 %
    invalid, kept off the border by the largest patch's reach."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, n)
    an = rng.uniform(1.0, 1.8, n)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    A = R @ np.stack([np.stack([an, 0 * an], -1), np.stack([0 * an, 1 / an], -1)], -2)
    s = rng.uniform(1.2, 5.0, n)
    xy = np.stack([rng.uniform(12, w - 12, n), rng.uniform(12, h - 12, n)], -1)
    valid = rng.uniform(0, 1, n) > 0.15
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return Keypoints(f(xy), f(A), f(s), f(rng.uniform(1, 10, n)),
                     torch.from_numpy(valid))


def _cfgs(patch_source, tmp_path, monkeypatch, deep=False):
    """(JAX config, port config) with HardNet's real weights, AffNet and
    OriNet at random weights (a path that does not exist, opt-in), 512
    keypoints; the deep toggles of `testing.deep_config` if `deep`."""
    jcfg = JConfig()
    if deep:
        jcfg.hessian.affine.useZMQ = True
        jcfg.hessian.affine.doBaumberg = False
        jcfg.domori.useZMQ = True
    jcfg.max_keypoints = jcfg.max_octave_cands = 512
    jcfg.patch_source = patch_source
    jcfg.hardnet.weights = HARDNET_NPZ
    for which in ("affnet", "orinet"):
        getattr(jcfg, which).weights = str(tmp_path / f"absent_{which}.pth")
    monkeypatch.setenv("MODS_TPU_ALLOW_RANDOM_CNN", "1")
    cfg = from_dict(dataclasses.asdict(jcfg))
    if deep:
        ref = deep_config()
        assert (cfg.hessian.affine, cfg.domori) == (ref.hessian.affine, ref.domori)
    return jcfg, cfg


# --------------------------------------------------------------------------- #
# weights
# --------------------------------------------------------------------------- #
def _assert_layers_equal(a, b):
    assert {str(k) for k in a} == {str(k) for k in b}
    for k in a:
        kb = k if k in b else str(k)
        assert set(a[k]) == set(b[kb])
        for name in a[k]:
            np.testing.assert_array_equal(np.asarray(a[k][name]), np.asarray(b[kb][name]))


@pytest.mark.parametrize("which", ["hardnet", "affnet", "orinet"])
def test_random_params_bit_equal(which):
    _assert_layers_equal(tcnn.random_layers(which), jcnn._random_params(which))
    net = tcnn.params_from_jax(jcnn._random_params(which), which)
    for idx, p in jcnn._random_params(which).items():
        for name, v in p.items():
            np.testing.assert_array_equal(getattr(net, f"l{idx}_{name}").numpy(), v)


def test_npz_load_bit_equal():
    layers, source = tcnn.load_layers(HARDNET_NPZ, "hardnet")
    assert source == HARDNET_NPZ
    _assert_layers_equal(layers, jcnn._layers_from_state(dict(np.load(HARDNET_NPZ))))
    assert len(layers) == 14 and "whiten" not in layers


def test_pth_roundtrip_bit_equal(tmp_path):
    """A random state dict saved under "state_dict" with a whitening and a
    BN counter, loaded by both packages."""
    rng = np.random.default_rng(3)
    sd = {f"features.{i}.{k}": torch.from_numpy(v) for i, p in
          jcnn._random_params("orinet").items() for k, v in p.items()}
    sd["features.1.num_batches_tracked"] = torch.tensor(7)
    sd["whiten.mean"] = torch.from_numpy(rng.normal(size=128).astype(np.float32))
    sd["whiten.W"] = torch.from_numpy(rng.normal(size=(128, 128)).astype(np.float32))
    path = str(tmp_path / "net.pth")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    got = tcnn.load_pth_state(path)
    ref = jcnn.load_pth_state(path)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    layers, source = tcnn.load_layers(path, "orinet")
    assert source == path
    _assert_layers_equal(layers, jcnn._layers_from_state(ref))


def test_missing_weights_need_the_opt_in(tmp_path, monkeypatch):
    """An absent file raises FileNotFoundError with the JAX package's
    message; random weights only under the opt-in, and the net says so."""
    cfg = from_dict(dataclasses.asdict(JConfig()))
    cfg.affnet.weights = str(tmp_path / "AffNet.pth")
    monkeypatch.delenv("MODS_TPU_ALLOW_RANDOM_CNN", raising=False)
    with pytest.raises(FileNotFoundError, match="affnet weights not found at") as e:
        tcnn.get_net(cfg, "affnet", "cpu")
    jcfg = JConfig()
    jcfg.affnet.weights = cfg.affnet.weights
    with pytest.raises(FileNotFoundError) as ej:
        jcnn._get_params(jcfg, "affnet")
    assert str(e.value) == str(ej.value)
    monkeypatch.setenv("MODS_TPU_ALLOW_RANDOM_CNN", "1")
    net = tcnn.get_net(cfg, "affnet", "cpu")
    assert net.source == "random (opt-in)" and isinstance(net, tcnn.AffNet)
    assert tcnn.get_net(cfg, "affnet", "cpu") is net
    assert tcnn.get_net(cfg, "hardnet", "cpu").source == HARDNET_NPZ
    tcnn.invalidate_param_cache(cfg.affnet.weights)
    assert tcnn.get_net(cfg, "affnet", "cpu") is not net
    assert tcnn.weights_path(from_dict(dataclasses.asdict(JConfig())),
                             "hardnet") == HARDNET_NPZ


def test_cnn_entry_points_need_cuda_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("the card is present")
    cfg = from_dict(dataclasses.asdict(JConfig()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcnn.get_net(cfg, "hardnet")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcnn.nets3(cfg)
    assert tcnn.get_net(cfg, "hardnet", "cpu").l0_weight.device.type == "cpu"


# --------------------------------------------------------------------------- #
# the nets
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("weights", ["real", "random"])
def test_hardnet_forward_matches(weights):
    layers = (jcnn._layers_from_state(dict(np.load(HARDNET_NPZ))) if weights == "real"
              else jcnn._random_params("hardnet"))
    p = _patches(1)
    ref = np.asarray(jcnn.hardnet_forward(jnp.asarray(p), _jax_layers(layers)))
    got = tcnn.params_from_jax(layers, "hardnet")(torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    assert ref.std() > 5.0


@pytest.mark.parametrize("whiten", [False, True])
def test_hardnet_embed_raw_matches(whiten):
    layers = jcnn._layers_from_state(dict(np.load(HARDNET_NPZ)))
    if whiten:
        rng = np.random.default_rng(4)
        Q, _ = np.linalg.qr(rng.normal(size=(128, 128)))
        layers["whiten"] = {"mean": rng.normal(0, 0.02, 128).astype(np.float32),
                            "W": (Q * rng.uniform(0.5, 2.0, 128)).astype(np.float32)}
    p = _patches(2)
    ref = np.asarray(jcnn.hardnet_embed_raw(jnp.asarray(p), _jax_layers(layers)))
    net = tcnn.params_from_jax(layers, "hardnet")
    assert net.whitened == whiten
    np.testing.assert_allclose(net.embed_raw(torch.from_numpy(p)).numpy(), ref,
                               atol=1e-5, rtol=0)
    got_q = net(torch.from_numpy(p)).numpy()
    ref_q = np.asarray(jcnn.hardnet_forward(jnp.asarray(p), _jax_layers(layers)))
    np.testing.assert_allclose(got_q, ref_q, atol=1e-3, rtol=0)


@pytest.mark.parametrize("which", ["affnet", "orinet"])
def test_affnet_orinet_forward_matches(which):
    layers = jcnn._random_params(which)
    p = _patches(3)
    ref = np.asarray(FORWARDS[which](jnp.asarray(p), _jax_layers(layers)))
    got = tcnn.params_from_jax(layers, which)(torch.from_numpy(p)).numpy()
    assert got.shape == ref.shape == (len(p), 3 if which == "affnet" else 2)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)


def test_forward_valid_chunks_equal_one_call(monkeypatch):
    """The valid rows forwarded in chunks give the one-call values; the
    other rows are zero."""
    net = tcnn.params_from_jax(tcnn.random_layers("affnet"), "affnet")
    p = torch.from_numpy(_patches(4, 64))
    valid = torch.from_numpy(np.random.default_rng(5).uniform(size=64) > 0.3)
    whole = net(p)
    monkeypatch.setattr(tcnn, "CHUNK", 7)
    got = tcnn.forward_valid(net, p, valid, 3)
    np.testing.assert_allclose(got[valid].numpy(), whole[valid].numpy(), atol=1e-6)
    assert bool((got[~valid] == 0).all())


# --------------------------------------------------------------------------- #
# patches and the pipeline stages
# --------------------------------------------------------------------------- #
def _flips_ok(got, ref):
    d = np.abs(got - ref)
    assert d.max() <= 1.0 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("route,hw", [("engine", (96, 128)), ("engine", (128, 288)),
                                      ("reference", (96, 128))],
                         ids=["engine_windows", "engine_dma", "reference"])
def test_cnn_patches_match(route, hw):
    h, w = hw
    img = textured_image(h, w, 11)
    kp = _keypoints(12, 160, h, w)
    valid = kp.valid.numpy()
    if route == "engine":
        jpyr = jpe.build_mip_pyramid(jnp.asarray(img))
        tpyr = tpe.build_mip_pyramid(torch.from_numpy(img))
        jk = to_jax_kp(kp)
        ref = np.asarray(jcnn._cnn_patches_jit(jpyr, jk.xy, jk.A, jk.s, jk.valid, 5.1962,
                                               32, blend="topup"))[valid]
        got = tcnn.cnn_patches(tpyr, kp.xy, kp.A, kp.s, kp.valid, 5.1962, 32).numpy()[valid]
    else:
        ref, jvalid = jcnn._cnn_patches(jnp.asarray(img), to_jax_kp(kp), 5.1962, 32)
        got, idx = tcnn.reference_patches(torch.from_numpy(img), kp, 5.1962, 32)
        np.testing.assert_array_equal(idx.numpy(), np.nonzero(jvalid)[0])
        got = got.numpy()
    assert got.shape == ref.shape == (int(valid.sum()), 32, 32)
    assert (got == np.round(got)).all() and got.min() >= 0 and got.max() <= 255
    _flips_ok(got, ref)
    assert got.std() > 10.0


@pytest.mark.parametrize("route,tta", [("engine", 0), ("reference", 0), ("engine", 3)],
                         ids=["engine", "reference", "engine_tta3"])
def test_hardnet_describe_matches(route, tta, tmp_path, monkeypatch):
    jcfg, cfg = _cfgs(route, tmp_path, monkeypatch)
    jcfg.hardnet_tta = cfg.hardnet_tta = tta
    h, w = 96, 128
    img = textured_image(h, w, 13)
    kp = _keypoints(14, 128, h, w)
    ref = jcnn.hardnet_describe(jnp.asarray(img), to_jax_kp(kp), jcfg)
    got = tcnn.hardnet_describe(torch.from_numpy(img), kp, cfg).numpy()
    valid = kp.valid.numpy()
    assert got.shape == ref.shape == (128, 128)
    assert (got[~valid] == 0).all() and (ref[~valid] == 0).all()
    assert np.abs(got - ref).max() <= 1.0
    assert got[valid].std() > 5.0


def _same_patch_rows(route, jimg, timg, kp):
    """[N] rows whose 32x32 patches (mrSize 5.1962) both packages round to
    the same pixels on `route`."""
    if route == "engine":
        jk = to_jax_kp(kp)
        jp = np.asarray(jcnn._cnn_patches_jit(jpe.build_mip_pyramid(jimg), jk.xy, jk.A,
                                              jk.s, jk.valid, 5.1962, 32, blend="topup"))
        tp = tcnn.cnn_patches(tpe.build_mip_pyramid(timg), kp.xy, kp.A, kp.s, kp.valid,
                              5.1962, 32).numpy()
        return (jp == tp).all(axis=(1, 2))
    jp, valid = jcnn._cnn_patches(jimg, to_jax_kp(kp), 5.1962, 32)
    tp, _ = tcnn.reference_patches(timg, kp, 5.1962, 32)
    same = np.ones(kp.n, bool)
    same[valid] = (jp == tp.numpy()).all(axis=(1, 2))
    return same


@pytest.mark.parametrize("route", ["engine", "reference"])
def test_affnet_adapt_and_orinet_orient_match(route, tmp_path, monkeypatch):
    """Both stages on random weights: valid masks equal; A within 1e-4 on
    the rows whose patches round alike (at least 80 % of them), within
    1e-2 on the others."""
    jcfg, cfg = _cfgs(route, tmp_path, monkeypatch)
    h, w = 96, 128
    img = textured_image(h, w, 15)
    kp = _keypoints(16, 128, h, w)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    ja = jcnn.affnet_adapt(jimg, to_jax_kp(kp), jcfg)
    ta = tcnn.affnet_adapt(timg, kp, cfg)
    jo = jcnn.orinet_orient(jimg, to_jax_kp(ta), jcfg)
    to = tcnn.orinet_orient(timg, ta, cfg)
    for (j, t), src in (((ja, ta), kp), ((jo, to), ta)):
        valid = np.asarray(j.valid)
        np.testing.assert_array_equal(t.valid.numpy(), valid)
        same = _same_patch_rows(route, jimg, timg, src) & valid
        assert valid.sum() > 30 and same.sum() >= 0.8 * valid.sum()
        dA = np.abs(t.A.numpy() - np.asarray(j.A))
        assert dA[same].max() <= 1e-4 and dA[valid].max() <= 1e-2, dA.max()
    # OriNet turns the frames: A changes on valid rows, not elsewhere
    v = to.valid.numpy()
    assert np.abs(to.A.numpy()[v] - ta.A.numpy()[v]).max() > 0.1
    np.testing.assert_array_equal(to.A.numpy()[~v], ta.A.numpy()[~v])


@pytest.mark.parametrize("deep", [False, True], ids=["hardnet", "deep_toggles"])
def test_extract_view_matches(deep, tmp_path, monkeypatch):
    """A 96x128 identity view: the classic detector's keypoints described
    by HardNet, and the deep toggles (AffNet, OriNet) with the ZMQ
    descriptor.  Given the same detections, the same rows at every filter,
    A within 1e-3 (a patch pixel that rounds apart moves the random-weight
    nets' frames by up to ~5e-4; test_affnet_adapt_and_orinet_orient_match
    holds them to 1e-4 where none does) and descriptors within 1.  With the
    deep toggles each package also runs its own detection and AffNet: the
    envelope above.  (The classic detector's own detection against the
    JAX package's TPU route is test_torch_pipeline's.)"""
    jcfg, cfg = _cfgs("engine", tmp_path, monkeypatch, deep=deep)
    desc = "ZMQ" if deep else "HardNet"
    img = textured_image(96, 128, 9)
    args = (np.eye(3), 128, 96)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    kp = tdet.detect_keypoints(timg, cfg.hessian, 512, 512)
    j = jpipe.extract_view(jimg, *args, jcfg, "HessianAffine", [desc],
                           keypoints=to_jax_kp(kp)).by_desc[desc]
    t = tpipe.extract_view(timg, *args, cfg, "HessianAffine", [desc],
                           keypoints=kp).by_desc[desc]
    v = np.asarray(j.det.valid)
    np.testing.assert_array_equal(t.det.valid.numpy(), v)
    np.testing.assert_allclose(t.det.A.numpy()[v], np.asarray(j.det.A)[v], atol=1e-3)
    assert np.abs(t.desc.numpy() - np.asarray(j.desc)).max() <= 1.0

    if not deep:
        return
    j = jpipe.extract_view(jimg, *args, jcfg, "HessianAffine", [desc])
    t = tpipe.extract_view(timg, *args, cfg, "HessianAffine", [desc])
    for tf, jf in ((t.regions, j.regions), (t.by_desc[desc], j.by_desc[desc])):
        assert abs(_n(tf) - _n(jf)) <= 0.01 * _n(jf), (_n(tf), _n(jf))
    assert _n(t.by_desc[desc]) > 50
    assert t.by_desc[desc].desc.shape[1] == 128
    assert_colocated_descriptors(t.by_desc[desc], j.by_desc[desc])
