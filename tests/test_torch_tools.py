"""The port's tools (`python -m mods_tpu_torch.tools.<name>`) on the CPU,
on PNG pairs written to a temporary directory, with every view capped at
512 keypoints (the tools' own configurations pad to 8192, which takes
minutes a pair on the CPU).

Against the JAX package, on the same 96x128 image files:
- `ops/image.rgb_to_gray`: equal to `mods_tpu.ops.image.rgb_to_gray`,
  exactly, dtype included;
- `diag_deep`'s stage counts: equal to the JAX package's
  detect_keypoints -> affnet_adapt -> reproject_keypoints -> orinet_orient
  -> reproject_keypoints -> hardnet_describe on the deep configuration,
  HardNet at its committed weights and AffNet / OriNet at the JAX
  package's seeded random weights, carried to the port by its weight
  converter (`cnn.params_from_jax`).  The envelope is that of the CNN
  patches' rounding (ROADMAP section C: a pixel of ~0.1 % rounds apart,
  frames move by up to 4.3e-4): each count within max(1, 1 %); on these
  images they are equal;
- `export_native`'s two files and their extended twins: against
  `mods_tpu.io.keys.save_regions_native` / `save_regions_native_ext` of
  the JAX `_extract_image` on its TPU route's detection, op by op
  (`torch_parity_helpers.jax_detect_engine`, jit=False: the jitted
  program fuses the sub-pixel solves and moves positions by ~3e-3 px).
  Rows per detector and descriptor equal; positions, scales and shapes
  within 1e-3 relative (1e-4 absolute for shape entries near 0);
  descriptor entries within one quantization level, in at most 0.1 % of
  the entries (orientation's histogram rounds apart on a few rows).
Against the port's own functions, on a 96x128 pair: `golden_run`'s and
`eval_deep`'s printed counts equal `twoview.match_images` with the same
configuration and RANSAC generator (the JAX MODS loop is held in
tests/test_torch_twoview.py); `profile` prints every stage of its three
sections with a time.  A missing image, INI or checkpoint raises; the
tools run on the card unless given --device cpu, and import neither JAX
nor the JAX package.
"""
import argparse
import contextlib
import dataclasses
import functools
import importlib
import io
import json
import os
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu import pipeline as jpipe
from mods_tpu import twoview as jtwoview
from mods_tpu.desc import cnn as jcnn
from mods_tpu.detect import detector as jdet
from mods_tpu.io import keys as jkeys
from mods_tpu.ops import image as jimage
from mods_tpu.types import Keypoints as JKeypoints
from mods_tpu_torch import cli
from mods_tpu_torch import config as tconfig
from mods_tpu_torch.desc import cnn as tcnn
from mods_tpu_torch.desc import train as T
from mods_tpu_torch.config import detector_step
from mods_tpu_torch.io import keys as tkeys
from mods_tpu_torch.ops import image as timage
from mods_tpu_torch.testing import deep_config, warp_pair
from mods_tpu_torch.tools import common
from mods_tpu_torch.twoview import match_images
from torch_parity_helpers import jax_detect_engine, one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARDNET_NPZ = os.path.join(ROOT, "weights", "HardNetPS.npz")
TOOLS = ("golden_run", "export_native", "eval_deep", "diag_deep", "diag_deep_ab",
         "profile")
KP = 512


def _tool(name):
    return importlib.import_module(f"mods_tpu_torch.tools.{name}")


def _run_main(name, argv):
    """The tool's standard output lines from main(argv)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert _tool(name).main(argv) == 0
    return buf.getvalue().splitlines()


def _write_pair(d, h, w, seed):
    """The warp pair's two images as 8-bit PNG files in d."""
    paths = []
    for i, img in enumerate(warp_pair(h, w, seed)[:2]):
        paths.append(str(d / f"img{i + 1}.png"))
        assert cv2.imwrite(paths[-1], np.clip(np.round(img), 0, 255).astype(np.uint8))
    return paths


def _pair_args(paths):
    return ["--img1", paths[0], "--img2", paths[1], "--device", "cpu"]


def _capped(mp):
    """Every tool's configuration capped at KP keypoints a view."""
    load = common.tool_config

    def capped(args, deep=False):
        cfg = load(args, deep)
        cfg.max_keypoints = cfg.max_octave_cands = KP
        return cfg

    mp.setattr(common, "tool_config", capped)


def _deep_weights(mp, tmp):
    """HardNet at its committed weights; AffNet and OriNet at the JAX
    package's seeded random weights in both packages (the opt-in, weight
    files that do not exist), the port's through `params_from_jax`."""
    mp.setenv(tcnn.RANDOM_OPT_IN, "1")
    mp.setattr(tcnn, "random_layers", jcnn._random_params)
    tcnn.invalidate_param_cache()
    jcfg = jconfig.Config()
    jcfg.hessian.affine.useZMQ = True
    jcfg.hessian.affine.doBaumberg = False
    jcfg.domori.useZMQ = True
    jcfg.max_keypoints = jcfg.max_octave_cands = KP
    jcfg.hardnet.weights = HARDNET_NPZ
    jcfg.affnet.weights = str(tmp / "absent_AffNet.pth")
    jcfg.orinet.weights = str(tmp / "absent_OriNet.pth")
    return jcfg


def _ns():
    """The arguments of a tool given no INI."""
    return argparse.Namespace(config=None, iters=None)


def _printed(out, pattern):
    return [tuple(int(x) for x in (m if isinstance(m, tuple) else (m,)))
            for m in re.findall(pattern, out)]


# --------------------------------------------------------------------------- #
# rgb_to_gray
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(96, 128), (96, 128, 3)], ids=["gray", "3_channels"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_rgb_to_gray_matches_jax(shape, dtype):
    img = np.random.default_rng(3).uniform(0, 255, shape).astype(dtype)
    got, ref = timage.rgb_to_gray(img), jimage.rgb_to_gray(img)
    assert got.dtype == ref.dtype == np.float32 and got.shape == shape[:2]
    np.testing.assert_array_equal(got, ref)


# --------------------------------------------------------------------------- #
# diag_deep against the JAX package's stages
# --------------------------------------------------------------------------- #
def _jax_stage_counts(img, jcfg):
    """tools/diag_deep.py's counts, by the JAX package on one image."""
    dimg = jnp.asarray(img)
    h, w = img.shape
    kp = jdet.detect_keypoints(dimg, jcfg.hessian, max_kp=jcfg.max_keypoints,
                               max_octave_cands=jcfg.max_octave_cands)
    n = dict(detected=int(jnp.sum(kp.valid)))
    kp2 = jcnn.affnet_adapt(dimg, kp, jcfg)
    n["affnet_ok"] = int(jnp.sum(kp2.valid))
    rep = jpipe.reproject_keypoints(kp2, np.eye(3), w, h,
                                    jcfg.rootsift.PEParam.mrSize + 0.01, dont_remove=True)
    n["reproj_ok"] = int(jnp.sum(rep.valid))
    kp3 = jcnn.orinet_orient(dimg, JKeypoints(kp2.xy, kp2.A, kp2.s, kp2.response,
                                              rep.valid), jcfg)
    n["orinet"] = int(jnp.sum(kp3.valid))
    rep2 = jpipe.reproject_keypoints(kp3, np.eye(3), w, h, jpipe.K_SIGMA,
                                     dont_remove=False)
    n["border_ok"] = int(jnp.sum(rep2.valid))
    desc = jcnn.hardnet_describe(dimg, JKeypoints(kp3.xy, kp3.A, kp3.s, kp3.response,
                                                  rep2.valid), jcfg)
    n["described"] = int((np.abs(np.asarray(desc)).sum(axis=1) > 0).sum())
    return n


@pytest.fixture(scope="module")
def diag_deep_run(tmp_path_factory):
    """diag_deep's printed counts and the JAX package's on its pair."""
    tmp = tmp_path_factory.mktemp("diag_deep")
    paths = _write_pair(tmp, 96, 128, 1)
    with pytest.MonkeyPatch.context() as mp:
        jcfg = _deep_weights(mp, tmp)
        _capped(mp)
        cfg = common.tool_config(_ns(), deep=True)
        want = tconfig.from_dict(dataclasses.asdict(jcfg))
        for c in (cfg, want):
            c.iters, c.hardnet.weights, c.affnet.weights, c.orinet.weights = [], "", "", ""
        assert cfg == want
        ref = [_jax_stage_counts(cli.load_gray(p), jcfg) for p in paths]
        lines = _run_main("diag_deep", _pair_args(paths))
        tcnn.invalidate_param_cache()
    return lines, ref


@pytest.mark.parametrize("image", [0, 1], ids=["img1", "img2"])
def test_diag_deep_counts_match_jax(diag_deep_run, image):
    lines, ref = diag_deep_run
    row = [ln for ln in lines if ln.startswith(f"img{image + 1}: ")]
    assert len(row) == 1, lines
    got = dict(kv.split("=") for kv in row[0].split(": ", 1)[1].split())
    got = {k: int(v) for k, v in got.items()}
    want = ref[image]
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= max(1, 0.01 * want[k]), (k, got, want)
    assert want["described"] > 50
    assert lines[-1].startswith("reference (graf): graf1 3731/3358")


# --------------------------------------------------------------------------- #
# export_native against the JAX package's writers
# --------------------------------------------------------------------------- #
def _ext_rows(path):
    """{(det, desc): (geometry [n, 24], descriptors [n, dim])} of an
    extended-format file."""
    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    out, pos = {}, 1
    for _ in range(int(lines[0])):
        det, n_maps = lines[pos].rsplit(" ", 1)
        pos += 1
        for _ in range(int(n_maps)):
            dn, n = lines[pos].rsplit(" ", 1)
            dim = int(lines[pos + 1])
            rows = np.array([[float(v) for v in ln.split()]
                             for ln in lines[pos + 2:pos + 2 + int(n)]]).reshape(int(n), -1)
            pos += 2 + int(n)
            out[(det, dn)] = (rows[:, :25], rows[:, 25:25 + dim])
    return out


def _native_rows(path):
    out = {}
    for det, dmap in tkeys.load_regions_native(path, device="cpu").items():
        for dn, f in dmap.items():
            geo = torch.cat([f.reproj.xy, f.reproj.s[:, None],
                             f.reproj.A.reshape(-1, 4)], 1).numpy()
            out[(det, dn)] = (geo, f.desc.numpy() if dn != "None" else np.zeros((len(geo), 0)))
    return out


@pytest.fixture(scope="module")
def export_files(tmp_path_factory):
    """export_native's files and the JAX package's from the same images."""
    tmp = tmp_path_factory.mktemp("export")
    paths = _write_pair(tmp, 96, 128, 2)
    outs = [str(tmp / "port1.txt"), str(tmp / "port2.txt")]
    jouts = [str(tmp / "jax1.txt"), str(tmp / "jax2.txt")]
    with pytest.MonkeyPatch.context() as mp:
        _capped(mp)
        lines = _run_main("export_native", outs + _pair_args(paths))
        cfg = cli.load_cli_config()
        cfg.max_keypoints = cfg.max_octave_cands = KP
        jcfg = jconfig.Config()
        jcfg.max_keypoints = jcfg.max_octave_cands = KP
        jcfg.iters = [jconfig.IterationStep(**dataclasses.asdict(s)) for s in cfg.iters]
        assert tconfig.from_dict(dataclasses.asdict(jcfg)) == cfg
        op_by_op = functools.partial(jax_detect_engine, jit=False)
        mp.setattr(jdet, "detect_keypoints", op_by_op)
        mp.setattr(jpipe, "detect_keypoints", op_by_op)
        for p, out in zip(paths, jouts):
            rep = jtwoview.ImageRepresentation()
            jtwoview._extract_image(jnp.asarray(cli.load_gray(p)), jcfg, jcfg.iters[0],
                                    {}, rep, jpipe.TimeLog())
            store = {det: {dn: fl[0] for dn, fl in dmap.items()}
                     for det, dmap in rep.store.items()}
            jkeys.save_regions_native(out, store)
            jkeys.save_regions_native_ext(out.replace(".txt", "_ext.txt"), store)
    return lines, outs, jouts


@pytest.mark.parametrize("fmt", ["native", "ext"])
@pytest.mark.parametrize("image", [0, 1], ids=["img1", "img2"])
def test_export_native_matches_jax(export_files, fmt, image):
    lines, outs, jouts = export_files
    read = _native_rows if fmt == "native" else _ext_rows
    suffix = "" if fmt == "native" else "_ext"
    got = read(outs[image].replace(".txt", suffix + ".txt"))
    ref = read(jouts[image].replace(".txt", suffix + ".txt"))
    assert list(got) == list(ref) == [("HessianAffine", "None"), ("HessianAffine", "RootSIFT")]
    printed = dict(kv.split("=") for kv in lines[image].split(": ", 1)[1].split(", "))
    for key in ref:
        (g_geo, g_desc), (r_geo, r_desc) = got[key], ref[key]
        assert g_geo.shape == r_geo.shape and len(r_geo) > 50, key
        assert int(printed["/".join(key)]) == len(r_geo)
        np.testing.assert_allclose(g_geo, r_geo, rtol=1e-3, atol=1e-4, err_msg=str(key))
        assert g_desc.shape == r_desc.shape
        if g_desc.size:
            diff = np.abs(g_desc - r_desc)
            assert diff.max() <= 1.0 and (diff > 0).mean() <= 1e-3, key


# --------------------------------------------------------------------------- #
# golden_run, eval_deep and profile against the port's own functions
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pair_96x128(tmp_path_factory):
    return _write_pair(tmp_path_factory.mktemp("pair"), 96, 128, 3)


def _reference(paths, cfg):
    return match_images(cli.load_gray(paths[0]), cli.load_gray(paths[1]), cfg,
                        device="cpu", generator=torch.Generator().manual_seed(cfg.ransac.seed))


def test_golden_run_prints_match_images(pair_96x128, monkeypatch):
    _capped(monkeypatch)
    out = "\n".join(_run_main("golden_run", _pair_args(pair_96x128)))
    cfg = cli.load_cli_config()
    cfg.max_keypoints = cfg.max_octave_cands = KP
    r = _reference(pair_96x128, cfg)
    assert _printed(out, r"regions: (\d+)/(\d+)") == [(r.regions1, r.regions2)]
    assert _printed(out, r"descriptors: (\d+)/(\d+)") == [(r.descriptors1, r.descriptors2)]
    assert _printed(out, r"tentatives: (\d+) unique: (\d+)") == [
        (r.tentatives, r.unique_tentatives)]
    assert _printed(out, r"inliers: (\d+) ") == [(r.inliers,)] and r.inliers >= 15
    assert "(graf ref 21)" in out and "'RANSACTime'" in out


@pytest.fixture(scope="module")
def eval_deep_run(pair_96x128, tmp_path_factory):
    """eval_deep on the committed HardNet and a checkpoint of the
    trainer's naming, and match_images on each."""
    tmp = tmp_path_factory.mktemp("eval_deep")
    ckpt = str(tmp / "hardnet.s2000.npz")
    T.save_hardnet_npz(T.init_hardnet_params(torch.Generator().manual_seed(0), "cpu"), ckpt)
    with pytest.MonkeyPatch.context() as mp:
        _deep_weights(mp, tmp)
        _capped(mp)
        lines = _run_main("eval_deep", [HARDNET_NPZ, ckpt] + _pair_args(pair_96x128))
        ref = []
        for p in (HARDNET_NPZ, ckpt):
            cfg = deep_config()
            cfg.iters = [detector_step(["HessianAffine"], [1.0], 360.0, "ZMQ")]
            cfg.max_keypoints = cfg.max_octave_cands = KP
            cfg.hardnet.weights = p
            ref.append(_reference(pair_96x128, cfg))
        tcnn.invalidate_param_cache()
    return lines, ref, [HARDNET_NPZ, ckpt]


@pytest.mark.parametrize("which", [0, 1], ids=["HardNetPS", "trainer_checkpoint"])
def test_eval_deep_prints_match_images(eval_deep_run, which):
    lines, ref, paths = eval_deep_run
    assert len(lines) == 2
    line, r = lines[which], ref[which]
    assert line.startswith(os.path.basename(paths[which]))
    assert _printed(line, r"tent=\s*(\d+) uniq=\s*(\d+) inl=\s*(\d+)") == [
        (r.tentatives, r.unique_tentatives, r.inliers)]
    assert line.endswith("[graf ref: 264/254/147]")
    if which == 0:
        assert r.inliers >= 15


PROFILE_STAGES = {
    "default": ["detect (all octaves)", "extract (det+ori+desc)", "match_fginn",
                "duplicate_filter", "ransac_h", "FULL match_pair"],
    "kernels": ["gaussian_blur sigma=1.6", "half_image", "build_mip_pyramid",
                "build_octave 0 (blur+resp)", "find_extrema (NMS+compact)",
                "sample_patches 41px x256", "sample_patches 32px x256"],
    "deep": ["mip_pyramid", "cnn patches 32px x256", "hardnet_forward x256",
             "affnet_forward x256", "orinet_forward x256"],
}


@pytest.fixture(scope="module")
def profile_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tcnn.RANDOM_OPT_IN, "1")
        lines = _run_main("profile", ["--size", "96x128", "--reps", "1", "--max-kp",
                                      "256", "--kernels", "--deep", "--device", "cpu"])
        mp.delenv(tcnn.RANDOM_OPT_IN)
        tcnn.invalidate_param_cache()
        bare = _run_main("profile", ["--size", "64x80", "--reps", "1", "--max-kp",
                                     "64", "--deep", "--device", "cpu"])
    return lines, bare


@pytest.mark.parametrize("section", list(PROFILE_STAGES))
def test_profile_prints_every_stage(profile_run, section):
    lines, _ = profile_run
    assert lines[0] == "device=cpu image=(96, 128) max_kp=256"
    timed = {}
    for ln in lines:
        m = re.fullmatch(r"(.{34}) +([0-9.]+) ms", ln)
        if m:
            timed[m.group(1).strip()] = float(m.group(2))
    for name in PROFILE_STAGES[section]:
        assert timed.get(name, 0.0) > 0.0, (name, lines)
    if section != "default":
        assert f"-- {section} --" in lines


def test_profile_skips_nets_without_weights(profile_run):
    _, bare = profile_run
    assert "affnet: weights missing, skipped" in bare
    assert "orinet: weights missing, skipped" in bare
    assert any(ln.startswith("hardnet_forward x64") for ln in bare)


# --------------------------------------------------------------------------- #
# inputs, device, imports
# --------------------------------------------------------------------------- #
def _argv(name, paths, tmp):
    outs = [str(tmp / "k1.txt"), str(tmp / "k2.txt")] if name == "export_native" else []
    return outs + ["--img1", paths[0], "--img2", paths[1], "--device", "cpu"]


@pytest.mark.parametrize("name", TOOLS)
def test_missing_pair_raises(name, tmp_path, capsys):
    """Without images a tool stops with a usage error; it makes no pair."""
    outs = ["a.txt", "b.txt"] if name == "export_native" else []
    with pytest.raises(SystemExit) as e:
        _tool(name).main(outs + ["--device", "cpu"])
    assert e.value.code == 2
    assert "--img1" in capsys.readouterr().err


@pytest.mark.parametrize("name", TOOLS)
def test_missing_files_raise(name, tmp_path):
    """A missing image, a named INI that does not exist, and (eval_deep) a
    checkpoint that does not exist raise FileNotFoundError."""
    paths = _write_pair(tmp_path, 64, 80, 1)
    argv = _argv(name, paths, tmp_path)
    if name == "profile":
        argv += ["--max-kp", "128"]
    with pytest.raises(FileNotFoundError):
        _tool(name).main(_argv(name, [paths[0], str(tmp_path / "absent.png")], tmp_path))
    with pytest.raises(FileNotFoundError):
        _tool(name).main(argv + ["--config", str(tmp_path / "absent.ini")])
    with pytest.raises(FileNotFoundError):
        _tool(name).main(argv + ["--iters", str(tmp_path / "absent.ini")])
    if name == "eval_deep":
        with pytest.raises(FileNotFoundError):
            _tool(name).main([str(tmp_path / "absent.npz")] + argv)


@pytest.mark.parametrize("name", TOOLS)
def test_default_device_is_the_card(name, tmp_path, monkeypatch):
    """Without --device a tool runs on the CUDA card; with none it raises
    and falls back to nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    paths = _write_pair(tmp_path, 64, 80, 1)
    argv = [a for a in _argv(name, paths, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _tool(name).main(argv)


@pytest.fixture(scope="module")
def imported_modules():
    """The JAX modules in sys.modules after each tool's import, in a fresh
    interpreter."""
    code = ("import importlib, json, sys\n"
            "out = {}\n"
            f"for name in {TOOLS!r}:\n"
            "    importlib.import_module('mods_tpu_torch.tools.' + name)\n"
            "    out[name] = sorted(m for m in sys.modules\n"
            "                       if m.split('.')[0] in ('jax', 'jaxlib', 'mods_tpu'))\n"
            "print(json.dumps(out))\n")
    env = {**os.environ, "PYTHONPATH": ROOT}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", TOOLS)
def test_tools_import_no_jax(imported_modules, name):
    assert imported_modules[name] == []
