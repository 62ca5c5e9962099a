"""The port's MSER, feature files and run logs against the JAX package.

- detect_mser: both packages load the same C++ component tree
  (native/mser.cpp), so on the same seeded images the frames are equal to
  1e-6, in every detector mode; the port builds its copy of the library
  under mods_tpu_torch/_build/ and raises when the build fails.
- io/keys.py: every format written by one package is read by the other;
  text files byte-equal, npz arrays equal, loaded features equal.
- io/logs.py: write_log and write_time_log give equal strings.
- config.from_dict keeps the DoG, Harris and MSER parameters and the
  ReadAffs file name.
"""
import dataclasses
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu import config as jconfig
from mods_tpu import types as jtypes
from mods_tpu.detect import mser as jmser
from mods_tpu.io import keys as jkeys
from mods_tpu.io import logs as jlogs
from mods_tpu.pipeline import TimeLog as JTimeLog
from mods_tpu.twoview import TwoViewResult as JTwoViewResult
from mods_tpu_torch import config as tconfig
from mods_tpu_torch import types as ttypes
from mods_tpu_torch.detect import mser as tmser
from mods_tpu_torch.io import keys as tkeys
from mods_tpu_torch.io import logs as tlogs
from mods_tpu_torch.pipeline import TimeLog
from mods_tpu_torch.testing import textured_image
from mods_tpu_torch.twoview import TwoViewResult

KP_FIELDS = ("xy", "A", "s", "response", "valid")


def blobs_image(h=120, w=160, seed=0):
    """Dark and bright discs and ellipses of several sizes on a ramp, with
    a little noise: regions of both polarities."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = 96.0 + 0.2 * xs + rng.normal(0, 2.0, (h, w))
    for _ in range(14):
        cx, cy = rng.uniform(10, w - 10), rng.uniform(10, h - 10)
        a, b, th = rng.uniform(3, 12), rng.uniform(3, 12), rng.uniform(0, np.pi)
        u = (xs - cx) * np.cos(th) + (ys - cy) * np.sin(th)
        v = -(xs - cx) * np.sin(th) + (ys - cy) * np.cos(th)
        img[(u / a) ** 2 + (v / b) ** 2 <= 1] = rng.choice([20.0, 240.0])
    return img.astype(np.float32)


MSER_IMAGES = {"blobs": blobs_image, "textured": lambda: textured_image(96, 128, 3)}
MSER_MODES = {
    "FixedTh": dict(),
    "RegNumber": dict(detector_mode="RegNumber", reg_number=7),
    "RelativeRegNumber": dict(detector_mode="RelativeRegNumber", rel_threshold=0.5),
    "NotLessThanRegions": dict(detector_mode="NotLessThanRegions", reg_number=5),
}


@pytest.mark.parametrize("mode", list(MSER_MODES))
@pytest.mark.parametrize("image", list(MSER_IMAGES))
def test_detect_mser_matches(image, mode):
    img = MSER_IMAGES[image]()
    kw = dict(max_area=0.1, min_size=20, min_margin=5.0, **MSER_MODES[mode])
    j = jmser.detect_mser(img, jconfig.MSERParams(**kw), max_regions=512)
    t = tmser.detect_mser(torch.from_numpy(img), tconfig.MSERParams(**kw),
                          max_regions=512)
    assert t.xy.device.type == "cpu" and t.xy.shape == (512, 2)
    for f in KP_FIELDS:
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   rtol=0, atol=1e-6, err_msg=f)
    n = int(t.valid.sum())
    assert n >= 5 and (mode != "RegNumber" or n == 7)


def test_detect_mser_clips_and_truncates_like_jax():
    """Values outside 0..255 and fractions: clipped, then truncated."""
    img = blobs_image(seed=1) * 1.3 - 40.0 + 0.7
    par = dict(max_area=0.1, min_size=20, min_margin=5.0)
    j = jmser.detect_mser(img, jconfig.MSERParams(**par), max_regions=256)
    t = tmser.detect_mser(img, tconfig.MSERParams(**par), max_regions=256)
    for f in KP_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
    assert int(t.valid.sum()) > 0


def test_mser_library_builds_in_its_own_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tmser, "BUILD_DIR", tmp_path / "build")
    lib = tmser.build_library()
    assert lib.parent == tmp_path / "build" and lib.exists()
    assert tmser.build_library() == lib          # built once, then reused
    # a source that does not compile raises; nothing falls back
    bad = tmp_path / "mser.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tmser, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tmser.build_library()


# --------------------------------------------------------------------------- #
# feature files
# --------------------------------------------------------------------------- #
def _arrays(seed, n=23, d=128, moved=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (n, 2))
    th, an = rng.uniform(-3, 3, n), rng.uniform(0.5, 2, n)
    A = np.stack([np.stack([np.cos(th) * an, -np.sin(th) / an], -1),
                  np.stack([np.sin(th) * an, np.cos(th) / an], -1)], -2)
    if moved:
        A = A * rng.uniform(0.8, 1.2, (n, 1, 1))
    s = rng.uniform(1, 9, n)
    resp = rng.uniform(-50, 50, n)
    valid = rng.uniform(0, 1, n) > 0.2
    desc = rng.integers(0, 256, (n, d)).astype(np.float32)
    return [a.astype(np.float32) for a in (xy, A, s, resp)] + [valid], desc


def feature_pair(seed, d=128):
    """The same features for both packages: detection and original frames
    differ; a fifth of the rows invalid."""
    det, desc = _arrays(seed, d=d)
    rep, _ = _arrays(seed + 100, d=d, moved=True)
    rep[4] = det[4]
    j = jtypes.Features(jtypes.Keypoints(*map(jnp.asarray, det)),
                        jtypes.Keypoints(*map(jnp.asarray, rep)), jnp.asarray(desc))
    t = ttypes.Features(ttypes.Keypoints(*map(torch.from_numpy, det)),
                        ttypes.Keypoints(*map(torch.from_numpy, rep)),
                        torch.from_numpy(desc))
    return j, t


def assert_features_equal(t, j):
    assert t.desc.device.type == "cpu"
    for frame in ("det", "reproj"):
        for f in KP_FIELDS:
            np.testing.assert_array_equal(getattr(getattr(t, frame), f).numpy(),
                                          np.asarray(getattr(getattr(j, frame), f)),
                                          err_msg=f"{frame}.{f}")
    np.testing.assert_array_equal(t.desc.numpy(), np.asarray(j.desc))


def _stores():
    j1, t1 = feature_pair(1)
    j2, t2 = feature_pair(2)
    j3, t3 = feature_pair(3, d=64)
    return ({"HessianAffine": {"None": j1, "RootSIFT": j2}, "MSER": {"HalfSIFT": j3}},
            {"HessianAffine": {"None": t1, "RootSIFT": t2}, "MSER": {"HalfSIFT": t3}})


# writer name -> (call with the JAX package's module and data, the files)
def _write(mod, which, path, data):
    if which == "npz":
        mod.save_npz(str(path / "f.npz"), data)
    elif which == "oxaff":
        mod.save_oxaff(str(path / "f.oxaff"), data)
    elif which == "michal":
        mod.save_michal(str(path / "f.michal"), data)
    elif which == "regions_native":
        mod.save_regions_native(str(path / "f.regions"), data)
    elif which == "regions_native_ext":
        mod.save_regions_native_ext(str(path / "f.regions"), data, img_id=2)
    elif which == "benchmark":
        mod.save_regions_benchmark(data, str(path / "r.txt"), str(path / "d.txt"))
        mod.save_descriptors_benchmark(data, str(path / "desc.txt"))
    return sorted(p.name for p in path.iterdir())


FEATURE_FORMATS = ["npz", "oxaff", "michal"]
STORE_FORMATS = ["regions_native", "regions_native_ext", "benchmark"]


@pytest.mark.parametrize("fmt", FEATURE_FORMATS + STORE_FORMATS)
def test_writers_give_the_same_files(fmt, tmp_path):
    jdata, tdata = _stores() if fmt in STORE_FORMATS else feature_pair(5)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    names = _write(jkeys, fmt, tmp_path / "j", jdata)
    assert _write(tkeys, fmt, tmp_path / "t", tdata) == names
    for name in names:
        a, b = (tmp_path / "j" / name), (tmp_path / "t" / name)
        if name.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype
                np.testing.assert_array_equal(zb[k], za[k], err_msg=k)
        else:
            assert b.read_bytes() == a.read_bytes(), name


LOADERS = {"npz": ("load_npz", "f.npz"), "oxaff": ("load_oxaff", "f.oxaff"),
           "michal": ("load_michal", "f.michal")}


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", list(LOADERS))
def test_loaders_read_what_either_package_wrote(fmt, writer, tmp_path):
    jf, tf = feature_pair(7)
    _write(jkeys if writer == "jax" else tkeys, fmt, tmp_path,
           jf if writer == "jax" else tf)
    name, fname = LOADERS[fmt]
    path = str(tmp_path / fname)
    assert_features_equal(getattr(tkeys, name)(path, device="cpu"),
                          getattr(jkeys, name)(path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_regions_native_reads_either_package(writer, tmp_path):
    jstore, tstore = _stores()
    _write(jkeys if writer == "jax" else tkeys, "regions_native", tmp_path,
           jstore if writer == "jax" else tstore)
    j = jkeys.load_regions_native(str(tmp_path / "f.regions"))
    t = tkeys.load_regions_native(str(tmp_path / "f.regions"), device="cpu")
    assert {k: list(v) for k, v in t.items()} == {k: list(v) for k, v in j.items()}
    for det in j:
        for desc in j[det]:
            assert_features_equal(t[det][desc], j[det][desc])


def test_matches_and_h_files(tmp_path):
    rng = np.random.default_rng(9)
    xy1, xy2 = rng.uniform(0, 500, (2, 17, 2))
    r1, r2 = rng.uniform(0, 1, (2, 17))
    ok = rng.uniform(0, 1, 17) > 0.5
    H = rng.normal(size=(3, 3))
    for mod, sub in ((jkeys, "j"), (tkeys, "t")):
        (tmp_path / sub).mkdir()
        mod.write_matches(str(tmp_path / sub / "m.txt"), xy1, xy2, r1)
        mod.write_matches(str(tmp_path / sub / "m0.txt"), xy1, xy2)
        mod.write_matches_csv(str(tmp_path / sub / "m.csv"), xy1, xy2, r1, r2,
                              "MSER", "HalfRootSIFT", ok)
        mod.write_h(str(tmp_path / sub / "H.txt"), H)
    for name in ("m.txt", "m0.txt", "m.csv", "H.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    np.testing.assert_array_equal(tkeys.read_h(str(tmp_path / "j" / "H.txt")),
                                  jkeys.read_h(str(tmp_path / "t" / "H.txt")))


@pytest.mark.parametrize("fmt", ["text", "npz"])
def test_load_affs_matches(fmt, tmp_path):
    """ReadAffs' files: `n` then `x y s a11 a12 a21 a22` a line, or npz."""
    jf, tf = feature_pair(11)
    if fmt == "npz":
        tkeys.save_npz(str(tmp_path / "affs.npz"), tf)
        path = str(tmp_path / "affs.npz")
    else:
        path = str(tmp_path / "affs.txt")
        tkeys.save_regions_benchmark({"HessianAffine": {"None": tf}}, path,
                                     str(tmp_path / "det.txt"))
    t = tkeys.load_affs(path, device="cpu")
    assert_features_equal(t, jkeys.load_affs(path))
    assert int(t.count()) == int(tf.count()) > 0


def test_loaders_default_to_the_card(tmp_path, monkeypatch):
    _, tf = feature_pair(12)
    tkeys.save_npz(str(tmp_path / "f.npz"), tf)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tkeys.load_affs(str(tmp_path / "f.npz"))


# --------------------------------------------------------------------------- #
# run logs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("ver_type", ["LORANSAC", "GR_TRUTH", "GR_PLUS_RANSAC"])
def test_logs_match(ver_type):
    counts = dict(tentatives=131, unique_tentatives=97, inliers=41,
                  inlier_ratio=41 / 97, steps_done=2, regions1=2665, regions2=3287,
                  descriptors1=2331, descriptors2=2912, true_matches_gt=38)
    times = dict(SynthTime=0.0123, DetectTime=1.5, OrientTime=0.25, DescTime=0.75,
                 MatchTime=0.125, RANSACTime=0.0625)
    outs = []
    for Result, Log, mod in ((JTwoViewResult, JTimeLog, jlogs),
                             (TwoViewResult, TimeLog, tlogs)):
        res = Result(**counts)
        res.timelog = Log(**times)
        buf = io.StringIO()
        mod.write_log(res, ver_type, 3.3, buf)
        mod.write_time_log(res.timelog, 3.3, buf)
        mod.write_time_log(res.timelog, 2.0, buf, write_rel=False, write_desc=False)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and len(outs[0].splitlines()) == 6


def test_from_dict_keeps_the_other_detectors():
    jcfg = jconfig.Config()
    jcfg.dog.pyramid.detector_type = "DoG"
    jcfg.dog.pyramid.iiDoGMode = True
    jcfg.dog.pyramid.threshold = 0.02
    jcfg.harris.pyramid.detector_type = "Harris"
    jcfg.harris.affine.method = "Hessian"
    jcfg.mser = jconfig.MSERParams(max_area=0.05, min_size=25, min_margin=7.0,
                                   detector_mode="RegNumber", reg_number=300)
    jcfg.read_affs_fname = "/data/{name}.affs"
    cfg = tconfig.from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(cfg.dog) == dataclasses.asdict(jcfg.dog)
    assert dataclasses.asdict(cfg.harris) == dataclasses.asdict(jcfg.harris)
    assert dataclasses.asdict(cfg.mser) == dataclasses.asdict(jcfg.mser)
    assert cfg.read_affs_fname == jcfg.read_affs_fname
    assert tconfig.to_dict(cfg) == dataclasses.asdict(jcfg)
