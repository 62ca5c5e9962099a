"""The port's drawing (mods_tpu_torch/io/draw.py) and command-line apps
(mods_tpu_torch/cli.py) against the JAX package's, on the CPU.

Drawing is pixel-equal to mods_tpu/io/draw.py on the same seeded
geometry.  The `mods` command's text outputs are byte-equal to the JAX
CLI's on the same result (both commands given one made-up TwoViewResult
in place of their match_images), and its drawn images pixel-equal.  The
port's commands then run for real at 96x128 with --device cpu: the files
they write parse back to the result.  Config() caps the keypoints at
8192 rows a view, which on one CPU thread takes minutes a pair (the
padded rows reach the kNN); the real runs cap them at 256 through
`small_config`, the only change to what the commands run."""
import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu import cli as jcli
from mods_tpu import twoview as jtwoview
from mods_tpu import types as jtypes
from mods_tpu.io import draw as jdraw
from mods_tpu.pipeline import TimeLog as JTimeLog
from mods_tpu_torch import cli, twoview
from mods_tpu_torch import types as ttypes
from mods_tpu_torch.config import Config
from mods_tpu_torch.io import draw as tdraw
from mods_tpu_torch.io import keys as tkeys
from mods_tpu_torch.pipeline import TimeLog
from mods_tpu_torch.testing import iters_ini, mods_schedule, textured_image, tilted_pair
from torch_parity_helpers import one_torch_thread  # noqa: F401  (autouse)

SMALL_KP = 256


def _frames(n, seed):
    """Seeded xy, A (rotated anisotropic, unit determinant), s."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(5, 190, (n, 2)).astype(np.float32)
    theta = rng.uniform(0, np.pi, n)
    stretch = rng.uniform(0.6, 1.6, n)
    c, s_ = np.cos(theta), np.sin(theta)
    R = np.stack([np.stack([c, -s_], -1), np.stack([s_, c], -1)], -2)
    A = (R * np.stack([stretch, 1.0 / stretch], -1)[:, None, :]).astype(np.float32)
    s = rng.uniform(1.0, 7.0, n).astype(np.float32)
    return xy, A, s


def _features(n=40, seed=0, dim=128):
    xy, A, s = _frames(n, seed)
    rng = np.random.default_rng(seed + 100)
    resp = rng.uniform(10, 200, n).astype(np.float32)
    desc = rng.integers(0, 255, (n, dim)).astype(np.float32)
    valid = rng.uniform(size=n) < 0.8
    arrays = (xy, A, s, resp, valid)
    jkp = jtypes.Keypoints(*[jnp.asarray(a) for a in arrays])
    tkp = ttypes.Keypoints(*[torch.from_numpy(np.asarray(a)) for a in arrays])
    return (jtypes.Features(det=jkp, reproj=jkp, desc=jnp.asarray(desc)),
            ttypes.Features(det=tkp, reproj=tkp, desc=torch.from_numpy(desc)))


def _tentatives(n=30, seed=1):
    xy1, A1, s1 = _frames(n, seed)
    xy2, A2, s2 = _frames(n, seed + 1)
    rng = np.random.default_rng(seed + 2)
    d1 = rng.uniform(1, 100, n).astype(np.float32)
    d2 = d1 + rng.uniform(1, 100, n).astype(np.float32)
    ratio = np.sqrt(d1 / d2).astype(np.float32)
    valid = rng.uniform(size=n) < 0.7
    arrays = (xy1, xy2, A1, A2, s1, s2, d1, d2, ratio, valid)
    return (jtypes.Tentatives(*[jnp.asarray(a) for a in arrays]),
            ttypes.Tentatives(*[torch.from_numpy(np.asarray(a)) for a in arrays]))


F_TRUE = np.array([[0, -1e-4, 0.01], [1e-4, 0, -0.02], [-0.01, 0.02, 1.0]])


def test_draw_regions_pixel_equal():
    img = np.random.default_rng(3).uniform(0, 255, (160, 200)).astype(np.float32)
    jf, tf = _features()
    want = jdraw.draw_regions(img, jf)
    for im in (img, torch.from_numpy(img)):
        got = tdraw.draw_regions(im, tf)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(tdraw.draw_regions(img, tf, scale=1.5, color=tdraw.RED,
                                             thickness=2),
                          jdraw.draw_regions(img, jf, scale=1.5, color=jdraw.RED,
                                             thickness=2))


@pytest.mark.parametrize("is_f", [False, True])
def test_draw_matches_pixel_equal(is_f):
    rng = np.random.default_rng(4)
    i1 = rng.uniform(0, 255, (160, 200)).astype(np.float32)
    i2 = rng.uniform(0, 255, (150, 190)).astype(np.float32)
    jt, tt = _tentatives()
    want = jdraw.draw_matches(i1, i2, jt, H=F_TRUE, is_f=is_f)
    got = tdraw.draw_matches(i1, torch.from_numpy(i2), tt, H=torch.from_numpy(F_TRUE),
                             is_f=is_f)
    assert got.shape == (160, 200 + 8 + 190, 3) and np.array_equal(got, want)
    if is_f:
        # blue epipolar lines in the right image
        right = got[:, 208:].astype(int)
        assert (right[..., 0] - right[..., 2]).max() > 50
    assert np.array_equal(tdraw.draw_matches(i1, i2, tt, draw_lines=False, sep=3),
                          jdraw.draw_matches(i1, i2, jt, draw_lines=False, sep=3))


def test_epipolar_line_equal():
    rng = np.random.default_rng(5)
    Fs = [F_TRUE, rng.normal(size=(3, 3)), np.array([[0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])]
    n_none = 0
    for F in Fs:
        for xy in rng.uniform(-50, 250, (40, 2)):
            want = jdraw._epipolar_line(F, xy, 200, 160)
            assert tdraw._epipolar_line(F, xy, 200, 160) == want
            n_none += want is None
    assert 0 < n_none < 120


# --------------------------------------------------------------------------- #
# the mods command
# --------------------------------------------------------------------------- #
def _made_up_results():
    """One TwoViewResult of each package over the same arrays."""
    jt, tt = _tentatives(24, 7)
    fj = [_features(30, s) for s in (10, 11, 12)]
    H = np.array([[1.01, 0.02, 3.5], [-0.01, 0.99, -2.25], [1e-5, -2e-5, 1.0]])
    counts = dict(tentatives=40, unique_tentatives=24, inliers=int(jt.valid.sum()),
                  inlier_ratio=0.4375, H=H, steps_done=2, regions1=61, regions2=57,
                  descriptors1=50, descriptors2=47)
    times = (0.1, 0.25, 0.05, 0.125, 0.5, 0.0625, 0.03125)
    jres = jtwoview.TwoViewResult(
        **counts, timelog=JTimeLog(*times),
        final=jtypes.MatchResult(jt, jnp.asarray(H), jt.valid.sum(), jnp.float32(1.0)),
        rep1=jtwoview.ImageRepresentation("img1", {"HessianAffine": {
            "None": [fj[0][0]], "RootSIFT": [fj[1][0], fj[2][0]]}}),
        rep2=jtwoview.ImageRepresentation("img2", {"HessianAffine": {
            "None": [fj[2][0]], "RootSIFT": [fj[0][0]]}, "DoG": {"None": [fj[1][0]]}}))
    tres = twoview.TwoViewResult(
        **counts, timelog=TimeLog(*times),
        final=ttypes.MatchResult(tt, torch.from_numpy(H), tt.count(), torch.tensor(1.0)),
        rep1=twoview.ImageRepresentation("img1", {"HessianAffine": {
            "None": [fj[0][1]], "RootSIFT": [fj[1][1], fj[2][1]]}}),
        rep2=twoview.ImageRepresentation("img2", {"HessianAffine": {
            "None": [fj[2][1]], "RootSIFT": [fj[0][1]]}, "DoG": {"None": [fj[1][1]]}}))
    return jres, tres


def _write_pair(d, img1, img2):
    paths = [os.path.join(d, n) for n in ("img1.png", "img2.png")]
    for p, im in zip(paths, (img1, img2)):
        assert cv2.imwrite(p, np.clip(np.round(im), 0, 255).astype(np.uint8))
    return paths


def _write_inis(d, steps):
    cfg_ini, iters = os.path.join(d, "config.ini"), os.path.join(d, "iters.ini")
    with open(cfg_ini, "w") as fh:
        fh.write("[RANSAC]\nerr_threshold=2.0\n")
    with open(iters, "w") as fh:
        fh.write(iters_ini(steps))
    return cfg_ini, iters


def _mods_args(d, imgs, ver_type, inis):
    outs = [os.path.join(d, n) for n in ("out1.png", "out2.png", "k1.txt", "k2.txt",
                                         "matchings.txt", "log.txt")]
    return [*imgs, *outs, ver_type, "", *inis], outs


@pytest.mark.parametrize("ver_type", ["LORANSAC", "ORSA"])
def test_mods_outputs_equal_the_jax_cli(tmp_path, monkeypatch, ver_type):
    """Both packages' `mods` commands on the same made-up result: every
    text output byte-equal (the log and .time up to the run's own total
    time), the drawn images pixel-equal."""
    jres, tres = _made_up_results()
    monkeypatch.setattr(jtwoview, "match_images", lambda *a, **k: jres)
    monkeypatch.setattr(cli, "match_images", lambda *a, **k: tres)
    rng = np.random.default_rng(8)
    imgs = _write_pair(str(tmp_path), rng.uniform(0, 255, (160, 200)),
                       rng.uniform(0, 255, (150, 190)))
    inis = _write_inis(str(tmp_path), mods_schedule()[:1])
    outs = {}
    for name, run, extra in (("jax", jcli.cmd_mods, []),
                             ("port", cli.cmd_mods, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        args, outs[name] = _mods_args(str(d), imgs, ver_type, inis)
        assert run(args + extra) == 0
    j, t = outs["jax"], outs["port"]
    for a, b in zip(j[:2], t[:2]):
        assert np.array_equal(cv2.imread(a), cv2.imread(b))
    for a, b in [(j[i] + e, t[i] + e) for i, e in ((2, ""), (3, ""), (4, ""),
                                                   (4, ".csv"), (5, ".h"))]:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), b
    lines = {}
    for name, o in outs.items():
        with open(o[5]) as fh, open(o[5] + ".time") as ft:
            lines[name] = fh.read().splitlines(), ft.read().splitlines()
    (jlog, jtime), (tlog, ttime) = lines["jax"], lines["port"]
    # WriteLog: the total time leads; the JSON record holds it too
    assert jlog[0].split()[1:] == tlog[0].split()[1:]
    jrec, trec = json.loads(jlog[1]), json.loads(tlog[1])
    jrec.pop("total_time_s"), trec.pop("total_time_s")
    assert jrec == trec and len(jlog) == len(tlog) == 2
    # WriteTimeLog: headers, then the phases' seconds (MISC and the total
    # end the line), then their shares of the total
    assert jtime[:2] == ttime[:2] and len(jtime) == len(ttime) == 4
    assert jtime[2].split()[:6] == ttime[2].split()[:6]
    assert len(jtime[3].split()) == len(ttime[3].split()) == 8


@pytest.fixture
def small_config(monkeypatch):
    """The commands' configuration with the keypoints capped at SMALL_KP."""
    load = cli.load_cli_config

    def capped(*paths):
        cfg = load(*paths)
        cfg.max_keypoints = cfg.max_octave_cands = SMALL_KP
        return cfg
    monkeypatch.setattr(cli, "load_cli_config", capped)


def _check_mods_files(r, outs, img_shapes):
    out1, out2, k1, k2, matchings, log = outs
    with open(matchings) as fh:
        rows = fh.read().splitlines()
    # the matchings file holds the final inliers, as the JAX CLI writes it
    assert int(rows[0]) == r.inliers == len(rows) - 1 > 0
    with open(matchings + ".csv") as fh:
        assert len(fh.read().splitlines()) == r.inliers + 1
    np.testing.assert_allclose(tkeys.read_h(log + ".h"), r.H, rtol=1e-5, atol=1e-6)
    with open(log) as fh:
        line, record = fh.read().splitlines()
    assert line.split()[1:] == [str(r.inliers), str(r.unique_tentatives),
                                f"{100.0 * r.inlier_ratio:.3g}", str(r.regions1),
                                str(r.regions2), str(r.steps_done)]
    record = json.loads(record)
    assert [record[k] for k in ("tentatives", "unique", "inliers", "regions1",
                                "regions2", "descriptors1", "descriptors2", "steps")] == \
        [r.tentatives, r.unique_tentatives, r.inliers, r.regions1, r.regions2,
         r.descriptors1, r.descriptors2, r.steps_done]
    for path, regions, descriptors in ((k1, r.regions1, r.descriptors1),
                                       (k2, r.regions2, r.descriptors2)):
        store = tkeys.load_regions_native(path, device="cpu")
        assert sum(int(f.count()) for m in store.values() for f in [m["None"]]) == regions
        assert sum(int(f.count()) for m in store.values() for n, f in m.items()
                   if n != "None") == descriptors
    if out1:
        (h1, w1), (h2, w2) = img_shapes
        assert cv2.imread(out1).shape == (max(h1, h2), w1 + 8 + w2, 3)
        assert cv2.imread(out2).shape == (h2, w2, 3)


def test_run_mods_and_the_command_on_the_cpu(tmp_path, monkeypatch, small_config):
    """run_mods on the arrays and the `mods` command on their PNG files,
    one Hessian-Affine step on a 96x128 pair tilted by 2: every file
    parses back to the result's counts, `.h` holds r.H."""
    img1, img2, _ = tilted_pair(96, 128, 1, 2.0, 0.3)
    d = str(tmp_path)
    cfg = cli.load_cli_config()
    assert cfg.iters == mods_schedule()[:1] and cfg.max_keypoints == SMALL_KP
    outputs = cli.ModsOutputs(*(os.path.join(d, n) for n in
                                ("a_k1.txt", "a_k2.txt", "a_m.txt", "a_log.txt")))
    r = cli.run_mods(img1, img2, cfg, outputs, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert r.inliers >= 8
    _check_mods_files(r, ["", "", *vars(outputs).values()], None)

    imgs = _write_pair(d, img1, img2)
    inis = _write_inis(d, mods_schedule()[:1])
    args, outs = _mods_args(d, imgs, "LORANSAC", inis)
    seen = {}
    match = cli.match_images

    def keep(*a, **k):
        seen["r"] = match(*a, **k)
        return seen["r"]
    monkeypatch.setattr(cli, "match_images", keep)
    assert cli.main(["mods", *args, "--device=cpu"]) == 0
    assert seen["r"].inliers >= 8
    _check_mods_files(seen["r"], outs, (img1.shape, img2.shape))


def test_extract_and_extract_batch_with_shards(tmp_path, small_config):
    """`extract` of one image equals `extract_batch`'s output for it; two
    shards (0/2, 1/2) write what one process (0/1) writes, byte for byte;
    a shard run again skips what exists."""
    d = str(tmp_path)
    imgs = []
    for i in range(2):
        p = os.path.join(d, f"im{i}.png")
        cv2.imwrite(p, np.clip(textured_image(96, 128, 20 + i), 0, 255).astype(np.uint8))
        imgs.append(p)

    def batch(sub, shards):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
        outs = [os.path.join(d, sub, f"im{i}.npz") for i in range(len(imgs))]
        lists = [os.path.join(d, sub, n) for n in ("in.txt", "out.txt")]
        for path, items in zip(lists, (imgs, outs)):
            with open(path, "w") as fh:
                fh.write("\n".join(items))
        for shard in shards:
            assert cli.main(["extract_batch", *lists, "--device", "cpu",
                             "--shard", shard]) == 0
        return outs

    single = batch("single", ["0/1"])
    sharded = batch("sharded", ["0/2", "1/2"])
    one = os.path.join(d, "one.npz")
    assert cli.main(["extract", imgs[1], one, "--device", "cpu"]) == 0
    for a, b in zip(single, sharded):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    with open(one, "rb") as fa, open(single[1], "rb") as fb:
        assert fa.read() == fb.read()
    assert int(tkeys.load_npz(one, device="cpu").count()) > 20
    before = [os.path.getmtime(p) for p in sharded]
    batch("sharded", ["1/2"])
    assert [os.path.getmtime(p) for p in sharded] == before
    # the OxAff text format and the benchmark splits
    txt = os.path.join(d, "one.txt")
    assert cli.main(["extract", imgs[0], txt, f"--benchmark-out={d}/b",
                     "--device", "cpu"]) == 0
    n = int(tkeys.load_oxaff(txt, device="cpu").count())
    with open(f"{d}/b.desc") as fh:
        assert n == len(fh.read().splitlines()) > 20


def test_configuration_and_arguments(tmp_path, monkeypatch):
    """No INI: Config() and one Hessian-Affine step; a named INI that does
    not exist raises; bad options raise; without a card only --device cpu
    runs."""
    cfg = cli.load_cli_config()
    base = Config()
    base.iters = mods_schedule()[:1]
    assert cfg == base
    cfg_ini, iters = _write_inis(str(tmp_path), mods_schedule())
    cfg = cli.load_cli_config(cfg_ini, iters)
    assert cfg.iters == mods_schedule() and cfg.ransac.err_threshold == 2.0
    missing = str(tmp_path / "missing.ini")
    for paths in ((missing,), (None, missing), (cfg_ini, missing)):
        with pytest.raises(FileNotFoundError):
            cli.load_cli_config(*paths)
    with pytest.raises(FileNotFoundError):
        cli.main(["extract", "a.png", "a.npz", missing, "--device", "cpu"])
    for argv in (["extract_batch", "a", "b", "--shard", "2/2", "--device", "cpu"],
                 ["extract_batch", "a", "b", "--shard=x", "--device", "cpu"],
                 ["mods", "a", "b", "--fast", "--device", "cpu"],
                 ["mods", "a", "b", "--device"]):
        with pytest.raises(ValueError):
            cli.main(argv)
    assert cli.main([]) == 1 and cli.main(["detect"]) == 1
    assert cli.main(["mods", "only_one.png", "--device", "cpu"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["extract", "a.png", "a.npz"])


def test_mods_flags(tmp_path, monkeypatch, small_config):
    """--clahe with --mask (a `<image>_mask.png` beside image 2 blanks its
    left half: no region of image 2 lies inside it) and --pre-extracted (the
    `extract` command's npz files in place of the images: one step)."""
    img1, img2, _ = tilted_pair(96, 128, 1, 2.0, 0.3)
    d = str(tmp_path)
    imgs = _write_pair(d, img1, img2)
    mask = np.full(img2.shape, 255, np.uint8)
    mask[:, :64] = 0
    assert cv2.imwrite(os.path.join(d, "img2_mask.png"), mask)
    seen = []
    match = cli.match_images
    monkeypatch.setattr(cli, "match_images", lambda *a, **k: seen.append(match(*a, **k))
                        or seen[-1])
    args, outs = _mods_args(d, imgs, "LORANSAC", ())
    assert cli.main(["mods", *args, "--clahe", "--mask", "--device", "cpu"]) == 0
    k2 = tkeys.load_regions_native(outs[3], device="cpu")["HessianAffine"]["None"]
    # the mask's edge at x 64 makes blobs a few pixels left of it
    assert k2.count() > 0 and (k2.reproj.xy[:, 0] > 48).all()
    npz = [os.path.join(d, f"f{i}.npz") for i in (1, 2)]
    for img, out in zip(imgs, npz):
        assert cli.main(["extract", img, out, "--device", "cpu"]) == 0
    args, outs = _mods_args(os.path.join(d, "pre"), npz, "LORANSAC", ())
    os.makedirs(os.path.join(d, "pre"))
    assert cli.main(["mods", *args, "--pre-extracted", "--device", "cpu"]) == 0
    r = seen[-1]
    assert r.steps_done == 1 and r.inliers >= 8
    _check_mods_files(r, ["", "", *outs[2:]], None)
