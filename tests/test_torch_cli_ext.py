"""The external-command escape hatch of the port (mods_tpu_torch/desc/
cli_desc.py) against the JAX package's (mods_tpu/desc/cli_desc.py), and
in `pipeline.extract_view`, on the CPU.

Each tool is a mock (`tool`, below, and test_cli_ext.py's constant ones):
it keeps a copy of the patch column image it was given and answers with
numbers that depend on the patch's index only, so the two packages'
answers are the same and what is compared is what each does with them
(A and s within 1e-5, flags equal) and the patches handed over (within 1
grey level: the packages' samplers agree to 1e-3 before the rounding to
bytes, which then flips a pixel now and then)."""
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu.desc import cli_desc as jcli
from mods_tpu.types import Keypoints as JKeypoints
from mods_tpu_torch.config import Config
from mods_tpu_torch.desc import cli_desc as tcli
from mods_tpu_torch.pipeline import extract_view
from mods_tpu_torch.testing import textured_image
from mods_tpu_torch.types import Keypoints
from test_cli_ext import _keypoints, _mock_tool
from torch_parity_helpers import one_torch_thread  # noqa: F401  (autouse)

TOOL = r'''
import shutil, sys
import cv2
import numpy as np
mode, keep, src, dst = sys.argv[1:5]
shutil.copy(src, keep)
img = cv2.imread(src, cv2.IMREAD_GRAYSCALE)
n = img.shape[0] // img.shape[1]
k = np.arange(n)
if mode == "desc":
    rows = np.stack([k, (k % 5) * 0.25, np.full(n, n)], 1)
    vals = [3] + list(rows.ravel())
elif mode == "ori":
    vals = 0.1 * (k % 7) - 0.3
else:
    vals = np.stack([1.2 + 0.05 * (k % 3), 0.1 * (k % 2), -0.05 * (k % 4),
                     np.full(n, 0.8)], 1).ravel()
with open(dst, "w") as fh:
    fh.write(" ".join(f"{v:.9g}" for v in vals))
'''


def tool(tmp_path, mode, keep):
    """The runfile of the mock tool in `mode` (desc, ori, aff), keeping
    its input at `keep`."""
    path = tmp_path / "tool.py"
    if not path.exists():
        path.write_text(TOOL)
    return f"{sys.executable} {path} {mode} {keep}"


def _angles(n):
    return 0.1 * (np.arange(n) % 7) - 0.3


def _quads(n):
    k = np.arange(n)
    return np.stack([1.2 + 0.05 * (k % 3), 0.1 * (k % 2), -0.05 * (k % 4),
                     np.full(n, 0.8)], 1).astype(np.float32)


def seeded_keypoints(n=48, seed=0, h=100, w=120):
    """Keypoints over the image and off its borders, a few invalid rows."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(2, w - 2, n), rng.uniform(2, h - 2, n)], 1)
    th = rng.uniform(0, np.pi, n)
    an = rng.uniform(0.7, 1.4, n)
    A = np.stack([np.stack([np.cos(th) * an, -np.sin(th) / an], -1),
                  np.stack([np.sin(th) * an, np.cos(th) / an], -1)], -2)
    s = rng.uniform(0.8, 4.0, n)
    valid = rng.uniform(size=n) < 0.85
    arrays = [a.astype(np.float32) for a in (xy, A, s, np.zeros(n))] + [valid]
    return (JKeypoints(*[jnp.asarray(a) for a in arrays]),
            Keypoints(*[torch.from_numpy(np.asarray(a)) for a in arrays]))


def _image():
    return np.random.default_rng(0).uniform(0, 255, (100, 120)).astype(np.float32)


def _assert_columns_close(a, b):
    ca, cb = (cv2.imread(p, cv2.IMREAD_GRAYSCALE).astype(int) for p in (a, b))
    assert ca.shape == cb.shape
    diff = np.abs(ca - cb)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def _assert_keypoints_close(t, j):
    assert np.array_equal(t.valid.numpy(), np.asarray(j.valid))
    v = t.valid.numpy()
    assert v.sum() > 0
    np.testing.assert_allclose(t.A.numpy()[v], np.asarray(j.A)[v], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.s.numpy(), np.asarray(j.s), rtol=1e-5)
    np.testing.assert_array_equal(t.xy.numpy(), np.asarray(j.xy))


@pytest.mark.parametrize("photo_norm", [True, False])
def test_describe_with_cli_matches(tmp_path, photo_norm):
    img = _image()
    jkp, tkp = seeded_keypoints()
    keep = {p: str(tmp_path / f"{p}.bmp") for p in ("jax", "port")}
    want = jcli.describe_with_cli(jnp.asarray(img), jkp, tool(tmp_path, "desc", keep["jax"]),
                                  photo_norm=photo_norm)
    got = tcli.describe_with_cli(img, tkp, tool(tmp_path, "desc", keep["port"]),
                                 photo_norm=photo_norm, device="cpu")
    assert got.shape == want.shape == (48, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    _assert_columns_close(keep["port"], keep["jax"])


def test_orient_with_cli_matches(tmp_path):
    img = _image()
    jkp, tkp = seeded_keypoints(seed=1)
    keep = {p: str(tmp_path / f"{p}.bmp") for p in ("jax", "port")}
    want = jcli.orient_with_cli(jnp.asarray(img), jkp, tool(tmp_path, "ori", keep["jax"]))
    got = tcli.orient_with_cli(torch.from_numpy(img), tkp,
                               tool(tmp_path, "ori", keep["port"]))
    _assert_keypoints_close(got, want)
    assert 0 < got.valid.sum() < tkp.valid.sum()      # the border drops some
    _assert_columns_close(keep["port"], keep["jax"])


def test_affine_shape_with_cli_matches(tmp_path):
    img = _image()
    jkp, tkp = seeded_keypoints(seed=2)
    keep = {p: str(tmp_path / f"{p}.bmp") for p in ("jax", "port")}
    want = jcli.affine_shape_with_cli(jnp.asarray(img), jkp,
                                      tool(tmp_path, "aff", keep["jax"]), mr_size=3.0)
    got = tcli.affine_shape_with_cli(torch.from_numpy(img), tkp,
                                     tool(tmp_path, "aff", keep["port"]), mr_size=3.0)
    _assert_keypoints_close(got, want)
    # the rectified frames are lower-triangular; s carries the reference's s1
    v = got.valid.numpy()
    assert np.all(got.A.numpy()[v][:, 0, 1] == 0)
    q = _quads(48)
    s1 = np.sqrt(np.abs(q[:, 0] * q[:, 3] - q[:, 0] * q[:, 2]))
    np.testing.assert_allclose(got.s.numpy(), tkp.s.numpy() * s1, rtol=1e-6)
    _assert_columns_close(keep["port"], keep["jax"])


@pytest.mark.parametrize("which", ["ori", "aff"])
def test_constant_mock_tools_match(tmp_path, which):
    """test_cli_ext.py's tools and keypoints through both packages."""
    img = jnp.asarray(np.random.default_rng(0).uniform(0, 255, (100, 120)),
                      jnp.float32)
    jkp = _keypoints()
    tkp = Keypoints(*[torch.from_numpy(np.array(getattr(jkp, f)))
                      for f in ("xy", "A", "s", "response", "valid")])
    if which == "ori":
        runfile = f"{sys.executable} {_mock_tool(tmp_path, 'oritool.py', '0.5')}"
        want = jcli.orient_with_cli(img, jkp, runfile, mr_size=5.1962, patch_size=32)
        got = tcli.orient_with_cli(torch.from_numpy(np.array(img)), tkp, runfile,
                                   mr_size=5.1962, patch_size=32)
    else:
        runfile = f"{sys.executable} {_mock_tool(tmp_path, 'afftool.py', '1.2 0.0 0.0 0.8')}"
        want = jcli.affine_shape_with_cli(img, jkp, runfile, mr_size=3.0, patch_size=41)
        got = tcli.affine_shape_with_cli(torch.from_numpy(np.array(img)), tkp, runfile,
                                         mr_size=3.0, patch_size=41)
    _assert_keypoints_close(got, want)


def _small_config():
    cfg = Config()
    cfg.max_keypoints = cfg.max_octave_cands = 256
    return cfg


@pytest.mark.parametrize("which", ["aff", "ori", "desc"])
def test_extract_view_runs_the_external_commands(tmp_path, which):
    """extract_view on the CPU with an external affine-shape, orientation
    or descriptor command (it raised NotImplementedError before): the
    tool's answers reach the features."""
    img = torch.from_numpy(textured_image(96, 128, 5))
    cfg = _small_config()
    keep = str(tmp_path / "in.bmp")
    descs = ["RootSIFT"]
    if which == "aff":
        cfg.hessian.affine.external_command = tool(tmp_path, "aff", keep)
    elif which == "ori":
        cfg.domori.external_command = tool(tmp_path, "ori", keep)
    else:
        cfg.cli_descriptor_runfile = tool(tmp_path, "desc", keep)
        descs = ["CLIDescriptor"]
    vf = extract_view(img, np.eye(3), 128, 96, cfg, "HessianAffine", descs)
    f = vf.by_desc[descs[0]]
    v = f.valid.numpy()
    n = int(v.sum())
    assert n > 10 and os.path.exists(keep)
    col = cv2.imread(keep, cv2.IMREAD_GRAYSCALE)
    if which == "aff":
        # rectified, lower-triangular frames from the tool's quads
        reg = vf.regions.det
        assert np.all(reg.A.numpy()[reg.valid.numpy()][:, 0, 1] == 0)
        assert col.shape[1] == cfg.hessian.affine.patchSize == 41
    elif which == "ori":
        # each descriptor row is its region rotated by the tool's angle
        ang = _angles(f.n)
        c, s = np.cos(-ang), np.sin(-ang)
        A = vf.regions.det.A.numpy()
        rot = np.stack([np.stack([A[:, 0, 0] * c - A[:, 0, 1] * s,
                                  A[:, 0, 0] * s + A[:, 0, 1] * c], -1),
                        np.stack([A[:, 1, 0] * c - A[:, 1, 1] * s,
                                  A[:, 1, 0] * s + A[:, 1, 1] * c], -1)], -2)
        np.testing.assert_allclose(f.det.A.numpy()[v], rot[v], atol=1e-6)
    else:
        k = np.arange(n)
        want = np.stack([k, (k % 5) * 0.25, np.full(n, n)], 1)
        np.testing.assert_array_equal(f.desc.numpy()[v], want)
        assert col.shape == (41 * n, 41)
    # a CLIDescriptor without a command is unknown, as in the JAX package
    cfg = _small_config()
    with pytest.raises(ValueError, match="CLIDescriptor"):
        extract_view(img, np.eye(3), 128, 96, cfg, "HessianAffine", ["CLIDescriptor"])


def test_a_failing_tool_raises():
    _, tkp = seeded_keypoints()
    with pytest.raises(subprocess.CalledProcessError):
        tcli.describe_with_cli(_image(), tkp,
                               f"{sys.executable} -c 'raise SystemExit(3)'", device="cpu")
