"""The port's trainer and whitening commands
(mods_tpu_torch/tools/train_hardnet.py, whiten_hardnet.py) on the CPU, on a
tiny pair cache, and the pieces they share with the JAX package's tools
(tools/train_hardnet.py: the cache key, the --cache id offsets, --resume).

The files the commands write load into the port's HardNet (cnn.get_net)
and the JAX package's (cnn._layers_from_state + hardnet_forward), whose
outputs agree within 1e-3 on the 0..255 scale (the CNN tests' tolerance).
No command writes into weights/: every --out is a temporary path."""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mods_tpu.desc import cnn as jcnn
from mods_tpu_torch.config import Config
from mods_tpu_torch.desc import cnn as tcnn
from mods_tpu_torch.desc import train as ttrain
from mods_tpu_torch.tools import train_hardnet as tool
from test_torch_train import _patches
from torch_parity_helpers import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache(path, n=200, n_ids=100, seed=0):
    rng = np.random.default_rng(seed)
    a = _patches(n, seed)
    p = np.clip(a + rng.normal(0, 6, a.shape), 0, 255).astype(np.float32)
    i = rng.integers(0, n_ids, n).astype(np.int64)
    np.savez(path, a=a, p=p, i=i)
    return a, p, i


def _run(module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _forwards_agree(path):
    """The file through the port's get_net and the JAX package's
    hardnet_forward: equal within 1e-3 on 0..255."""
    cfg = Config()
    cfg.hardnet.weights = path
    net = tcnn.get_net(cfg, "hardnet", "cpu")
    layers = {i: {k: jnp.asarray(v) for k, v in q.items()}
              for i, q in jcnn._layers_from_state(dict(np.load(path))).items()}
    x = _patches(32, 9)
    got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcnn.hardnet_forward(jnp.asarray(x), layers)),
                               rtol=0, atol=1e-3)
    tcnn.invalidate_param_cache(path)
    return net


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The trainer on a 200-pair cache: 4 steps in chunks of 2, batch 16."""
    d = tmp_path_factory.mktemp("train")
    cache = str(d / "pairs.npz")
    _cache(cache)
    out = str(d / "hardnet.npz")
    log = _run("mods_tpu_torch.tools.train_hardnet", "--device", "cpu", "--cache", cache,
               "--steps", "4", "--chunk", "2", "--batch", "16", "--out", out)
    return cache, out, log


def test_train_hardnet_command(trained):
    cache, out, log = trained
    # np.savez appends ".npz" to the checkpoints' names, as in the JAX tool
    for suffix in ("", ".best.npz", ".last.npz"):
        assert os.path.exists(out + suffix), suffix
    assert not os.path.exists(out + ".s4.npz")      # tagged every 2000 steps
    _forwards_agree(out + ".best.npz")
    assert "step      2" in log and "step      4" in log and "saved" in log
    net = _forwards_agree(out)
    assert not net.whitened
    start = ttrain.init_hardnet_params(torch.Generator().manual_seed(42), "cpu")
    trained_w = ttrain.load_hardnet_npz(out, "cpu").params()
    assert np.abs(trained_w["w0"] - start.params()["w0"]).max() > 1e-4
    assert not np.array_equal(trained_w["bn1_mean"], start.params()["bn1_mean"])


def test_whiten_hardnet_command(trained):
    cache, out, _ = trained
    log = _run("mods_tpu_torch.tools.whiten_hardnet", out, cache, "--alphas", "0.5",
               "--n", "120", "--device", "cpu")
    wh = out.replace(".npz", ".wh0.5.npz")
    assert f"wrote {wh}" in log
    z = np.load(wh)
    assert z["whiten.mean"].shape == (128,) and z["whiten.W"].shape == (128, 128)
    assert _forwards_agree(wh).whitened


def test_cache_key_and_offsets(tmp_path):
    """The generated pairs' cache file is keyed as the JAX package's tool
    keys it (tools/train_hardnet.py:68-71), and --cache files get ids
    offset by 4e9 apiece (:73-87)."""
    args = tool.parse_args(["--mode", "jitter", "--pairs", "1000", "--images", "8",
                            "--seed", "3", "--data-cache-dir", str(tmp_path)])
    key = hashlib.sha1(b"v3|jitter|1000|8|3").hexdigest()[:12]
    assert tool.cache_path(args) == str(tmp_path / f"hardnet_pairs_{key}.npz")
    c1, c2 = str(tmp_path / "c1.npz"), str(tmp_path / "c2.npz")
    a1, _, i1 = _cache(c1, 20, 10, 1)
    a2, _, i2 = _cache(c2, 30, 10, 2)
    a, p, i = tool.load_caches([c1, c2])
    np.testing.assert_array_equal(a, np.concatenate([a1, a2]))
    np.testing.assert_array_equal(i, np.concatenate([i1, i2 + 4_000_000_000]))
    assert p.shape == a.shape and i.dtype == np.int64


def test_resume_from(trained, tmp_path):
    """--resume: the weights and running statistics of a checkpoint (a
    whitened one too) in place of the fresh net's."""
    _, out, _ = trained
    ckpt = str(tmp_path / "whitened.npz")
    trained_net = ttrain.load_hardnet_npz(out, "cpu")
    ttrain.save_hardnet_npz(trained_net, ckpt,
                            whiten=(np.zeros(128, np.float32), np.eye(128, dtype=np.float32)))
    net = ttrain.init_hardnet_params(torch.Generator().manual_seed(42), "cpu")
    tool.resume_from(net, ckpt)
    ref = trained_net.params()
    for k, v in net.params().items():
        np.testing.assert_array_equal(v, ref[k])
