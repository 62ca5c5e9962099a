"""The port's boundaries: it imports neither JAX nor the JAX package, its
config round-trips with the JAX package's, its entry points run on CUDA
unless asked for the CPU, and its containers behave as the JAX ones."""
import dataclasses
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from mods_tpu import config as jconfig
from mods_tpu_torch import config as tconfig
from mods_tpu_torch.types import Keypoints, Tentatives

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|mods_tpu)(\.|\s|$)",
                       re.MULTILINE)


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "mods_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not FORBIDDEN.search(text), f
        assert "mods_tpu." not in text.replace("mods_tpu_torch", ""), f


def test_config_round_trip_with_jax_config():
    jcfg = jconfig.Config()
    jcfg.max_octave_cands = 1024
    jcfg.matching.FGINNThreshold["RootSIFT"] = 0.75
    jcfg.hessian.pyramid.detector_mode = "RelativeTh"
    jcfg.ransac.err_threshold = 3.5
    jcfg.iters = [jconfig.IterationStep(separate_detectors=["HessianAffine"])]
    d = dataclasses.asdict(jcfg)
    cfg = tconfig.from_dict(d)
    assert isinstance(cfg, tconfig.Config)
    assert isinstance(cfg.hessian.pyramid, tconfig.PyramidParams)
    assert isinstance(cfg.iters[0], tconfig.IterationStep)
    assert cfg.hessian.pyramid.detector_mode == "RelativeTh"
    assert cfg.rootsift.useRootSIFT and cfg.rootsift.dims == 128
    assert tconfig.to_dict(cfg) == d
    # the copy is independent of the source dict
    d["matching"]["FGINNThreshold"]["RootSIFT"] = 0.5
    assert cfg.matching.FGINNThreshold["RootSIFT"] == 0.75
    assert tconfig.to_dict(tconfig.Config()) == dataclasses.asdict(jconfig.Config())


def test_entry_points_default_to_cuda():
    from mods_tpu_torch import resolve_device
    from mods_tpu_torch.models import flagship
    img = np.zeros((32, 32), np.float32)
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.extract(img, tconfig.Config(), 16)
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship.match_pair(img, img, tconfig.Config(), 16)


def test_entry_points_restore_the_callers_tf32_setting():
    from mods_tpu_torch import full_float32
    from mods_tpu_torch.models import flagship
    saved = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cudnn.allow_tf32 = True
        with full_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cudnn.allow_tf32
        flagship.extract(np.zeros((32, 32), np.float32), tconfig.Config(), 16,
                         device="cpu")
        assert torch.get_float32_matmul_precision() == "medium"
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_keypoints_sanitize_take_and_to():
    kp = Keypoints(xy=torch.tensor([[1.0, 2.0], [math.nan, 5.0]]),
                   A=torch.full((2, 2, 2), 7.0), s=torch.tensor([2.0, 1e17]),
                   response=torch.tensor([3.0, -4.0]),
                   valid=torch.tensor([True, False]))
    k = kp.sanitize()
    assert k.xy[1].tolist() == [0.0, 0.0] and k.s[1] == 1.0
    assert torch.equal(k.A[1], torch.eye(2)) and k.response[1] == 0.0
    assert torch.equal(k.xy[0], kp.xy[0]) and int(k.count()) == 1
    t = kp.take(torch.tensor([1, 0, 0]), extra_valid=torch.tensor([True, True, False]))
    assert t.n == 3 and t.valid.tolist() == [False, True, False]
    assert kp.to("cpu").xy.device.type == "cpu"


def test_tentatives_count():
    z = torch.zeros(3)
    t = Tentatives(torch.zeros(3, 2), torch.zeros(3, 2), torch.zeros(3, 2, 2),
                   torch.zeros(3, 2, 2), z, z, z, z, z,
                   torch.tensor([True, False, True]))
    assert t.m == 3 and int(t.count()) == 2
