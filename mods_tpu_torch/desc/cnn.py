"""The CNN stages: HardNet descriptor, AffNet affine shape, OriNet orientation.

Counterpart of the JAX package's desc/cnn.py, which replaces the
reference's three ZeroMQ PyTorch daemons (desc_server.py,
affnet_server.py, orinet_server.py and the DescribeWithZmq client,
imagerepresentation.cpp:21-103) with in-process nets.  The architectures
are the daemons' (desc_server.py:55-92, affnet_server.py:45-84,
orinet_server.py:45-82); the post-processing too: HardNet's output is
quantized as clip(210*(d+0.45), 0, 255) (desc_server.py:42), AffNet adds
1 to the diagonal, OriNet's angle is atan2(y, x).

The nets are `nn.Module`s in eval mode (`HardNet`, `AffNet`, `OriNet`);
their convolutions are `torch.nn.functional.conv2d` (cuDNN on the card)
in full float32 (`full_float32`: no TF32), as the JAX package leaves them
to XLA's convolution outside any Pallas kernel.  Their patches come from
the mip patch engine (the resample kernels on the card) or from the
reference's two-stage sampler, as `Config.patch_source` says
(`_use_engine`).

Only the valid rows are forwarded, in chunks of at most CHUNK patches,
and scattered back into zeros.  The JAX package forwards every padded
row (a view sends max_keypoints x maxAngles of them); every stage of
these nets (input norm, BN with running statistics, pooling) works on
one sample at a time, so the valid rows get the same values as there,
and the others the zeros that the JAX package's callers put there.
"""
from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import full_float32, resolve_device
from ..config import CNNParams, Config
from ..detect.affine_shape import eigenvalues_2x2, rectify_up_is_up
from ..ops import image as imops
from ..ops import patch_engine as pe
from ..ops import patches as patchops
from ..types import Keypoints

# the most patches a net takes in one call
CHUNK = 8192

# the opt-in that lets a missing weight file give seeded random weights
RANDOM_OPT_IN = "MODS_TPU_ALLOW_RANDOM_CNN"

WEIGHTS_DIR = Path(__file__).resolve().parents[2] / "weights"
# where AffNet.pth and OriNet.pth go once they are in the repository
DEFAULT_WEIGHTS = {"hardnet": WEIGHTS_DIR / "HardNetPS.npz",
                   "affnet": WEIGHTS_DIR / "AffNet.pth",
                   "orinet": WEIGHTS_DIR / "OriNet.pth"}

# (torch Sequential index, kind, stride, padding, ReLU after); the
# dropout at 18 is the identity in eval
HARDNET_SPEC = (
    (0, "conv", 1, 1, False), (1, "bn", 1, 0, True),
    (3, "conv", 1, 1, False), (4, "bn", 1, 0, True),
    (6, "conv", 2, 1, False), (7, "bn", 1, 0, True),
    (9, "conv", 1, 1, False), (10, "bn", 1, 0, True),
    (12, "conv", 2, 1, False), (13, "bn", 1, 0, True),
    (15, "conv", 1, 1, False), (16, "bn", 1, 0, True),
    (19, "conv", 1, 0, False), (20, "bn", 1, 0, False),
)
# AffNet's trunk; its last convolution is 8x8 with padding 0 and a bias
AFFNET_SPEC = HARDNET_SPEC[:-2] + ((19, "conv", 1, 0, False),
                                   (20, "tanh", 1, 0, False))
# OriNet's: the same with padding 1 on the last convolution (a 3x3 map)
ORINET_SPEC = HARDNET_SPEC[:-2] + ((19, "conv", 1, 1, False),
                                   (20, "tanh", 1, 0, False))

# jitter-averaged HardNet frame perturbations, (rotation deg, scale);
# index 0 is the identity, cfg.hardnet_tta = K uses the first K
TTA_AUGS = ((0.0, 1.0), (6.0, 1.0), (-6.0, 1.0), (0.0, 1.08),
            (0.0, 0.93), (3.0, 1.05), (-3.0, 0.95))


# --------------------------------------------------------------------------- #
# weights
# --------------------------------------------------------------------------- #
def load_pth_state(path) -> Dict[str, np.ndarray]:
    """A .pth checkpoint's state dict (or the dict under "state_dict") as
    float32 numpy arrays."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {k: v.numpy().astype(np.float32) for k, v in sd.items()
            if hasattr(v, "numpy")}


def layers_from_state(sd: Dict[str, np.ndarray]) -> Dict:
    """`features.N.*` tensors grouped by the layer's index N (as a string);
    `whiten.*` keys (a trained whitening of the embedding) under
    "whiten"."""
    layers: Dict = {}
    for k, v in sd.items():
        if k.startswith("whiten."):
            layers.setdefault("whiten", {})[k.split(".", 1)[1]] = v
            continue
        if not k.startswith("features."):
            continue
        parts = k.split(".")
        layers.setdefault(parts[1], {})[parts[2]] = v
    return layers


def random_layers(which: str) -> Dict[int, Dict[str, np.ndarray]]:
    """Seeded random weights of net `which` (numpy default_rng(0)), the
    JAX package's `_random_params` array for array."""
    rng = np.random.default_rng(0)
    chans = {"hardnet": [(1, 32, 3), (32, 32, 3), (32, 64, 3), (64, 64, 3),
                         (64, 128, 3), (128, 128, 3), (128, 128, 8)],
             "affnet": [(1, 16, 3), (16, 16, 3), (16, 32, 3), (32, 32, 3),
                        (32, 64, 3), (64, 64, 3), (64, 3, 8)],
             "orinet": [(1, 16, 3), (16, 16, 3), (16, 32, 3), (32, 32, 3),
                        (32, 64, 3), (64, 64, 3), (64, 2, 8)]}[which]
    layers: Dict[int, Dict[str, np.ndarray]] = {}
    for (ci, co, k), idx in zip(chans, (0, 3, 6, 9, 12, 15, 19)):
        fan = ci * k * k
        layers[idx] = {"weight": rng.normal(0, 1.0 / math.sqrt(fan),
                                            (co, ci, k, k)).astype(np.float32)}
        last = idx == 19 and which in ("affnet", "orinet")
        if last:
            layers[idx]["bias"] = np.zeros(co, np.float32)
        else:
            layers[idx + 1] = {"running_mean": np.zeros(co, np.float32),
                               "running_var": np.ones(co, np.float32)}
    return layers


def weights_path(cfg: Config, which: str) -> str:
    return getattr(cfg, which).weights or str(DEFAULT_WEIGHTS[which])


def load_layers(path: str, which: str) -> Tuple[Dict, str]:
    """(layers, source) of net `which` from `path` (.npz or .pth); where
    the file is absent, seeded random weights if RANDOM_OPT_IN is set
    (source "random (opt-in)"), else FileNotFoundError."""
    if path.endswith(".npz") and os.path.exists(path):
        return layers_from_state(dict(np.load(path))), path
    if path.endswith(".pth") and os.path.exists(path):
        return layers_from_state(load_pth_state(path)), path
    if os.environ.get(RANDOM_OPT_IN):
        return random_layers(which), "random (opt-in)"
    raise FileNotFoundError(
        f"{which} weights not found at {path}. Train HardNet with "
        f"`python tools/train_hardnet.py` (writes weights/HardNetPS.npz) "
        f"or point cfg.{which}.weights at a checkpoint. Set "
        f"MODS_TPU_ALLOW_RANDOM_CNN=1 only for plumbing smoke tests — "
        f"random weights produce noise descriptors.")


# --------------------------------------------------------------------------- #
# the nets
# --------------------------------------------------------------------------- #
def _input_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-patch standardization with the UNBIASED std + 1e-7
    (desc_server.py input_norm)."""
    flat = x.reshape(x.shape[0], -1)
    n = flat.shape[1]
    mean = flat.mean(dim=1)
    var = ((flat - mean[:, None]) ** 2).sum(dim=1) / (n - 1)
    std = torch.sqrt(var) + 1e-7
    return (x - mean[:, None, None, None]) / std[:, None, None, None]


class _Net(nn.Module):
    """A Conv/BN/ReLU stack run in Sequential index order (`spec`); the
    weights are buffers named `l{index}_{name}`.  `layers` maps a layer
    index (int or str) to its arrays."""

    spec: Tuple = ()

    def __init__(self, layers: Dict):
        super().__init__()
        for idx, kind, *_ in self.spec:
            p = layers.get(idx) or layers.get(str(idx), {})
            names = {"conv": ("weight", "bias"),
                     "bn": ("running_mean", "running_var")}.get(kind, ())
            for name in names:
                if name in p:
                    self.register_buffer(f"l{idx}_{name}", torch.as_tensor(
                        np.asarray(p[name], np.float32)))
        self.source = ""
        self.eval()

    def _p(self, idx: int, name: str):
        return getattr(self, f"l{idx}_{name}", None)

    def trunk(self, patches: torch.Tensor) -> torch.Tensor:
        """[N,P,P] patches (0..255) -> the stack's output map [N,C,h,w]."""
        x = _input_norm(patches[:, None, :, :])
        for idx, kind, stride, pad, relu in self.spec:
            if kind == "conv":
                x = F.conv2d(x, self._p(idx, "weight"), self._p(idx, "bias"),
                             stride, pad)
            elif kind == "bn":
                m = self._p(idx, "running_mean")[None, :, None, None]
                v = self._p(idx, "running_var")[None, :, None, None]
                x = (x - m) * torch.rsqrt(v + 1e-5)
            elif kind == "tanh":
                x = torch.tanh(x)
            if relu:
                x = torch.relu(x)
        return x


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True) + 1e-10)


class HardNet(_Net):
    """[N,32,32] patches (0..255) -> [N,128] descriptors quantized to
    0..255; an optional trained whitening {mean, W} of the embedding
    ("whiten" in `layers`) applies between two L2 norms."""

    spec = HARDNET_SPEC
    out_dim = 128

    def __init__(self, layers: Dict):
        super().__init__(layers)
        wp = layers.get("whiten")
        self.whitened = wp is not None
        if self.whitened:
            self.register_buffer("whiten_mean", torch.as_tensor(
                np.asarray(wp["mean"], np.float32)))
            self.register_buffer("whiten_W", torch.as_tensor(
                np.asarray(wp["W"], np.float32)))

    @full_float32()
    def embed_raw(self, patches: torch.Tensor) -> torch.Tensor:
        """The L2-normalized (and whitened) embedding, not quantized."""
        x = _l2(self.trunk(patches).reshape(patches.shape[0], -1))
        if self.whitened:
            x = _l2((x - self.whiten_mean[None, :]) @ self.whiten_W.T)
        return x

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return quantize(self.embed_raw(patches))


class AffNet(_Net):
    """[N,32,32] -> [N,3] (a11, a21, a22), with 1 added to a11 and a22."""

    spec = AFFNET_SPEC
    out_dim = 3

    @full_float32()
    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = self.trunk(patches).mean(dim=(2, 3))
        return x + torch.tensor([1.0, 0.0, 1.0], device=x.device)


class OriNet(_Net):
    """[N,32,32] -> [N,2] orientation vector (y, x)."""

    spec = ORINET_SPEC
    out_dim = 2

    @full_float32()
    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return self.trunk(patches).mean(dim=(2, 3))


NETS = {"hardnet": HardNet, "affnet": AffNet, "orinet": OriNet}


def quantize(d: torch.Tensor) -> torch.Tensor:
    """The daemon's wire format: clip(210*(d+0.45), 0, 255)."""
    return torch.clamp(210.0 * (d + 0.45), 0.0, 255.0)


def params_from_jax(layers: Dict, which: str, device="cpu") -> _Net:
    """Net `which` ("hardnet", "affnet" or "orinet") on `device` from the
    JAX package's layer dict (index, int or str -> {name: array})."""
    return NETS[which](layers).to(device)


_NET_CACHE: Dict[Tuple[str, str], _Net] = {}


def get_net(cfg: Config, which: str, device=None) -> _Net:
    """Net `which` with the weights that `cfg` names (`weights_path`), on
    `device` (CUDA unless the caller asks for another), loaded once per
    path and device; `net.source` is the file or "random (opt-in)"."""
    dev = resolve_device(device)
    path = weights_path(cfg, which)
    key = (path, str(dev))
    if key not in _NET_CACHE:
        layers, source = load_layers(path, which)
        net = params_from_jax(layers, which, dev)
        net.source = source
        _NET_CACHE[key] = net
    return _NET_CACHE[key]


def invalidate_param_cache(path: Optional[str] = None) -> None:
    """Drop the cached nets (of one weight path, or all), e.g. after
    retraining in-process."""
    for key in [k for k in _NET_CACHE if path is None or k[0] == path]:
        del _NET_CACHE[key]


def nets3(cfg: Config, device=None) -> Tuple[_Net, _Net, _Net]:
    """(AffNet, OriNet, HardNet) as `cfg` names their weights: the deep
    flagship's `params3`."""
    return tuple(get_net(cfg, w, device) for w in ("affnet", "orinet", "hardnet"))


def forward_rows(fn: Callable, patches: torch.Tensor, dim: int) -> torch.Tensor:
    """fn over [N,P,P] patches in chunks of at most CHUNK: [N, dim]."""
    out = patches.new_zeros((patches.shape[0], dim))
    for s in range(0, patches.shape[0], CHUNK):
        out[s:s + CHUNK] = fn(patches[s:s + CHUNK])
    return out


def forward_valid(fn: Callable, patches: torch.Tensor, valid: torch.Tensor,
                  dim: int) -> torch.Tensor:
    """fn over the valid rows of [N,P,P] patches, in chunks of at most
    CHUNK: [N, dim], zero on the other rows."""
    idx = torch.nonzero(valid).flatten()
    out = patches.new_zeros((patches.shape[0], dim))
    if idx.numel():
        out[idx] = forward_rows(fn, patches[idx], dim)
    return out


# --------------------------------------------------------------------------- #
# patches
# --------------------------------------------------------------------------- #
def _use_engine(cfg: Config, device) -> bool:
    """The patch route: the mip engine or the reference's two-stage
    sampler.  The JAX package's "auto" means the engine on a TPU; here the
    card takes the TPU's route: "auto" means the engine on a CUDA device
    and the reference route on the CPU.  "engine" and "reference" force
    one route."""
    src = cfg.patch_source
    if src == "engine":
        return True
    if src == "reference":
        return False
    if src != "auto":
        raise ValueError(f"patch_source {src!r}: want auto, engine or reference")
    return torch.device(device).type == "cuda"


def cnn_patches(pyr: torch.Tensor, xy, A, s, valid, mr_size: float,
                patch_size: int, blend: str = "topup") -> torch.Tensor:
    """CNN patches through the mip patch engine (the engine route): the
    reference geometry (ExtractPatchesColumn, synth-detection.cpp:38-102),
    patchImageSize = 2*ceil(s*mrSize)+1, k = patchImageSize/patchSize,
    rounded and clipped as the daemons' PNG wire format
    (imagerepresentation.cpp:36-45).  [N,P,P], every row sampled."""
    k = (2.0 * torch.ceil(s * mr_size) + 1.0) / patch_size
    p = pe.sample_patches(pyr, xy, A * k[:, None, None], patch_size, valid=valid,
                          blend=blend)
    return torch.clamp(torch.round(p), 0.0, 255.0)


def reference_patches(img: torch.Tensor, kp: Keypoints, mr_size: float,
                      patch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference route: ExtractPatchesColumn(slow, photoNorm=False)
    with the PNG rounding.  (patches of the valid rows, their indices)."""
    idx = torch.nonzero(kp.valid).flatten()
    p = patchops.extract_patches_host(img, kp.xy[idx], kp.A[idx], kp.s[idx],
                                      mr_size, patch_size, photo_norm=False)
    return torch.clamp(torch.round(p), 0.0, 255.0), idx


def engine_outputs(pyr: torch.Tensor, kp: Keypoints, par: CNNParams, net: _Net,
                   blend: str = "topup") -> torch.Tensor:
    """The net's outputs [N, out_dim] on the keypoints' engine-route
    patches; zero on invalid rows."""
    p = cnn_patches(pyr, kp.xy, kp.A, kp.s, kp.valid, par.mrSize, par.patchSize,
                    blend)
    return forward_valid(net, p, kp.valid, net.out_dim)


def _net_rows(img, kp: Keypoints, cfg: Config, par: CNNParams, net: _Net,
              pyr: Optional[torch.Tensor]) -> torch.Tensor:
    """The net's outputs [N, out_dim] on the keypoints' patches, on the
    route `_use_engine` picks; zero on invalid rows."""
    if _use_engine(cfg, img.device):
        pyr = pe.build_mip_pyramid(img) if pyr is None else pyr
        return engine_outputs(pyr, kp, par, net, cfg.mip_aa)
    p, idx = reference_patches(img, kp, par.mrSize, par.patchSize)
    out = torch.zeros((kp.n, net.out_dim), device=img.device)
    out[idx] = forward_rows(net, p, net.out_dim)
    return out


def hardnet_tta(pyr: torch.Tensor, kp: Keypoints, par: CNNParams, net: HardNet,
                tta: int, blend: str = "topup") -> torch.Tensor:
    """Jitter-averaged HardNet: the L2-normalized embeddings of `tta`
    slightly perturbed frame samplings (TTA_AUGS), summed, renormalized
    and quantized once; zero on invalid rows."""
    acc = None
    for deg, sc in TTA_AUGS[:max(tta, 1)]:
        th = math.radians(deg)
        c, sn = math.cos(th), math.sin(th)
        R = torch.tensor([[c, sn], [-sn, c]], dtype=torch.float32,
                         device=pyr.device) * sc
        p = cnn_patches(pyr, kp.xy, kp.A @ R, kp.s, kp.valid, par.mrSize,
                        par.patchSize, blend)
        e = forward_valid(net.embed_raw, p, kp.valid, net.out_dim)
        acc = e if acc is None else acc + e
    return torch.where(kp.valid[:, None], quantize(_l2(acc)), 0.0)


# --------------------------------------------------------------------------- #
# the pipeline's stages (in place of DescribeWithZmq)
# --------------------------------------------------------------------------- #
def hardnet_describe(img: torch.Tensor, kp: Keypoints, cfg: Config,
                     pyr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ZMQ descriptor (imagerepresentation.cpp:992-1006): [N,128]
    quantized descriptors, zero rows for invalid keypoints; jitter-averaged
    on the engine route when cfg.hardnet_tta > 1."""
    net = get_net(cfg, "hardnet", img.device)
    if cfg.hardnet_tta > 1 and _use_engine(cfg, img.device):
        pyr = pe.build_mip_pyramid(img) if pyr is None else pyr
        return hardnet_tta(pyr, kp, cfg.hardnet, net, cfg.hardnet_tta, cfg.mip_aa)
    return _net_rows(img, kp, cfg, cfg.hardnet, net, pyr)


def affnet_shape(kp: Keypoints, abc: torch.Tensor, w: int, h: int,
                 mr_size: float) -> Keypoints:
    """AffNet's output (a11, a21, a22) as the keypoints' shape, a12 = 0
    (identity on invalid rows, so that rectification stays finite), made
    upright; kept where the anisotropy is at most 6 and the region stays
    inside the image (imagerepresentation.cpp:798-855)."""
    zero = torch.zeros_like(abc[:, 0])
    A = torch.stack([torch.stack([abc[:, 0], zero], -1),
                     torch.stack([abc[:, 1], abc[:, 2]], -1)], -2)
    A = torch.where(kp.valid[:, None, None], A, torch.eye(2, device=A.device))
    Aj = rectify_up_is_up(A)
    ok, l1, l2 = eigenvalues_2x2(Aj[:, 0, 0], Aj[:, 0, 1], Aj[:, 1, 0], Aj[:, 1, 1])
    aniso = ok & (l1 / l2 <= 6.0) & (l2 / l1 <= 6.0)
    touch = imops.interpolate_check_borders(w, h, kp.xy[:, 0], kp.xy[:, 1], Aj,
                                            mr_size * kp.s, mr_size * kp.s)
    return Keypoints(kp.xy, Aj, kp.s, kp.response, kp.valid & aniso & ~touch)


def orinet_rotate(kp: Keypoints, yx: torch.Tensor) -> Keypoints:
    """OriNet's output (y, x) as the keypoints' orientation: angle =
    atan2(y, x) (0 on invalid rows), A <- A . R(angle)
    (imagerepresentation.cpp:877-900)."""
    angle = torch.where(kp.valid, torch.atan2(yx[:, 0], yx[:, 1]), 0.0)
    ci, si = torch.cos(angle), torch.sin(angle)
    A = kp.A
    a11 = A[:, 0, 0] * ci - A[:, 0, 1] * si
    a12 = A[:, 0, 0] * si + A[:, 0, 1] * ci
    a21 = A[:, 1, 0] * ci - A[:, 1, 1] * si
    a22 = A[:, 1, 0] * si + A[:, 1, 1] * ci
    An = torch.stack([torch.stack([a11, a12], -1), torch.stack([a21, a22], -1)], -2)
    return Keypoints(kp.xy, An, kp.s, kp.response, kp.valid)


def affnet_adapt(img: torch.Tensor, kp: Keypoints, cfg: Config,
                 pyr: Optional[torch.Tensor] = None) -> Keypoints:
    """The AffNet affine-shape stage in place of Baumberg."""
    abc = _net_rows(img, kp, cfg, cfg.affnet, get_net(cfg, "affnet", img.device),
                    pyr)
    h, w = img.shape
    return affnet_shape(kp, abc, w, h, cfg.affnet.mrSize)


def orinet_orient(img: torch.Tensor, kp: Keypoints, cfg: Config,
                  pyr: Optional[torch.Tensor] = None) -> Keypoints:
    """The OriNet orientation stage in place of the gradient histogram:
    one row per keypoint."""
    yx = _net_rows(img, kp, cfg, cfg.orinet, get_net(cfg, "orinet", img.device),
                   pyr)
    return orinet_rotate(kp, yx)
