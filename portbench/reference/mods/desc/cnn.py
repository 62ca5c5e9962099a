# Frozen copy of mods_tpu_torch/desc/cnn.py, kept as the benchmark's plain reference
# (see portbench/reference/__init__.py); later edits to the port do not reach it.
"""The CNN descriptor stage: HardNet.

Counterpart of the JAX package's desc/cnn.py, which replaces the
reference's ZeroMQ PyTorch daemon (desc_server.py and the DescribeWithZmq
client, imagerepresentation.cpp:21-103) with an in-process net.  The
architecture is the daemon's (desc_server.py:55-92); the post-processing
too: HardNet's output is quantized as clip(210*(d+0.45), 0, 255)
(desc_server.py:42).  The port's AffNet and OriNet, which no cell runs,
are left out, and the weights come from their file alone: a missing file
raises.

The net is an `nn.Module` in eval mode (`HardNet`); its convolutions are `torch.nn.functional.conv2d` (cuDNN on the card)
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

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import full_float32, resolve_device
from ..config import CNNParams, Config
from ..ops import patch_engine as pe
from ..ops import patches as patchops
from ..types import Keypoints

# the most patches a net takes in one call
CHUNK = 8192

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
# --------------------------------------------------------------------------- #
# weights
# --------------------------------------------------------------------------- #
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


def load_layers(path: str) -> Dict:
    """HardNet's layers from the .npz file `path`; FileNotFoundError where
    there is none."""
    if not (path.endswith(".npz") and os.path.exists(path)):
        raise FileNotFoundError(f"HardNet weights not found at {path!r}: the "
                                f"configuration's `weights` names the .npz file")
    return layers_from_state(dict(np.load(path)))


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


def quantize(d: torch.Tensor) -> torch.Tensor:
    """The daemon's wire format: clip(210*(d+0.45), 0, 255)."""
    return torch.clamp(210.0 * (d + 0.45), 0.0, 255.0)


_NET_CACHE: Dict[Tuple[str, str], HardNet] = {}


def get_net(cfg: Config, device=None) -> HardNet:
    """HardNet with the weights file that `cfg.hardnet.weights` names, on
    `device` (CUDA unless the caller asks for another), loaded once per
    path and device."""
    dev = resolve_device(device)
    path = cfg.hardnet.weights
    key = (path, str(dev))
    if key not in _NET_CACHE:
        net = HardNet(load_layers(path)).to(dev)
        net.source = path
        _NET_CACHE[key] = net
    return _NET_CACHE[key]


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


# --------------------------------------------------------------------------- #
# the pipeline's stages (in place of DescribeWithZmq)
# --------------------------------------------------------------------------- #
def hardnet_describe(img: torch.Tensor, kp: Keypoints, cfg: Config,
                     pyr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ZMQ descriptor (imagerepresentation.cpp:992-1006): [N,128]
    quantized descriptors, zero rows for invalid keypoints."""
    return _net_rows(img, kp, cfg, cfg.hardnet, get_net(cfg, img.device), pyr)
