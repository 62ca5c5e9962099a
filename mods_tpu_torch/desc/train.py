"""Descriptor training: HardNet under the hardest-in-batch triplet loss.

Counterpart of the JAX package's desc/train.py.  The reference consumes
pre-trained .pth checkpoints; this module trains the descriptor with the
public HardNet recipe (Mishchuk et al. 2017): the hardest-in-batch triplet
margin loss, Adam under a cosine-decayed learning rate, BatchNorm on batch
statistics with its running statistics carried along as torch's
BatchNorm2d carries them (momentum 0.1, affine=False, desc_server.py:57-92).

The trainable net (`TrainableHardNet`) holds the convolution weights as
parameters `w{idx}` and the running statistics as buffers
`bn{idx}_mean` / `bn{idx}_var`: the JAX package's params dict, key for
key, so that `from_jax_params` / `params` carry it across both ways.  The
convolutions are `torch.nn.functional.conv2d` (cuDNN on the card) in full
float32, forward and backward.

Gradients follow the JAX package's rules where torch's differ: the ReLUs
and the loss's max / min split the gradient evenly between equal entries
(`torch.maximum`, `torch.minimum`, `torch.amin`), as `jnp.maximum` and
`jnp.min` do; `torch.relu` and `torch.min(dim=)` would give it to one side.

`make_sharded_train_step` is the data-parallel step over the "data" axis
of a parallel.mesh DeviceMesh: each rank embeds its block of the batch,
the embeddings are all-gathered with autograd, and the loss is the global
batch's (hardest negatives mined across every block), as the JAX
package's jit with shardings computes it.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .. import full_float32, resolve_device
from .cnn import HARDNET_SPEC, _input_norm

# (in channels, out channels, kernel) of each convolution, and its index
_CHANS = ((1, 32, 3), (32, 32, 3), (32, 64, 3), (64, 64, 3),
          (64, 128, 3), (128, 128, 3), (128, 128, 8))
_CONV_IDXS = (0, 3, 6, 9, 12, 15, 19)
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class TrainableHardNet(nn.Module):
    """HardNet's stack (cnn.HARDNET_SPEC) with trainable convolution
    weights (parameters `w{idx}`) and BatchNorm running statistics
    (buffers `bn{idx}_mean`, `bn{idx}_var`, never descended)."""

    def __init__(self, params: Dict[str, np.ndarray], device=None):
        super().__init__()
        dev = resolve_device(device)
        for k, v in params.items():
            t = torch.tensor(np.asarray(v), dtype=torch.float32, device=dev)
            if k.startswith("w"):
                self.register_parameter(k, nn.Parameter(t))
            else:
                self.register_buffer(k, t)

    def params(self) -> Dict[str, np.ndarray]:
        """The JAX package's params dict: float32 numpy arrays."""
        out = {k: v.detach().cpu().numpy() for k, v in self.named_parameters()}
        out.update({k: v.cpu().numpy() for k, v in self.named_buffers()})
        return out

    def to_layers(self) -> Dict[int, Dict[str, np.ndarray]]:
        """The layer dict that cnn.params_from_jax(..., "hardnet") takes."""
        layers: Dict[int, Dict[str, np.ndarray]] = {}
        for k, v in self.params().items():
            if k.startswith("w"):
                layers.setdefault(int(k[1:]), {})["weight"] = v
            else:
                idx, kind = k[2:].split("_")
                name = "running_mean" if kind == "mean" else "running_var"
                layers.setdefault(int(idx), {})[name] = v
        return layers


def init_hardnet_params(generator: Optional[torch.Generator] = None,
                        device=None) -> TrainableHardNet:
    """A fresh TrainableHardNet: weights normal / sqrt(fan in) drawn from
    `generator` on the CPU (the same net on every device), running means 0
    and variances 1."""
    params = {}
    for (ci, co, k), idx in zip(_CHANS, _CONV_IDXS):
        w = torch.randn((co, ci, k, k), generator=generator) / math.sqrt(ci * k * k)
        params[f"w{idx}"] = w.numpy()
        params[f"bn{idx + 1}_mean"] = np.zeros(co, np.float32)
        params[f"bn{idx + 1}_var"] = np.ones(co, np.float32)
    return TrainableHardNet(params, device)


def from_jax_params(params: Dict, device=None) -> TrainableHardNet:
    """The JAX package's params dict (`w{idx}`, `bn{idx}_mean`,
    `bn{idx}_var`; numpy or JAX arrays) as a TrainableHardNet."""
    return TrainableHardNet({k: np.asarray(v) for k, v in params.items()}, device)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with jnp.maximum's gradient: half of it at x == 0."""
    return torch.maximum(x, x.new_zeros(()))


def _l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, 1, keepdim=True) + 1e-10)


@full_float32()
def hardnet_embed(net: TrainableHardNet, patches: torch.Tensor) -> torch.Tensor:
    """[N,32,32] -> L2-normalized [N,128] with BatchNorm on the running
    statistics (no quantization, no whitening: training)."""
    x = _input_norm(patches[:, None, :, :])
    for idx, kind, stride, pad, relu in HARDNET_SPEC:
        if kind == "conv":
            x = F.conv2d(x, getattr(net, f"w{idx}"), None, stride, pad)
        else:
            m = getattr(net, f"bn{idx}_mean")[None, :, None, None]
            v = getattr(net, f"bn{idx}_var")[None, :, None, None]
            x = (x - m) * torch.rsqrt(v + BN_EPS)
        if relu:
            x = _relu(x)
    return _l2(x.reshape(x.shape[0], -1))


@full_float32()
def hardnet_embed_train(net: TrainableHardNet, patches: torch.Tensor,
                        momentum: float = BN_MOMENTUM
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training-mode forward: BatchNorm normalizes with the batch's mean
    and biased variance; returns the embedding and the new running
    statistics (momentum-blended, the variance unbiased), as torch's
    BatchNorm2d in training mode.  The net's own buffers stay as they
    are."""
    x = _input_norm(patches[:, None, :, :])
    new_stats: Dict[str, torch.Tensor] = {}
    for idx, kind, stride, pad, relu in HARDNET_SPEC:
        if kind == "conv":
            x = F.conv2d(x, getattr(net, f"w{idx}"), None, stride, pad)
        else:
            rm = getattr(net, f"bn{idx}_mean").clone()
            rv = getattr(net, f"bn{idx}_var").clone()
            x = F.batch_norm(x, rm, rv, training=True, momentum=momentum,
                             eps=BN_EPS)
            new_stats[f"bn{idx}_mean"], new_stats[f"bn{idx}_var"] = rm, rv
        if relu:
            x = _relu(x)
    return _l2(x.reshape(x.shape[0], -1)), new_stats


@full_float32()
def triplet_margin_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        margin: float = 1.0,
                        ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """HardNet's hardest-in-batch loss: per anchor, the hardest negative is
    the closest non-matching descriptor of the batch, row- and
    column-wise.  ids: optional [n] source-keypoint ids; rows of one id
    are true matches and never mined as negatives (batches are drawn with
    replacement, so one point can appear twice)."""
    d = torch.sqrt(torch.maximum(
        torch.sum(anchor ** 2, 1)[:, None] + torch.sum(positive ** 2, 1)[None, :]
        - 2.0 * anchor @ positive.T, anchor.new_tensor(1e-8)))
    pos = torch.diagonal(d)
    if ids is not None:
        same = ids[:, None] == ids[None, :]
    else:
        same = torch.eye(d.shape[0], dtype=torch.bool, device=d.device)
    off = d + same * 1e6
    hardest_neg = torch.minimum(torch.amin(off, 0), torch.amin(off, 1))
    return torch.mean(_relu(margin + pos - hardest_neg))


def cosine_adam(net: TrainableHardNet, lr: float, steps: int
                ) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """optax.adam(optax.cosine_decay_schedule(lr, steps)): Adam (0.9,
    0.999, eps 1e-8) over the net's weights, its rate at step t (0 at the
    first step) lr * (1 + cos(pi * min(t, steps) / steps)) / 2."""
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, steps) / steps)))
    return opt, sched


def train_loss(net: TrainableHardNet, anchors, positives, ids=None,
               train_bn: bool = False) -> Tuple[torch.Tensor, Dict]:
    """(loss, new running statistics) of a batch: with train_bn, one
    forward of anchors and positives together on their batch statistics
    (the new statistics span both); else BatchNorm on the running
    statistics (no new statistics)."""
    if train_bn:
        emb, new_stats = hardnet_embed_train(net, torch.cat([anchors, positives], 0))
        ea, ep = emb.chunk(2, 0)
    else:
        ea, ep = hardnet_embed(net, anchors), hardnet_embed(net, positives)
        new_stats = {}
    return triplet_margin_loss(ea, ep, ids=ids), new_stats


def _backward(optimizer, loss: torch.Tensor) -> None:
    optimizer.zero_grad(set_to_none=True)
    with full_float32():
        loss.backward()


def _step(net, optimizer, scheduler, new_stats) -> None:
    """The optimizer's update, the scheduler's step, then the new running
    statistics (if any) in place of the net's."""
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    with torch.no_grad():
        for k, v in new_stats.items():
            getattr(net, k).copy_(v)


def make_train_step(optimizer: torch.optim.Optimizer, train_bn: bool = False,
                    scheduler=None) -> Callable:
    """step(net, anchors, positives, ids=None) -> loss: one update of the
    net's weights by `optimizer` (built over net.parameters(); the
    scheduler, if any, steps after it).  train_bn=True runs BatchNorm on
    the statistics of anchors and positives together (one forward of
    both) and replaces the running statistics by the new ones after the
    update; else BatchNorm uses the running statistics.  The statistics
    are never descended.  The three phases are torch.profiler spans
    (train_forward, train_backward, train_update)."""

    def train_step(net: TrainableHardNet, anchors, positives, ids=None):
        with record_function("train_forward"):
            loss, new_stats = train_loss(net, anchors, positives, ids, train_bn)
        with record_function("train_backward"):
            _backward(optimizer, loss)
        with record_function("train_update"):
            _step(net, optimizer, scheduler, new_stats)
        return loss.detach()

    return train_step


def save_hardnet_npz(net: TrainableHardNet, path: str, whiten=None) -> None:
    """The net in the `features.N.*` state-dict layout that
    cnn.layers_from_state / load_layers read.  `whiten`: optional (mean
    [128], W [128,128]) whitening of the embedding."""
    out = {}
    for idx, p in net.to_layers().items():
        for name, v in p.items():
            out[f"features.{idx}.{name}"] = v
    if whiten is not None:
        out["whiten.mean"] = np.asarray(whiten[0], np.float32)
        out["whiten.W"] = np.asarray(whiten[1], np.float32)
    np.savez(path, **out)


def load_hardnet_npz(path: str, device=None) -> TrainableHardNet:
    """Inverse of save_hardnet_npz (whitening keys ignored: the training
    net only)."""
    params = {}
    for k, v in np.load(path).items():
        if k.startswith("whiten."):
            continue
        idx = int(k.split(".")[1])
        if k.endswith(".weight"):
            params[f"w{idx}"] = v
        elif k.endswith(".running_mean"):
            params[f"bn{idx}_mean"] = v
        elif k.endswith(".running_var"):
            params[f"bn{idx}_var"] = v
    return TrainableHardNet(params, device)


@torch.no_grad()
def compute_whitening(net: TrainableHardNet, patches: np.ndarray,
                      alpha: float = 0.5, eps: float = 1e-6, batch: int = 4096):
    """PCA whitening of the L2-normalized embedding on training patches
    (embedded `batch` at a time on the net's device): (mean,
    W = U diag((lambda + eps)^-alpha) U^T), in float64 on the host.  alpha
    0.5 whitens fully; smaller values shrink gently."""
    dev = next(net.parameters()).device
    X = torch.cat([hardnet_embed(net, torch.from_numpy(
        np.asarray(patches[i:i + batch], np.float32)).to(dev)).cpu()
        for i in range(0, len(patches), batch)]).numpy()
    mu = X.mean(0)
    C = np.cov((X - mu).T)
    lam, U = np.linalg.eigh(C)
    W = (U * np.power(np.maximum(lam, 0) + eps, -alpha)) @ U.T
    return mu.astype(np.float32), W.astype(np.float32)


def make_sharded_train_step(mesh, optimizer: torch.optim.Optimizer,
                            scheduler=None) -> Callable:
    """step(net, anchors, positives, ids=None) -> loss, data-parallel over
    the "data" axis of `mesh` (parallel.mesh.make_mesh): every rank passes
    the whole batch (B a multiple of the "data" size, else ValueError),
    embeds its contiguous block with BatchNorm on the running statistics
    (make_train_step's default), and all-gathers the embeddings with
    autograd; the loss is the global batch's on every rank.  The gather's
    backward sums the n_data ranks' identical gradients into each block,
    so the weight gradients are averaged over "data": each rank then holds
    the one-process gradient of the global batch, and its replica takes
    the same step."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_gather

    group = mesh.get_group("data")
    n_data = mesh.shape[mesh.mesh_dim_names.index("data")]
    r = mesh.get_local_rank("data")

    def train_step(net: TrainableHardNet, anchors, positives, ids=None):
        B = anchors.shape[0]
        if B % n_data:
            raise ValueError(f"a batch of {B} does not split into {n_data} blocks")
        b = B // n_data
        rows = slice(r * b, (r + 1) * b)
        ea = torch.cat(all_gather(hardnet_embed(net, anchors[rows]), group=group))
        ep = torch.cat(all_gather(hardnet_embed(net, positives[rows]), group=group))
        loss = triplet_margin_loss(ea, ep, ids=ids)
        _backward(optimizer, loss)
        for p in net.parameters():
            dist.all_reduce(p.grad, group=group)
            p.grad /= n_data
        _step(net, optimizer, scheduler, {})
        return loss.detach()

    return train_step


def split_by_keypoint(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(validation rows, training rows) of a pair set, split by source
    keypoint: max(64, n_ids // 12) ids drawn with default_rng(123) are held
    out, and at most 4096 of their rows validate."""
    uids = np.unique(ids)
    np.random.default_rng(123).shuffle(uids)
    is_val = np.isin(ids, uids[:max(64, len(uids) // 12)])
    return np.where(is_val)[0][:4096], np.where(~is_val)[0]


@torch.no_grad()
@full_float32()
def fpr95(net: TrainableHardNet, a: torch.Tensor, p: torch.Tensor,
          ids: torch.Tensor) -> Tuple[float, float]:
    """Validation: (matching accuracy, FPR at 95 % TPR).  Accuracy counts
    anchors whose nearest positive comes from their own source keypoint
    (duplicates of the true point count); the FPR is the share of
    non-matching pairs at most as far apart as the 95th percentile of the
    matching distances (linear interpolation, as jnp.percentile)."""
    ea, ep = hardnet_embed(net, a), hardnet_embed(net, p)
    d = torch.sqrt(torch.clamp(
        torch.sum(ea ** 2, 1)[:, None] + torch.sum(ep ** 2, 1)[None, :]
        - 2.0 * ea @ ep.T, min=1e-8))
    acc = torch.mean((ids[torch.argmin(d, 1)] == ids).float())
    th = torch.quantile(torch.diagonal(d), 0.95)
    neg = ids[:, None] != ids[None, :]
    neg_below = torch.sum((d <= th) & neg) / torch.clamp(torch.sum(neg), min=1)
    return float(acc), float(neg_below)
