"""Multi-process scale-out on torch.distributed: the device mesh, the
sharded kNN and the data-parallel batch match.

Counterpart of the JAX package's parallel/mesh.py.  The scaling axes are
the two dimensions of a DeviceMesh, one rank per device:
  - "data"  : image pairs (batch matching), split in contiguous blocks;
  - "model" : descriptor-database blocks (the N x M distance matrix of
              one-to-many matching is sharded column-wise; each rank
              computes a local top-k, which is all-gathered over the
              "model" group and merged with one top-k).
The caller starts the process group (`distributed.init_distributed`, or
torch.distributed.init_process_group directly); every rank passes the
same full inputs, as the JAX package's global arrays, and gets the whole
result back.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import resolve_device
from ..config import Config
from ..match.matching import _knn, topk_keyed
from ..models.flagship import match_pair


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device=None) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the process group, on
    the card unless the caller asks for the CPU (the group's backend must
    serve that device: NCCL for CUDA, gloo for the CPU).  n_data defaults
    to world_size // n_model; n_data * n_model must be the world size."""
    dev = resolve_device(device)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} "
                         f"ranks; the process group has {world}")
    return DeviceMesh(dev.type, torch.arange(world).reshape(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _size(mesh: DeviceMesh, dim_name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(dim_name)]


def _gather(t: torch.Tensor, mesh: DeviceMesh, dim_name: str) -> torch.Tensor:
    """t of every rank of this rank's `dim_name` group, concatenated along
    dim 0 in the group's rank order."""
    parts = [torch.empty_like(t) for _ in range(_size(mesh, dim_name))]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(dim_name))
    return torch.cat(parts)


# --------------------------------------------------------------------------- #
# Sharded exact kNN (one-to-many matching backbone)
# --------------------------------------------------------------------------- #
def sharded_knn(mesh: DeviceMesh, queries, db,
                k: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN with the database row-sharded over "model" in contiguous
    blocks of M / n_model rows (M not a multiple of n_model raises).

    Each rank takes its block's squared L2 distances and local top-k
    (`match.matching._knn`: ascending distance, ties lower index first;
    global index = local + block start), all-gathers the k candidates of
    every block, and merges them with one top-k over the int64 key
    (distance bits, global index; `match.matching.topk_keyed`): the dense
    `_knn`'s order.  One path at every mesh size: at n_model 1 the gather
    and the merge run over the one block.  Returns (dists [N, k], global
    indices [N, k]) on every rank."""
    dev = _mesh_device(mesh)
    n_model = _size(mesh, "model")
    M = db.shape[0]
    if M % n_model:
        raise ValueError(f"{M} database rows do not split into {n_model} blocks")
    block = M // n_model
    r = mesh.get_local_rank("model")
    q = torch.as_tensor(queries, dtype=torch.float32).to(dev)
    dbl = torch.as_tensor(db[r * block:(r + 1) * block], dtype=torch.float32).to(dev)
    d, idx = _knn(q, dbl, torch.ones(block, dtype=torch.bool, device=dev),
                  min(k, block), False)
    # candidates of every block side by side: [N, n_model * k]
    alld = _gather(d.T, mesh, "model").T
    alli = _gather((idx + r * block).T, mesh, "model").T
    dk, gidx = topk_keyed(alld.contiguous().view(torch.int32).to(torch.int64), alli,
                          k, max(1, (M - 1).bit_length()))
    return dk.to(torch.int32).view(torch.float32), gidx


# --------------------------------------------------------------------------- #
# Data-parallel batch pair matching
# --------------------------------------------------------------------------- #
def batch_match_sharded(mesh: DeviceMesh, cfg: Config, imgs1, imgs2,
                        draws: Optional[Sequence[Dict[str, torch.Tensor]]] = None,
                        max_kp: int = 512, seed: int = 0, device=None):
    """Match a batch of image pairs, split over "data" in contiguous blocks
    of B / n_data pairs (B not a multiple of n_data raises); the ranks of
    one "data" row match the same pairs.

    imgs*: [B, H, W] float32 (numpy or tensors).  Pair i takes draws[i]
    (`models.flagship.ransac_draw_shapes`) or, without draws, a generator
    on the device seeded with seed + i, so its result does not depend on
    the rank that took it.  device: the mesh's unless given.
    Returns (H [B,3,3], inliers [B], tentatives [B]) on every rank."""
    dev = resolve_device(_mesh_device(mesh) if device is None else device)
    n_data = _size(mesh, "data")
    B = len(imgs1)
    if B % n_data:
        raise ValueError(f"{B} pairs do not split into {n_data} blocks")
    b = B // n_data
    lo = mesh.get_local_rank("data") * b
    Hs, inl, tent = [], [], []
    for i in range(lo, lo + b):
        gen = None if draws is not None else \
            torch.Generator(device=dev).manual_seed(seed + i)
        H, n_inl, n_tent, _, _ = match_pair(
            imgs1[i], imgs2[i], cfg, max_kp,
            draws=None if draws is None else draws[i], generator=gen, device=dev)
        Hs.append(H.to(torch.float32))
        inl.append(n_inl.to(torch.int64))
        tent.append(n_tent.to(torch.int64))
    return (_gather(torch.stack(Hs), mesh, "data"),
            _gather(torch.stack(inl), mesh, "data"),
            _gather(torch.stack(tent), mesh, "data"))
