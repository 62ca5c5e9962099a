"""Multi-process bring-up and work partitioning on torch.distributed.

Counterpart of the JAX package's parallel/distributed.py.  The reference
has no multi-node story (its batch extractor is a serial loop with
file-existence resume).  Here:
  - `init_distributed` starts the process group when more than one
    process runs (NCCL on the card, gloo when the caller asks for the
    CPU), from the same environment variables as the JAX package;
  - `shard_list` partitions a work list across processes; with the
    extractor's skip-if-exists resume this gives elastic restarts (a
    replacement process re-runs only the missing outputs).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from .. import resolve_device


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> Tuple[int, int]:
    """Join the process group when running multi-process; no group for a
    single process.  `coordinator` is "host:port" (MODS_TPU_COORDINATOR),
    the counts come from MODS_TPU_NUM_PROCESSES / MODS_TPU_PROCESS_ID.
    The backend is NCCL on CUDA (the default device) and gloo on the CPU.
    Returns (process_id, num_processes)."""
    dev = resolve_device(device)
    coordinator = coordinator or os.environ.get("MODS_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("MODS_TPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("MODS_TPU_PROCESS_ID", "0"))
    if num_processes > 1:
        if not coordinator:
            raise ValueError("a multi-process run needs the coordinator's "
                             "host:port (MODS_TPU_COORDINATOR)")
        import torch
        import torch.distributed as dist
        if dev.type == "cuda":
            # one card a process: the asked-for card, else the process's
            # share of this host's cards (NCCL refuses two ranks on one)
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else process_id % torch.cuda.device_count())
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    return process_id, num_processes


def shard_list(items: Sequence, process_id: int, num_processes: int) -> List:
    """Strided partition (deterministic, balanced for sorted-by-size
    lists)."""
    return list(items[process_id::num_processes])
