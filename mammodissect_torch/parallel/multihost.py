"""Process-group start-up and cross-rank gathers (counterpart of
`mammodissect/parallel/multihost.py`).

- `initialize`: `torch.distributed.init_process_group` from the arguments or from
  the launcher's environment (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR,
  MASTER_PORT and LOCAL_RANK). NCCL for CUDA, gloo for the CPU; gloo on CUDA
  tensors only when the caller names it (two ranks sharing one card).
- `gather_predictions`: every rank's equal-length contiguous slice all-gathered in
  rank order and trimmed to `total`, the reference's all_gather-and-trim of eval
  predictions (`Classifiers/experiments.py:554-564`).

JAX's `global_batch_from_local` has no tensor counterpart: each rank keeps its
slice of the global batch as its own tensor. Where a computation needs the global
batch, the port gathers it (`collectives.all_gather_with_grad` for the contrastive
logits) or reduces over it (the synced training BatchNorm, `models/layers.py`)."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from mammodissect_torch.parallel.collectives import all_gather
from mammodissect_torch.parallel.mesh import local_rank


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device: Optional[str] = "cuda") -> bool:
    """Start this process's process group; returns whether one is up.

    num_processes=1 is an explicit no-op, as JAX's. Without arguments the launcher's
    environment gives the topology (WORLD_SIZE, RANK; a group starts at any world
    size, 1 included), and without it this is a single process (no group). `backend`
    None is NCCL for `device` cuda and gloo for the CPU. For NCCL the process's
    card is cuda:LOCAL_RANK. `coordinator_address` is host:port or a tcp:// URL."""
    if dist.is_initialized():
        return True
    if num_processes == 1:
        return False
    if num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    dev = torch.device(device or "cuda")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    if coordinator_address is None:
        init_method = "env://"
    elif coordinator_address.startswith("tcp://"):
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    return True


def comm_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors: this rank's card under
    NCCL, else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_array(local: np.ndarray, group=None) -> np.ndarray:
    """Tiled all-gather of equal-shape numpy arrays in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(local)).to(comm_device(group))
    return all_gather(t, group).cpu().numpy()


def gather_predictions(local: np.ndarray, total: int, group=None) -> np.ndarray:
    """Every rank's slice of predictions (equal lengths, contiguous in rank order)
    all-gathered and trimmed to `total` rows; a single process trims its own."""
    if not dist.is_initialized():
        return np.asarray(local)[:total]
    return gather_array(np.asarray(local), group)[:total]
