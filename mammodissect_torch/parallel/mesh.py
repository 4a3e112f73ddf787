"""Process topology and device meshes (counterpart of `mammodissect/parallel/mesh.py`).

The JAX package runs one process per host with a mesh over every device; the port
runs one process per GPU (`torchrun`, or spawned ranks in the tests), and rank,
world size and local rank come from `torch.distributed`. So JAX's single-process
multi-device path and its multi-host path are one path here: the one every rank
takes once a process group is initialized (`parallel.multihost.initialize`), at
any world size, 1 included. Axes:

  'data'   the batch (data parallelism, the reference's only one)
  'model'  tensor parallelism of the text tower and the projection heads

`make_mesh` returns a `torch.distributed.device_mesh.DeviceMesh` over every rank
with dims ("data", "model"); `data_group` returns the process group of the data
axis, or None without a process group. `data_parallel(group)` marks the forwards
inside it as one data-parallel step: training BatchNorm takes its moments over the
group's global batch and the random masks are drawn on the global batch's shape
(`models/layers.py`), as JAX's global-view step does."""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Iterator, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape_for(n_devices: int, model_parallel: int = 1) -> Tuple[int, int]:
    if n_devices % model_parallel != 0:
        raise ValueError(f"{n_devices} devices not divisible by model_parallel={model_parallel}")
    return (n_devices // model_parallel, model_parallel)


def require_process_group(what: str) -> None:
    """Raise unless a process group is initialized: several GPUs mean one process
    each, started by a launcher."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs one process per GPU and a process group: launch with "
            "torchrun (e.g. `torchrun --nproc_per_node 2 -m mammodissect_torch.cli.finetune "
            "...`), which sets the ranks that `parallel.multihost.initialize` reads")


def make_mesh(model_parallel: int = 1):
    """A ("data", "model") DeviceMesh over every rank of the process group, rank r at
    data index r // model_parallel and model index r % model_parallel."""
    from torch.distributed.device_mesh import init_device_mesh

    require_process_group(f"a mesh (model_parallel={model_parallel})")
    dp, mp = mesh_shape_for(dist.get_world_size(), model_parallel)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, mp), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_group(mesh=None):
    """The data axis's process group: the mesh's, else every rank's when a process
    group is initialized, else None (a single process)."""
    if mesh is not None:
        return mesh.get_group(DATA_AXIS)
    return dist.group.WORLD if dist.is_initialized() else None


def model_group(mesh):
    return mesh.get_group(MODEL_AXIS)


def data_parallel_size(mesh=None) -> int:
    group = data_group(mesh)
    return dist.get_world_size(group) if group is not None else 1


def group_rank_and_size(group) -> Tuple[int, int]:
    """(this rank's index in `group`, the group's size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


_ACTIVE = {"data_group": None}


@contextlib.contextmanager
def data_parallel(group) -> Iterator[None]:
    """The forwards inside are one data-parallel step over `group` (None: a single
    process, nothing changes). The autograd functions that take part keep the group
    for their backward."""
    saved = _ACTIVE["data_group"]
    _ACTIVE["data_group"] = group
    try:
        yield
    finally:
        _ACTIVE["data_group"] = saved


def active_data_group():
    return _ACTIVE["data_group"]


@dataclasses.dataclass(frozen=True)
class GlobalEnv:
    """The reference's `(world_size, world_rank, local_rank, num_gpus, master)`
    (`util/global_env.py:15-34`) from torch.distributed; one process without a
    process group."""

    world_size: int
    world_rank: int
    local_rank: int
    num_devices: int
    master: bool

    @classmethod
    def get(cls) -> "GlobalEnv":
        up = dist.is_initialized()
        rank = dist.get_rank() if up else 0
        return cls(world_size=dist.get_world_size() if up else 1, world_rank=rank,
                   local_rank=local_rank(), num_devices=torch.cuda.device_count(),
                   master=rank == 0)


def local_rank() -> int:
    """Rank within the node, from the launcher's LOCAL_RANK (torchrun) or
    SLURM_LOCALID (srun), as the reference reads it (`util/global_env.py:31`); 0
    without either."""
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        if var in os.environ:
            return int(os.environ[var])
    return 0


def is_master() -> bool:
    """Whether this process writes shared outputs: rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0
