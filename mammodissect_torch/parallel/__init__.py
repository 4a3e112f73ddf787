"""Multi-GPU runtime (counterpart of `mammodissect/parallel/`): process groups over
torch.distributed, one process per GPU (NCCL on the card, gloo on the CPU), the
("data", "model") mesh, collectives, data- and tensor-parallel sharding."""

from mammodissect_torch.parallel.collectives import all_gather_with_grad, pmean, psum
from mammodissect_torch.parallel.mesh import (
    GlobalEnv,
    data_group,
    data_parallel,
    make_mesh,
    mesh_shape_for,
)
from mammodissect_torch.parallel.multihost import gather_predictions, initialize
from mammodissect_torch.parallel.sharding import (
    apply_tensor_parallel,
    shard_batch,
    tensor_parallel_plan,
)

__all__ = [
    "GlobalEnv", "make_mesh", "mesh_shape_for", "data_group", "data_parallel",
    "all_gather_with_grad", "psum", "pmean", "initialize", "gather_predictions",
    "apply_tensor_parallel", "shard_batch", "tensor_parallel_plan",
]
