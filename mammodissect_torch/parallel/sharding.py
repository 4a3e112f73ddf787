"""Sharding plans (counterpart of `mammodissect/parallel/sharding.py`).

Data parallelism: each rank holds its slice of the batch (`shard_batch`); JAX's
replicated placement is DistributedDataParallel's broadcast of the weights from the
group's first rank at construction, and the gradient all-reduce that XLA inserts is
DDP's too.

Tensor parallelism over the mesh's "model" axis: the plan of JAX's
`param_shardings(tensor_parallel=True)` (`sharding.py:44-114`) written against the
port's names (torch layout: a weight is [out, in]):
- column-parallel (the output features split): BERT's query, key and value and the
  intermediate dense, weight and bias; the projection heads' `projection` weight
  (its bias stays whole);
- row-parallel (the input features split): the attention output and the MLP output
  dense weights (their biases stay whole);
- vocab-parallel: the word embedding's rows.
A dimension that does not divide by the model axis stays replicated, as JAX's
`_spec_for` leaves it. `apply_tensor_parallel` splits the modules by hand with
Megatron's f and g (an all-reduce in the backward or in the forward): the port's
`layers.Linear` and `layers.Embedding` carry a compute dtype, which
`torch.distributed.tensor.parallel`'s styles do not know. `full_state_dict` gathers
the shards back, so a tensor-parallel checkpoint loads as the single-GPU model."""
from __future__ import annotations

import re
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from mammodissect_torch.ops.activations import xla_bf16
from mammodissect_torch.parallel.collectives import _sum, all_gather
from mammodissect_torch.parallel.mesh import model_group

COLUMN, ROW, VOCAB, COLUMN_GATHER = "column", "row", "vocab", "column_gather"

# (module name pattern, how the module splits, the parameters it splits and along
# which dim); first hit wins
_TP_RULES = [
    (re.compile(r".*attention\.self\.(query|key|value)$"), COLUMN, {"weight": 0, "bias": 0}),
    (re.compile(r".*attention\.output\.dense$"), ROW, {"weight": 1}),
    (re.compile(r".*intermediate\.dense$"), COLUMN, {"weight": 0, "bias": 0}),
    (re.compile(r".*layer\.\d+\.output\.dense$"), ROW, {"weight": 1}),
    (re.compile(r"(.*\.)?(image_projection|text_projection)\.projection$"), COLUMN_GATHER,
     {"weight": 0}),
    (re.compile(r".*word_embeddings$"), VOCAB, {"weight": 0}),
]


def _module_rule(name: str):
    for rule, kind, dims in _TP_RULES:
        if rule.match(name):
            return kind, dims
    return None


def tensor_parallel_plan(model: nn.Module, model_parallel: int) -> Dict[str, int]:
    """{parameter name: the dim it splits along} of the model's tensor-parallel plan
    at `model_parallel` shards; a module whose split dims do not all divide stays
    whole (and is not listed)."""
    plan = {}
    for mname, module in model.named_modules():
        hit = _module_rule(mname)
        if hit is None:
            continue
        _, dims = hit
        params = {p: getattr(module, p) for p in dims if getattr(module, p, None) is not None}
        if all(t.shape[dims[p]] % model_parallel == 0 for p, t in params.items()):
            plan.update({f"{mname}.{p}": dims[p] for p in params})
    return plan


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the sum over the model axis forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The shards' last dims concatenated forward; this rank's part of the gradient
    backward (every rank computes the same loss from the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return all_gather(x, group, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        return grad.narrow(-1, rank * ctx.n, ctx.n).contiguous(), None


def copy_to_model(x, group):
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    return _ReduceFromModel.apply(x, group)


class ParallelLinear(nn.Module):
    """One shard of a split `layers.Linear`, under the original's parameter names.

    column: f(x) @ W_r^T + b_r, this rank's output features; column_gather: the
    same without the bias, gathered over the model axis, plus the whole bias; row:
    g(x_r @ W_r^T) + b, x_r this rank's input features."""

    def __init__(self, linear: nn.Linear, kind: str, group, dims: Dict[str, int]):
        super().__init__()
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        self.kind, self.group, self.dims = kind, group, dims
        self.compute_dtype = getattr(linear, "compute_dtype", None)

        def shard(name):
            p = getattr(linear, name)
            if p is None:
                return None
            t = p.detach().chunk(size, dim=dims[name])[rank] if name in dims else p.detach()
            return nn.Parameter(t.clone(), requires_grad=p.requires_grad)

        self.weight, self.bias = shard("weight"), shard("bias")

    def forward(self, x: torch.Tensor, sum_f32: bool = False) -> torch.Tensor:
        """`sum_f32` as `layers.Linear`'s; in bf16 inference the bias is added to the
        rounded product, as there."""
        dtype = self.compute_dtype or self.weight.dtype
        w = self.weight.to(dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        bf16 = xla_bf16(w)
        if self.kind == ROW:
            y = reduce_from_model(F.linear(x.to(dtype), w), self.group)
        else:
            fused = self.kind == COLUMN and not bf16
            y = F.linear(copy_to_model(x.to(dtype), self.group), w, bias if fused else None)
            if fused:
                return y
            if self.kind == COLUMN_GATHER:
                y = _GatherFromModel.apply(y, self.group)
        if bias is None:
            return y
        return y.float() + bias.float() if sum_f32 and bf16 else y + bias


class VocabParallelEmbedding(nn.Module):
    """This rank's rows [start, start + n) of a `layers.Embedding`: ids outside them
    look up zeros, and the sum over the model axis (float32, exact: one rank holds
    each row) is the whole table's lookup, cast to the compute dtype after."""

    def __init__(self, embedding: nn.Embedding, group):
        super().__init__()
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        rows = embedding.weight.detach().chunk(size, dim=0)[rank]
        self.start, self.group = rank * rows.shape[0], group
        self.compute_dtype = getattr(embedding, "compute_dtype", None)
        self.weight = nn.Parameter(rows.clone(), requires_grad=embedding.weight.requires_grad)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.start
        inside = (local >= 0) & (local < self.weight.shape[0])
        rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)), self.weight)
        rows = rows * inside[..., None].to(rows.dtype)
        return reduce_from_model(rows, self.group).to(self.compute_dtype or self.weight.dtype)


def apply_tensor_parallel(model: nn.Module, mesh) -> Dict[str, int]:
    """Split the model's planned modules over the mesh's "model" axis in place (each
    rank keeps its shard); the attention layers keep their heads / model_parallel
    heads. Returns the plan ({parameter: split dim})."""
    group = model_group(mesh)
    size = dist.get_world_size(group)
    plan = tensor_parallel_plan(model, size)
    if size == 1:
        return plan
    split = {n.rsplit(".", 1)[0] for n in plan}
    for mname in sorted(split):
        parent_name, _, child = mname.rpartition(".")
        parent = model.get_submodule(parent_name) if parent_name else model
        module = getattr(parent, child)
        kind, dims = _module_rule(mname)
        if kind == VOCAB:
            setattr(parent, child, VocabParallelEmbedding(module, group))
        else:
            setattr(parent, child, ParallelLinear(module, kind, group, dims))
        if child in ("query", "key", "value"):
            if parent.num_heads % size:
                raise ValueError(f"{parent_name}: {parent.num_heads} heads do not split "
                                 f"over model_parallel={size}")
            parent.local_heads = parent.num_heads // size
    return plan


def _split_modules(model: nn.Module):
    return {name: m for name, m in model.named_modules()
            if isinstance(m, (ParallelLinear, VocabParallelEmbedding))}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every tensor-parallel shard gathered back to the
    whole tensor (a collective: every rank of the model axis calls it)."""
    state = model.state_dict()
    for name, m in _split_modules(model).items():
        dims = m.dims if isinstance(m, ParallelLinear) else {"weight": 0}
        for p, dim in dims.items():
            state[f"{name}.{p}"] = all_gather(getattr(m, p).detach(), m.group, dim=dim)
    return state


def full_optimizer_state(optimizer: torch.optim.Optimizer, model: nn.Module) -> Dict:
    """The optimizer's state dict with the moments of split parameters gathered to
    whole tensors, in the order of `full_state_dict`'s parameters."""
    state = optimizer.state_dict()
    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups
                                            for p in g["params"])}
    for m in _split_modules(model).values():
        dims = m.dims if isinstance(m, ParallelLinear) else {"weight": 0}
        for p, dim in dims.items():
            i = index.get(id(getattr(m, p)))
            if i not in state["state"]:
                continue
            # a copy: the state dict's per-parameter dicts are the optimizer's own
            state["state"][i] = {
                key: all_gather(v, m.group, dim=dim) if torch.is_tensor(v) and v.dim() else v
                for key, v in state["state"][i].items()}
    return state


def shard_batch(batch, group=None, rank: Optional[int] = None, size: Optional[int] = None):
    """This rank's contiguous slice of every array's leading axis (an equal share:
    the leading axis must divide by the group's size)."""
    if rank is None:
        rank, size = dist.get_rank(group), dist.get_world_size(group)

    def take(x):
        n = x.shape[0]
        if n % size:
            raise ValueError(f"a batch of {n} does not split over {size} ranks")
        return x[rank * (n // size):(rank + 1) * (n // size)]

    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    return take(batch)
