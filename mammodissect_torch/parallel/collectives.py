"""Collectives (counterpart of `mammodissect/parallel/collectives.py`).

`all_gather_with_grad` is the reference's `DistAutogradAllGatherFunction`
(`util/dist_autograd.py:5-27`) and the transpose JAX's autodiff gives
`jax.lax.all_gather`: a tiled all-gather forward, and in the backward the gradient
summed over the ranks, then this rank's slice. Sums run on float32 copies, so a
bf16 tensor is reduced without bf16 rounding and whatever the backend supports.
Every function takes a process group (None: every rank's)."""
from __future__ import annotations

import torch
import torch.distributed as dist


def _wire(x: torch.Tensor, group) -> torch.Tensor:
    """x where the group's backend takes it: gloo's collectives run on host copies
    of CUDA tensors (ranks sharing one card), NCCL's on the card."""
    return x.cpu() if x.is_cuda and dist.get_backend(group) == "gloo" else x


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group's ranks of x (a new float32 tensor, cast back)."""
    out = _wire(x.detach(), group).float().clone()
    dist.all_reduce(out, group=group)
    return out.to(device=x.device, dtype=x.dtype)


def all_gather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: the ranks' x (the same shape on every rank) concatenated
    along `dim` in rank order."""
    w = _wire(x.detach(), group).contiguous()
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


class _AllGatherWithGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        return _sum(grad, ctx.group).narrow(ctx.dim, rank * ctx.n, ctx.n), None, None


def all_gather_with_grad(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Differentiable tiled all-gather along `dim`; equal shapes on every rank."""
    return _AllGatherWithGrad.apply(x, group, dim)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of x over the group's ranks (not differentiable)."""
    return _sum(x, group)


def pmean(x: torch.Tensor, group=None) -> torch.Tensor:
    return _sum(x, group) / dist.get_world_size(group)
