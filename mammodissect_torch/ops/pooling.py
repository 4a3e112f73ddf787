"""Activation pooling rules and GeM pooling (counterpart of `mammodissect/ops/pooling.py`).

The reference's hook pooling contract: a 4-D CNN feature map pools to its spatial
mean ('avg') or max ('max'), 3-D ViT tokens to the CLS token, a 2-D output passes
through. The port's towers are NCHW, the JAX package's NHWC; `data_format` names
the layout of `x`."""
from __future__ import annotations

import torch

PM_SUFFIX = {"max": "_max", "avg": ""}  # the cache-file suffix of a pool mode (`utils.py:16`)


def pool_activation(x: torch.Tensor, mode: str = "avg", data_format: str = "NCHW") -> torch.Tensor:
    """Pool a captured activation to [batch, features]."""
    if mode not in ("avg", "max"):
        raise ValueError(f"pool mode must be 'avg' or 'max', got {mode!r}")
    if x.dim() == 4:
        dims = (2, 3) if data_format == "NCHW" else (1, 2)
        return x.mean(dim=dims) if mode == "avg" else x.amax(dim=dims)
    if x.dim() == 3:  # ViT tokens [B, T, D] -> CLS
        return x[:, 0]
    if x.dim() == 2:
        return x
    raise ValueError(f"cannot pool activation of rank {x.dim()}")


def gem_pool(x: torch.Tensor, p: torch.Tensor | float = 3.0, eps: float = 1e-6,
             data_format: str = "NCHW") -> torch.Tensor:
    """Generalized-mean pooling over the spatial dims: mean(clip(x, eps)^p)^(1/p)."""
    dims = (2, 3) if data_format == "NCHW" else (1, 2)
    pooled = torch.mean(x.clamp(min=eps) ** p, dim=dims)
    return pooled ** (1.0 / p)
