"""Scoring, pooling and normalization ops, and the wrappers of the CUDA kernels
(the kernels build and load at their first launch, not at import)."""

from mammodissect_torch.ops.similarity import (
    SIMILARITY_FNS,
    cos_similarity,
    cos_similarity_cubed,
    get_similarity_fn,
    rank_reorder,
    soft_wpmi,
    wpmi,
)
from mammodissect_torch.ops.pooling import gem_pool, pool_activation

__all__ = [
    "SIMILARITY_FNS",
    "get_similarity_fn",
    "soft_wpmi",
    "wpmi",
    "rank_reorder",
    "cos_similarity",
    "cos_similarity_cubed",
    "pool_activation",
    "gem_pool",
]
