"""Dissection engine: resident harvest, scoring and the results CSV."""

from mammodissect_torch.dissect.capture import canonical_layer_name, layer_index
from mammodissect_torch.dissect.engine import (
    get_save_names,
    get_similarity_from_activations,
    run_dissection,
    save_activations,
)
from mammodissect_torch.dissect.results import write_results

__all__ = [
    "canonical_layer_name",
    "layer_index",
    "get_save_names",
    "save_activations",
    "get_similarity_from_activations",
    "run_dissection",
    "write_results",
]
