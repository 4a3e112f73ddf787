"""Headless analysis of dissection CSVs — the library form of the reference's
`Plots/process_result_csvs.ipynb` and `Plots/Figure4.ipynb` logic (SURVEY.md §2.10), so
post-processing is reproducible without notebooks.

A copy of `mammodissect/analysis/` in the port's package (host code, no device work)."""

from mammodissect_torch.analysis.postprocess import (
    add_global_threshold,
    add_local_threshold,
    concept_domain_counts,
    layer_mean_similarity,
    load_category_map,
    load_descriptions_csv,
    load_workbook_category_maps,
    map_categories,
    map_concepts_to_categories,
    top_categories_per_layer,
)

__all__ = [
    "load_descriptions_csv",
    "layer_mean_similarity",
    "add_local_threshold",
    "add_global_threshold",
    "concept_domain_counts",
    "load_category_map",
    "load_workbook_category_maps",
    "map_categories",
    "map_concepts_to_categories",
    "top_categories_per_layer",
]
