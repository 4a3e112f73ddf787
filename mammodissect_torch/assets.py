"""Paths of the vendored data assets (counterpart of `mammodissect/assets/__init__.py`).

The files live under `mammodissect/assets/` and are read there by path, never
imported: the port imports nothing of the JAX package, but shares its data files.

  concepts/Specific_concepts_sorted.txt   the canonical concept set of every dissection
  concepts/Extended_Breast_text_categories.xlsx  the category workbook of the Plots flow
  dataset/{categories,updated_categories,seven_broad_categories}.json
                                          concept -> category groupings (28/30/7 groups)
  dataset/{prompts,prompts_all}.json      pos/neg x left/right report templates
  clip/bpe_simple_vocab_16e6.txt.gz       the CLIP BPE merges
"""
from __future__ import annotations

import os

_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "mammodissect", "assets")


def asset_path(relpath: str) -> str:
    """Absolute path of a vendored asset, e.g. asset_path('dataset/categories.json')."""
    path = os.path.join(_ROOT, relpath)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no vendored asset {relpath!r} under {_ROOT}")
    return path


def concept_set_path() -> str:
    """The canonical concept set (`Concepts/Specific_concepts_sorted.txt`)."""
    return asset_path("concepts/Specific_concepts_sorted.txt")


def categories_path(name: str = "seven_broad") -> str:
    """Category-grouping JSON: 'seven_broad' (7 groups), 'categories' (28),
    'updated' (30)."""
    fname = {
        "seven_broad": "seven_broad_categories.json",
        "categories": "categories.json",
        "updated": "updated_categories.json",
    }[name]
    return asset_path(f"dataset/{fname}")


def prompts_path(all_variants: bool = False) -> str:
    """Finding -> sentence-template JSON for prompt-generated reports."""
    return asset_path(f"dataset/{'prompts_all' if all_variants else 'prompts'}.json")


def category_workbook_path() -> str:
    """The category workbook (`Concepts/Extended_Breast_text_categories.xlsx`)."""
    return asset_path("concepts/Extended_Breast_text_categories.xlsx")


def clip_bpe_vocab_path() -> str:
    """The standard CLIP BPE merges file (`concept_vit/clip/bpe_simple_vocab_16e6.txt.gz`)."""
    return asset_path("clip/bpe_simple_vocab_16e6.txt.gz")
