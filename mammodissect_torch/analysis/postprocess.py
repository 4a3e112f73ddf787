"""Dissection-CSV post-processing (reference `Plots/process_result_csvs.ipynb` cells
1-16 and `Plots/Figure4.ipynb` aggregations, headless):

1. parse list-typed `description`/`similarity` cells -> Top_concept / Top_similarity
2. per-layer Mean_similarity
3. local threshold: Threshold_met = Top_similarity >= layer mean
4. global threshold across two runs (e.g. M- vs G-dissect): per-layer
   max(mean_A, mean_B) -> Global_thresh_met in both frames
5. concept -> Category / Broad_category mapping from a {concept: category} dict
   (built from JSON files like `Concepts/seven_broad_categories.json` or the Excel
   workbook's sheets)
6. per-layer top-k category counts over threshold-passing neurons (Figure 4C)


A copy of `mammodissect/analysis/postprocess.py` in the port's package (host code, no device work)."""
from __future__ import annotations

import ast
import json
from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd


def _parse_cell(x):
    if isinstance(x, str):
        try:
            return ast.literal_eval(x)
        except (ValueError, SyntaxError):
            return [x]
    if isinstance(x, (list, tuple, np.ndarray)):
        return list(x)
    return [x]


def load_descriptions_csv(path_or_df) -> pd.DataFrame:
    """Read a descriptions CSV and add Top_concept / Top_similarity (cell 1)."""
    df = path_or_df.copy() if isinstance(path_or_df, pd.DataFrame) else pd.read_csv(path_or_df)
    desc = df["description"].map(_parse_cell)
    sim = df["similarity"].map(_parse_cell)
    df["description"] = desc
    df["similarity"] = sim
    df["Top_concept"] = desc.map(lambda d: d[0] if d else None)
    df["Top_similarity"] = sim.map(lambda s: float(s[0]) if len(s) else np.nan)
    return df


def layer_mean_similarity(df: pd.DataFrame) -> pd.Series:
    """Per-layer mean of Top_similarity (cell 7 / Figure 4A curves)."""
    return df.groupby("layer", sort=False)["Top_similarity"].mean()


def add_local_threshold(df: pd.DataFrame) -> pd.DataFrame:
    """Threshold_met = Top_similarity >= its layer's mean (cell 9)."""
    means = layer_mean_similarity(df)
    df = df.copy()
    df["Threshold_met"] = df["Top_similarity"] >= df["layer"].map(means)
    return df


def add_global_threshold(df_a: pd.DataFrame, df_b: pd.DataFrame):
    """Global threshold per layer = max of the two runs' layer means; adds
    Global_thresh_met to both frames (cells 12-15)."""
    means_a = layer_mean_similarity(df_a)
    means_b = layer_mean_similarity(df_b)
    global_thresh = pd.concat([means_a, means_b], axis=1).max(axis=1)
    out = []
    for df in (df_a, df_b):
        df = df.copy()
        df["Global_thresh_met"] = df["Top_similarity"] >= df["layer"].map(global_thresh)
        out.append(df)
    return out[0], out[1], global_thresh


def load_category_map(path: str) -> Dict[str, str]:
    """{concept: category} from a categories JSON ({category: [concepts]} layout like
    `data/dataset/seven_broad_categories.json`), an .xlsx category workbook
    (`Concepts/Extended_Breast_text_categories.xlsx` — column headers are the
    categories, cell 16 semantics), or a 2-column CSV."""
    if path.endswith(".json"):
        with open(path) as f:
            data = json.load(f)
        return {c: cat for cat, concepts in data.items() for c in concepts}
    if path.endswith((".xlsx", ".xlsm")):
        cat_map, _broad = load_workbook_category_maps(path)
        return cat_map
    df = pd.read_csv(path)
    cols = list(df.columns[:2])
    return dict(zip(df[cols[0]], df[cols[1]]))


def load_workbook_category_maps(path: str):
    """Parse a category workbook into ({concept: Category}, {concept: Broad_category}).

    Walks sheets then columns in workbook order with later assignments overriding
    earlier ones — exactly the double loop of `process_result_csvs.ipynb` cell 16
    (column header -> 'Category', sheet name -> 'Broad_categories')."""
    from mammodissect_torch.utils.xlsx import load_workbook_columns

    cat_map: Dict[str, str] = {}
    broad_map: Dict[str, str] = {}
    for sheet_name, columns in load_workbook_columns(path).items():
        for column, values in columns.items():
            for concept in values:
                cat_map[str(concept)] = column
                broad_map[str(concept)] = sheet_name
    return cat_map, broad_map


def map_concepts_to_categories(df: pd.DataFrame, workbook_path: str) -> pd.DataFrame:
    """Add Category + Broad_categories columns from the workbook (cell 16 headless).
    Unmatched concepts stay None, as in the notebook."""
    cat_map, broad_map = load_workbook_category_maps(workbook_path)
    df = df.copy()
    df["Category"] = df["Top_concept"].map(lambda c: cat_map.get(c))
    df["Broad_categories"] = df["Top_concept"].map(lambda c: broad_map.get(c))
    return df


def map_categories(df: pd.DataFrame, category_map: Dict[str, str],
                   column: str = "Category", default: str = "Uncategorized") -> pd.DataFrame:
    """Top_concept -> category column (cell 16)."""
    df = df.copy()
    df[column] = df["Top_concept"].map(lambda c: category_map.get(c, default))
    return df


def top_categories_per_layer(df: pd.DataFrame, k: int = 3,
                             threshold_col: Optional[str] = "Threshold_met",
                             category_col: str = "Category") -> pd.DataFrame:
    """Top-k categories per layer over threshold-passing neurons (Figure 4C)."""
    sub = df[df[threshold_col]] if threshold_col and threshold_col in df.columns else df
    counts = (sub.groupby(["layer", category_col], sort=False).size()
              .rename("count").reset_index())
    return (counts.sort_values(["layer", "count"], ascending=[True, False])
            .groupby("layer", sort=False).head(k).reset_index(drop=True))


def concept_domain_counts(df: pd.DataFrame, domain_concepts: Sequence[str],
                          layers: Optional[Sequence[str]] = None,
                          threshold_col: str = "Threshold_met") -> pd.DataFrame:
    """Domain-vs-other Top_concept counts per layer for threshold-passing neurons
    (Figure 4B: mammography vs non-mammography concepts at blocks 2/19/38)."""
    domain = set(domain_concepts)
    sub = df[df[threshold_col]] if threshold_col in df.columns else df
    if layers is not None:
        sub = sub[sub["layer"].isin(list(layers))]
    rows = []
    for layer, grp in sub.groupby("layer", sort=False):
        in_domain = grp["Top_concept"].isin(domain).sum()
        rows.append({"layer": layer, "domain": int(in_domain),
                     "other": int(len(grp) - in_domain)})
    return pd.DataFrame(rows)
