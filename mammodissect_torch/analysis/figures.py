"""Figure rendering for the paper's Figure-4 panels (reference `Plots/Figure4.ipynb`).

The aggregation logic lives in `analysis.postprocess` (the notebooks' dataframes,
headless); this module turns those frames into the actual artifacts:

  fig4a — per-layer mean Top_similarity curves, M- vs G-dissect (cells 1-7)
  fig4b — mammography- vs non-mammography-concept counts at selected blocks (cell 8)
  fig4c — top-3 categories per layer as stacked bars with a fixed color map (cell 9)

Matplotlib is imported lazily with the Agg backend so the module stays usable on
headless hosts and optional if matplotlib is absent.

A copy of `mammodissect/analysis/figures.py` in the port's package (host code, no device work)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import pandas as pd


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def fig4a_layer_means(curves: Dict[str, pd.Series], out_path: Optional[str] = None,
                      title: str = "Mean top-concept similarity per layer"):
    """curves: {label: layer_mean_similarity(df)} — e.g. {"M-dissect": ..., "G-dissect": ...}."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    for label, series in curves.items():
        ax.plot(range(len(series)), series.values, marker="o", markersize=3, label=label)
    ax.set_xlabel("layer index")
    ax.set_ylabel("mean Top_similarity")
    ax.set_title(title)
    ax.legend(frameon=False)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def fig4b_domain_counts(counts: pd.DataFrame, out_path: Optional[str] = None,
                        domain_label: str = "mammography",
                        other_label: str = "non-mammography"):
    """counts: concept_domain_counts(...) frame with columns {layer, domain, other}
    (the reference compares blocks 2/19/38 as 'Block 1/4/7', cell 8)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    x = range(len(counts))
    w = 0.38
    ax.bar([i - w / 2 for i in x], counts["domain"], width=w, label=domain_label)
    ax.bar([i + w / 2 for i in x], counts["other"], width=w, label=other_label)
    ax.set_xticks(list(x))
    ax.set_xticklabels(counts["layer"], rotation=30, ha="right")
    ax.set_ylabel("threshold-passing neurons")
    ax.legend(frameon=False)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig


def fig4c_top_categories(top_cats: pd.DataFrame, out_path: Optional[str] = None,
                         color_map: Optional[Dict[str, str]] = None,
                         layer_order: Optional[Sequence[str]] = None):
    """top_cats: top_categories_per_layer(...) frame {layer, Category, count} —
    stacked bars per layer, one color per category (fixed map like cell 9's)."""
    plt = _plt()
    cats = list(dict.fromkeys(top_cats["Category"]))
    if color_map is None:
        cmap = plt.get_cmap("tab10")
        color_map = {c: cmap(i % 10) for i, c in enumerate(cats)}
    layers = list(layer_order) if layer_order is not None else list(
        dict.fromkeys(top_cats["layer"]))
    fig, ax = plt.subplots(figsize=(max(6, len(layers) * 0.35), 4))
    bottoms = {l: 0.0 for l in layers}
    seen = set()
    for cat in cats:
        sub = top_cats[top_cats["Category"] == cat].set_index("layer")["count"]
        xs, hs, bs = [], [], []
        for i, l in enumerate(layers):
            if l in sub.index:
                xs.append(i)
                hs.append(float(sub[l]))
                bs.append(bottoms[l])
                bottoms[l] += float(sub[l])
        if xs:
            ax.bar(xs, hs, bottom=bs, color=color_map.get(cat),
                   label=None if cat in seen else cat)
            seen.add(cat)
    ax.set_xticks(range(len(layers)))
    ax.set_xticklabels(layers, rotation=90, fontsize=6)
    ax.set_ylabel("neurons")
    ax.legend(frameon=False, fontsize=7, ncols=2)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig
