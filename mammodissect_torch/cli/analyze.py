"""Analysis CLI — the headless `Plots/process_result_csvs.ipynb` + `Plots/Figure4.ipynb`
flow (reference cells 1-16 and Fig-4A/B/C) over dissection CSVs from this repo alone:

  python -m mammodissect_torch.cli.analyze --csv M_descriptions.csv \
      [--csv_b G_descriptions.csv] [--out_dir processed/] [--figures]

Per CSV: parse list-typed columns -> Top_concept/Top_similarity (cell 1), per-layer
mean similarity (cell 7), local Threshold_met (cell 9); with two CSVs, the global
threshold = per-layer max of both runs' means -> Global_thresh_met in both (cells
12-15); Top_concept -> Category/Broad_categories from the category source (cell 16 —
defaults to the vendored Extended_Breast_text_categories.xlsx; a categories JSON or
2-column CSV also works). --figures renders Figure-4A/B/C artifacts.

A copy of `mammodissect/cli/analyze.py` in the port's package (host code, no device work)."""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Mammo-CLIP Dissect CSV analysis (headless Plots/)")
    p.add_argument("--csv", required=True, help="descriptions CSV (e.g. the M-dissect run)")
    p.add_argument("--csv_b", default=None,
                   help="second run's CSV (e.g. G-dissect) for the global threshold")
    p.add_argument("--categories", default=None,
                   help="category source: .xlsx workbook / categories .json / 2-col "
                        ".csv; default = the vendored category workbook")
    p.add_argument("--out_dir", default="processed_results")
    p.add_argument("--figures", action="store_true",
                   help="render Figure-4A/B/C pngs (requires matplotlib)")
    p.add_argument("--domain_concepts", default=None,
                   help="txt file of in-domain concepts for Figure 4B; default = the "
                        "concepts categorized as mammography by the workbook (all "
                        "sheets except Environmental_and_Natural)")
    p.add_argument("--top_k_categories", type=int, default=3)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from mammodissect_torch.analysis.postprocess import (
        add_global_threshold,
        add_local_threshold,
        layer_mean_similarity,
        load_descriptions_csv,
        load_workbook_category_maps,
        load_category_map,
        map_categories,
        top_categories_per_layer,
        concept_domain_counts,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    if args.categories is None:
        from mammodissect_torch.assets import category_workbook_path

        args.categories = category_workbook_path()

    broad_map = None
    if args.categories.endswith((".xlsx", ".xlsm")):
        cat_map, broad_map = load_workbook_category_maps(args.categories)
    else:
        cat_map = load_category_map(args.categories)

    def process(path):
        df = load_descriptions_csv(path)
        df = add_local_threshold(df)
        df = map_categories(df, cat_map)
        if broad_map is not None:
            df = map_categories(df, broad_map, column="Broad_categories")
        return df

    def stem_of(path):
        return os.path.splitext(os.path.basename(path))[0]

    df_a = process(args.csv)
    stem_a = stem_of(args.csv)
    frames = {stem_a: df_a}
    if args.csv_b:
        df_b = process(args.csv_b)
        df_a, df_b, global_thresh = add_global_threshold(df_a, df_b)
        stem_b = stem_of(args.csv_b)
        if stem_b == stem_a:
            # both runs naming their output descriptions.csv is the natural layout;
            # disambiguate by the parent directory so neither run is dropped
            stem_a = f"{os.path.basename(os.path.dirname(os.path.abspath(args.csv))) or 'a'}_{stem_a}"
            stem_b = f"{os.path.basename(os.path.dirname(os.path.abspath(args.csv_b))) or 'b'}_{stem_b}"
            if stem_b == stem_a:
                stem_b += "_b"
        frames = {stem_a: df_a, stem_b: df_b}
        global_thresh.rename("Global_threshold").to_csv(
            os.path.join(args.out_dir, "global_thresholds.csv"))

    for stem, df in frames.items():
        out = os.path.join(args.out_dir, f"{stem}_processed.csv")
        df.to_csv(out, index=False)
        print(f"[analyze] {out}: {len(df)} neurons, "
              f"{int(df['Threshold_met'].sum())} over local threshold")

    if args.figures:
        from mammodissect_torch.analysis.figures import (
            fig4a_layer_means,
            fig4b_domain_counts,
            fig4c_top_categories,
        )

        curves = {stem: layer_mean_similarity(df) for stem, df in frames.items()}
        fig4a_layer_means(curves, os.path.join(args.out_dir, "fig4a_layer_means.png"))

        if args.domain_concepts:
            with open(args.domain_concepts) as f:
                domain = [w.strip() for w in f.read().split("\n") if w.strip()]
        elif broad_map is not None:
            domain = [c for c, b in broad_map.items()
                      if b != "Environmental_and_Natural"]
        else:
            domain = list(cat_map)
        fig4b_domain_counts(
            concept_domain_counts(df_a, domain),
            os.path.join(args.out_dir, "fig4b_domain_counts.png"))
        fig4c_top_categories(
            top_categories_per_layer(df_a, k=args.top_k_categories),
            os.path.join(args.out_dir, "fig4c_top_categories.png"))
        print(f"[analyze] Figure-4 artifacts in {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
