"""The port's headless analysis flow against the JAX package's: every case of
`tests/test_analysis.py` through both packages' functions gives equal frames, both
`.xlsx` readers give equal maps of the vendored workbook, both `cli.analyze` write
the same files with equal contents, the figures render, and the port's asset paths
are the JAX package's files."""
import filecmp
import os

import numpy as np
import pandas as pd
import pytest
from pandas.testing import assert_frame_equal, assert_series_equal

import mammodissect.analysis as ja
import mammodissect.analysis.postprocess as jpp
import mammodissect_torch.analysis as ta
import mammodissect_torch.analysis.postprocess as tpp


@pytest.fixture()
def df():
    rows = []
    for layer, sims in [("blocks.0", [0.9, 0.1, 0.5]), ("blocks.1", [0.2, 0.4, 0.6])]:
        for unit, s in enumerate(sims):
            rows.append({
                "layer": layer, "unit": unit,
                "description": str([f"c{unit}", "x", "y"]),
                "similarity": str([s, s - 0.05, s - 0.1]),
                "images": str([1, 2, 3, 4, 5]),
            })
    return pd.DataFrame(rows)


def test_same_public_names():
    assert ta.__all__ == ja.__all__
    for name in ta.__all__:
        assert callable(getattr(ta, name)), name


def test_load_and_local_threshold_equal(df):
    a, b = ja.load_descriptions_csv(df), ta.load_descriptions_csv(df)
    assert_frame_equal(b, a)
    assert b.loc[0, "Top_concept"] == "c0"
    assert_series_equal(ta.layer_mean_similarity(b), ja.layer_mean_similarity(a))
    assert_frame_equal(ta.add_local_threshold(b), ja.add_local_threshold(a))
    assert list(ta.add_local_threshold(b)["Threshold_met"][:3]) == [True, False, True]


def test_global_threshold_equal(df):
    a, b = ja.load_descriptions_csv(df), ta.load_descriptions_csv(df)
    a_hi, b_hi = a.copy(), b.copy()
    a_hi["Top_similarity"] += 0.2
    b_hi["Top_similarity"] += 0.2
    want = ja.add_global_threshold(a, a_hi)
    got = ta.add_global_threshold(b, b_hi)
    assert_frame_equal(got[0], want[0])
    assert_frame_equal(got[1], want[1])
    assert_series_equal(got[2], want[2])
    assert got[2]["blocks.0"] == pytest.approx(0.7)


def test_category_mapping_topk_and_domain_counts_equal(df):
    cmap = {"c0": "Findings", "c1": "Anatomy", "c2": "Findings"}
    a = ja.map_categories(ja.add_local_threshold(ja.load_descriptions_csv(df)), cmap)
    b = ta.map_categories(ta.add_local_threshold(ta.load_descriptions_csv(df)), cmap)
    assert_frame_equal(b, a)
    for k in (1, 3):
        assert_frame_equal(ta.top_categories_per_layer(b, k=k),
                           ja.top_categories_per_layer(a, k=k))
    got = tpp.concept_domain_counts(b, ["c0"], threshold_col="Threshold_met")
    assert_frame_equal(got, jpp.concept_domain_counts(a, ["c0"], threshold_col="Threshold_met"))
    assert_frame_equal(tpp.concept_domain_counts(b, ["c0"], layers=["blocks.1"]),
                       jpp.concept_domain_counts(a, ["c0"], layers=["blocks.1"]))


def test_workbook_maps_and_xlsx_readers_equal():
    from mammodissect.assets import category_workbook_path as j_workbook
    from mammodissect.utils.xlsx import load_workbook_columns as j_columns, read_xlsx as j_read
    from mammodissect_torch.assets import category_workbook_path
    from mammodissect_torch.utils.xlsx import load_workbook_columns, read_xlsx

    path = category_workbook_path()
    assert path == j_workbook()
    assert read_xlsx(path) == j_read(path)
    assert load_workbook_columns(path) == j_columns(path)
    cat, broad = tpp.load_workbook_category_maps(path)
    assert (cat, broad) == jpp.load_workbook_category_maps(path)
    assert len(cat) > 500 and broad["breast"] == "Breast_anatomy_or_structure"
    assert tpp.load_category_map(path) == cat
    frame = pd.DataFrame({"Top_concept": ["breast", "no-such-concept"]})
    assert_frame_equal(tpp.map_concepts_to_categories(frame, path),
                       jpp.map_concepts_to_categories(frame, path))


def test_category_map_json_and_csv_equal(tmp_path):
    from mammodissect_torch.assets import categories_path

    for name in ("seven_broad", "categories", "updated"):
        assert tpp.load_category_map(categories_path(name)) == \
            jpp.load_category_map(categories_path(name))
    csv = tmp_path / "map.csv"
    pd.DataFrame({"concept": ["mass", "sky"], "cat": ["Findings", "Nature"]}).to_csv(
        csv, index=False)
    assert tpp.load_category_map(str(csv)) == jpp.load_category_map(str(csv))


def test_asset_paths_are_the_jax_packages_files():
    import mammodissect.assets as j
    import mammodissect_torch.assets as t

    assert t.concept_set_path() == j.concept_set_path()
    assert t.category_workbook_path() == j.category_workbook_path()
    assert t.clip_bpe_vocab_path() == j.clip_bpe_vocab_path()
    for flag in (False, True):
        assert t.prompts_path(flag) == j.prompts_path(flag)
    for name in ("seven_broad", "categories", "updated"):
        assert t.categories_path(name) == j.categories_path(name)
    with pytest.raises(FileNotFoundError, match="no-such"):
        t.asset_path("no-such/file.txt")


def _figure_frame(pp):
    rows = []
    for li, layer in enumerate(["blocks.0", "blocks.1", "blocks.2"]):
        for u in range(6):
            c = ["mass", "dog", "sky", "calcification", "tree", "grass"][u]
            rows.append(dict(layer=layer, unit=u, description=str([c, "x"]),
                             similarity=str([0.5 + 0.1 * u + 0.01 * li, 0.1]),
                             images=str([0, 1])))
    df = pp.add_local_threshold(pp.load_descriptions_csv(pd.DataFrame(rows)))
    return pp.map_categories(df, {"mass": "Findings", "calcification": "Findings",
                                  "dog": "Animals", "sky": "Nature", "tree": "Nature",
                                  "grass": "Nature"})


def test_figure4_rendering(tmp_path):
    pytest.importorskip("matplotlib")
    from mammodissect_torch.analysis.figures import (
        fig4a_layer_means,
        fig4b_domain_counts,
        fig4c_top_categories,
    )

    df = _figure_frame(tpp)
    assert_frame_equal(df, _figure_frame(jpp))
    p_a, p_b, p_c = (tmp_path / f"fig4{x}.png" for x in "abc")
    fig4a_layer_means({"M": tpp.layer_mean_similarity(df),
                       "G": tpp.layer_mean_similarity(df) * 0.9}, str(p_a))
    fig4b_domain_counts(tpp.concept_domain_counts(df, ["mass", "calcification"]), str(p_b))
    fig4c_top_categories(tpp.top_categories_per_layer(df), str(p_c))
    for p in (p_a, p_b, p_c):
        assert p.exists() and p.stat().st_size > 2000


def _make_csv(path, offset):
    concepts = ["breast", "mass", "calcification", "grass", "sky", "dog"]
    path.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for layer in ["blocks.0", "blocks.1"]:
        for u in range(6):
            cs = [concepts[(u + offset) % 6], concepts[(u + offset + 1) % 6]]
            rows.append(dict(layer=layer, unit=u, description=str(cs),
                             similarity=str([0.3 + 0.1 * u, 0.1]), images=str([0, 1, 2])))
    pd.DataFrame(rows).to_csv(path, index=False)


def _both_clis(tmp_path, a, b, extra=()):
    """Both packages' analyze CLIs on the same CSVs; returns their output dirs."""
    from mammodissect.cli.analyze import main as jax_main
    from mammodissect_torch.cli.analyze import main as port_main

    outs = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = tmp_path / name
        assert main(["--csv", str(a), "--csv_b", str(b), "--out_dir", str(out), *extra]) == 0
        outs.append(out)
    return outs


def test_analyze_cli_writes_the_jax_files(tmp_path):
    a, b = tmp_path / "M_desc.csv", tmp_path / "G_desc.csv"
    _make_csv(a, 0)
    _make_csv(b, 2)
    domain = tmp_path / "domain.txt"
    domain.write_text("mass\r\n  calcification  \n\nbreast\n")
    want, got = _both_clis(tmp_path, a, b, ["--domain_concepts", str(domain)])
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(got))
    assert names == ["G_desc_processed.csv", "M_desc_processed.csv", "global_thresholds.csv"]
    for name in names:
        assert filecmp.cmp(want / name, got / name, shallow=False), name
    pa = pd.read_csv(got / "M_desc_processed.csv")
    assert (pa[pa.Top_concept == "breast"]["Broad_categories"]
            == "Breast_anatomy_or_structure").all()


def test_analyze_cli_figures(tmp_path):
    pytest.importorskip("matplotlib")
    from mammodissect_torch.cli.analyze import main

    a, b = tmp_path / "M_desc.csv", tmp_path / "G_desc.csv"
    _make_csv(a, 0)
    _make_csv(b, 2)
    out = tmp_path / "out"
    assert main(["--csv", str(a), "--csv_b", str(b), "--out_dir", str(out), "--figures"]) == 0
    for fig in ("fig4a_layer_means.png", "fig4b_domain_counts.png", "fig4c_top_categories.png"):
        assert (out / fig).stat().st_size > 2000


def test_analyze_cli_same_basename_csvs_both_written(tmp_path):
    a, b = tmp_path / "M" / "descriptions.csv", tmp_path / "G" / "descriptions.csv"
    _make_csv(a, 0)
    _make_csv(b, 1)
    want, got = _both_clis(tmp_path, a, b)
    names = sorted(os.listdir(got))
    assert names == sorted(os.listdir(want))
    assert len([n for n in names if n.endswith("_processed.csv")]) == 2, names
    for name in names:
        assert filecmp.cmp(want / name, got / name, shallow=False), name
    assert np.isfinite(pd.read_csv(got / "global_thresholds.csv")["Global_threshold"]).all()
