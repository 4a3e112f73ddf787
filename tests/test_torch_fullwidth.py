"""The committed references of the full-width agreement (`tests/_fullwidth_agreement.py`):
the seeded weights (drawn and calibrated) and the mammo_png probe's images reproduce
the manifest's SHA-256 on the CPU, each reference's JAX CSV has one row for each of
the 6992 units of B5's 39 blocks, and the comparison reports a unit whose top
concept differs with its margins."""
import json
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _fullwidth_agreement as fw  # noqa: E402

B5_WIDTHS = [24] * 3 + [40] * 5 + [64] * 5 + [128] * 7 + [176] * 7 + [304] * 9 + [512] * 3


@pytest.fixture(scope="module")
def manifest():
    with open(fw.MANIFEST) as f:
        return json.load(f)


@pytest.fixture(scope="module", params=sorted(fw.REFERENCES))
def ref_df(request):
    return request.param, fw.read_csv(fw.jax_csv(request.param))


@pytest.mark.parametrize("weights", fw.WEIGHTS)
def test_weights_reproduce_the_manifest_sha256(manifest, weights):
    sd, sha = fw.draw_state_dict(manifest["seed"], weights)
    assert sha == manifest["weights_sha256"][weights]
    weights = fw.weight_tensors(sd)
    assert len(weights) == 938
    assert sd["text_encoder.embeddings.word_embeddings.weight"].shape[0] == 77  # toy vocab
    assert all(bool((v > 0).all()) for k, v in sd.items() if k.endswith("running_var"))
    assert float(sd["logit_scale"]) == pytest.approx(np.log(1 / 0.07))
    tar = fw.reference_layout(sd)
    assert "text_encoder.bert.encoder.layer.11.output.dense.weight" in tar
    assert fw.assert_same_tensors(sd, sd, "self") == sum(v.numel() for v in weights.values())


def test_calibrated_statistics_cover_every_batchnorm_of_the_tower():
    stats = dict(np.load(fw.BN_STATS))
    names = {n for n, _, _ in fw._module_shapes()
             if n.startswith("image_encoder.") and n.endswith(("running_mean", "running_var"))}
    assert set(stats) == names and len(names) == 232
    assert all((v > 0).all() for k, v in stats.items() if k.endswith("running_var"))
    assert all(np.isfinite(v).all() and v.dtype == np.float32 for v in stats.values())


def test_mammo_png_images_reproduce_the_manifest_sha256(manifest):
    images, sha = fw.mammo_images(seed=manifest["seed"])
    assert sha == manifest["images_sha256"]["mammo_png"]
    assert images.shape == (128, 1520, 912) and images.dtype == np.uint8
    background = (images == 0).mean(axis=(1, 2))
    assert ((background > 0.3) & (background < 0.7)).all()  # a breast on black, each


def test_manifest_is_the_agreement_run(manifest):
    assert sorted(manifest["references"]) == sorted(fw.REFERENCES)
    for ref, entry in manifest["references"].items():
        assert (entry["probe"], entry["weights"]) == fw.REFERENCES[ref]
        assert entry["cli"] == fw.manifest_cli(ref)
        assert entry["rows"] == fw.N_UNITS == 6992
    assert fw.probe_spec("synthetic_u8") == ("synthetic_u8", {
        "n": 128, "h": 1520, "w": 912, "seed": 0})
    size = sum(os.path.getsize(fw.jax_csv(r)) for r in fw.REFERENCES)
    assert size + os.path.getsize(fw.MANIFEST) + os.path.getsize(fw.BN_STATS) < 3 * 2 ** 20


def test_jax_csv_has_every_unit(manifest, ref_df):
    ref, jax_df = ref_df
    assert list(jax_df.columns) == manifest["references"][ref]["columns"]
    assert len(jax_df) == 6992
    per_layer = jax_df.groupby("layer", sort=False)["unit"].apply(list)
    assert list(per_layer.index) == [f"blocks.{i}" for i in range(39)]
    assert [len(u) for u in per_layer] == B5_WIDTHS
    assert all(u == list(range(len(u))) for u in per_layer)
    sims = np.array(jax_df["similarity"].tolist())
    assert sims.shape == (6992, 10) and np.isfinite(sims).all()
    assert (np.diff(sims, axis=1) <= 0).all()  # each unit's concepts in descending order
    images = np.array(jax_df["images"].tolist())
    assert images.shape == (6992, 5) and ((0 <= images) & (images < 128)).all()


def test_compare_reports_disagreements_and_margins():
    jax_df = fw.read_csv(fw.jax_csv("noise_drawn"))
    same = fw.compare_csvs(jax_df, jax_df)
    assert same["top1"] == 1.0 and same["images_identical"] == 1.0
    assert same["disagreeing"] == 0 and same["max_similarity_diff"] == 0.0
    assert same["distinct_top1"][0] == same["distinct_top1"][1]
    other = jax_df.copy()
    row = other.index[(other["layer"] == "blocks.5") & (other["unit"] == 3)][0]
    desc, sim = list(other.at[row, "description"]), list(other.at[row, "similarity"])
    desc[0], desc[1] = desc[1], desc[0]
    other.at[row, "description"] = desc
    other.at[row, "images"] = [0, 1, 2, 3, 4]
    stats = fw.compare_csvs(jax_df, other)
    assert stats["units"] == 6992 and stats["disagreeing"] == 1
    assert stats["top1"] == pytest.approx(1 - 1 / 6992)
    assert stats["min_layer"] == "blocks.5"
    assert stats["min_layer_top1"] == pytest.approx(1 - 1 / 40)
    assert stats["disagreements"] == [{"layer": "blocks.5", "unit": 3,
                                       "margin_a": sim[0] - sim[1], "margin_b": sim[0] - sim[1]}]
    assert stats["max_similarity_diff"] == pytest.approx(sim[0] - sim[1])
    assert stats["images_identical"] < 1.0
    with pytest.raises(ValueError, match="different units"):
        fw.compare_csvs(jax_df, jax_df.iloc[1:])
