"""The staged (disk-cache) dissection of the PyTorch port against the JAX package's:
the same probe through both packages' `run_dissection(resident=False)` with the same
weights (carried across from JAX), float32 on the CPU. The CSVs must agree on >= 99%
of per-unit top-1 concepts, list the same top images, and give the same similarities
(rtol 1e-4, atol 1e-4 * max|sim|). Also the cache names, skip-if-exists, the fused
staged path, the float32 and uint8 harvests, the resident fallback and the random
dissector."""
import ast
import json
import os
import warnings

import jax
import numpy as np
import pandas as pd
import pytest

from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
from mammodissect.dissect.engine import run_dissection as jax_run_dissection
from mammodissect_torch.convert import efficientnet_from_jax
from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

GOLDEN_CSV = os.path.join(os.path.dirname(__file__), "assets", "golden",
                          "synthetic_tiny_descriptions.csv")
# the golden fixture's concept set (tests/test_golden_csv.py)
CONCEPTS = ["mass", "calcification", "fatty tissue", "dog", "truck", "spiculated margin",
            "dense breast", "skin thickening", "bright spot", "dark background",
            "architectural distortion", "benign lesion"]


def _golden_kw(tmp_path):
    concept_file = tmp_path / "golden_concepts.txt"
    concept_file.write_text("\n".join(CONCEPTS))
    return dict(target_model="tiny_cnn", target_layers=["blocks.0", "blocks.3"],
                d_probe="synthetic", concept_set=str(concept_file), clip_model="random",
                batch_size=16, similarity_fn="soft_wpmi", top_k=16,
                probe_kwargs={"n": 32, "h": 64, "w": 64, "c": 1, "seed": 0})


def _tiny_cnn_targets(**kw):
    """The JAX tiny_cnn target and the port's with the JAX weights."""
    from mammodissect.dissect.targets import get_target_model as jax_target
    from mammodissect_torch.dissect.targets import get_target_model

    jt = jax_target("tiny_cnn", **kw)
    pt = get_target_model("tiny_cnn", device="cpu", **kw)
    v = jax.tree.map(np.array, jt.variables)
    pt.model.load_state_dict(efficientnet_from_jax(v["params"], v["batch_stats"]))
    return jt, pt


def _read(path):
    df = pd.read_csv(path)
    return df, np.array([json.loads(s) for s in df["similarity"]])


def _assert_agree(path, jpath):
    (df, sim), (jdf, jsim) = _read(path), _read(jpath)
    assert list(df["layer"]) == list(jdf["layer"]) and list(df["unit"]) == list(jdf["unit"])
    top = [[ast.literal_eval(r)[0] for r in d["description"]] for d in (df, jdf)]
    assert np.mean([a == b for a, b in zip(*top)]) >= 0.99
    assert list(df["images"]) == list(jdf["images"])
    assert np.isfinite(sim).all()
    np.testing.assert_allclose(sim, jsim, rtol=1e-4, atol=1e-4 * np.abs(jsim).max())


def test_staged_tiny_cnn_random_matches_jax_and_golden(tmp_path):
    kw = _golden_kw(tmp_path)
    jt, pt = _tiny_cnn_targets()
    _, jpath = jax_run_dissection(
        JaxDissectConfig(activation_dir=str(tmp_path / "ja"), result_dir=str(tmp_path / "jr"),
                         **kw), target=jt, log=lambda *_: None)
    logs = []
    df, path = run_dissection(
        DissectConfig(device="cpu", activation_dir=str(tmp_path / "pa"),
                      result_dir=str(tmp_path / "pr"), **kw), target=pt, log=logs.append)
    assert any(l.startswith("[harvest] 32 images x 2 layers") for l in logs), logs
    assert len(df) == 56  # 16 + 40 units
    _assert_agree(path, jpath)
    # the committed golden CSV of the JAX package: the same descriptions and images
    (got, sim), (golden, gsim) = _read(path), _read(GOLDEN_CSV)
    assert list(got["description"]) == list(golden["description"])
    assert list(got["images"]) == list(golden["images"])
    np.testing.assert_allclose(sim, gsim, rtol=1e-4, atol=1e-4 * np.abs(gsim).max())


@pytest.mark.parametrize("args", [
    ("breastclip", "breastclip", "image_encoder._blocks[17]", "csv:/data/probe.csv",
     "/x/Specific_concepts_sorted.txt", "avg", "acts", ""),
    ("random", "tiny_cnn", "blocks.3", "synthetic", "concepts.txt", "max", "/tmp/a", "exp1_"),
    ("ViT-B/16", "breastclip_classifier", "blocks.38", "folder:/d/p", "c.txt", "avg", "s", ""),
])
def test_save_names_match_jax(args):
    from mammodissect.dissect.engine import get_save_names as jax_names
    from mammodissect_torch.dissect.engine import get_save_names

    assert get_save_names(*args) == jax_names(*args)


def test_second_run_reads_the_cache(tmp_path):
    """A rerun skips every stage whose file exists. The cached files also score one
    layer at a time as the JAX package's `get_similarity_from_activations` does."""
    from mammodissect.dissect.engine import get_similarity_from_activations as jax_sim
    from mammodissect.ops.similarity import soft_wpmi as jax_soft_wpmi
    from mammodissect_torch.dissect.engine import (
        get_save_names,
        get_similarity_from_activations,
        get_target_activations,
    )
    from mammodissect_torch.ops.similarity import soft_wpmi

    kw = _golden_kw(tmp_path)
    _, pt = _tiny_cnn_targets()
    cfg = DissectConfig(device="cpu", activation_dir=str(tmp_path / "a"),
                        result_dir=str(tmp_path / "r"), **kw)
    first, _ = run_dissection(cfg, target=pt, log=lambda *_: None)
    names = get_save_names("random", "tiny_cnn", "blocks.3", "synthetic", kw["concept_set"],
                           "avg", str(tmp_path / "a"))
    sim, feats = get_similarity_from_activations(*names, soft_wpmi, top_k=16, device="cpu")
    jsim, jfeats = jax_sim(*names, jax_soft_wpmi, top_k=16)
    np.testing.assert_array_equal(feats, jfeats)
    np.testing.assert_allclose(sim, jsim, rtol=1e-5, atol=1e-5 * np.abs(jsim).max())
    np.testing.assert_array_equal(get_target_activations(names[0], 5), feats[:, 5])
    logs = []
    again, _ = run_dissection(cfg, target=pt, log=logs.append)
    assert "[harvest] all target activations cached, skipping" in logs, logs
    assert "[clip-img] probe embeddings cached, skipping" in logs, logs
    assert not any(l.startswith("[clip-txt]") for l in logs), logs
    pd.testing.assert_frame_equal(first, again)


def test_float_and_u8_harvests_match_jax():
    """harvest_probe's two paths: float32 batches (`iter_batches`) and the pipelined
    uint8 wire with device-side normalization, against the JAX package's."""
    from mammodissect.data.probes import get_probe as jax_probe
    from mammodissect.dissect.engine import harvest_probe as jax_harvest
    from mammodissect_torch.data.probes import get_probe
    from mammodissect_torch.dissect.engine import harvest_probe

    jt, pt = _tiny_cnn_targets()
    layers = ["blocks.1", "blocks.4", "blocks.9"]
    for spec in ("synthetic", "synthetic_u8"):
        kw = {"n": 13, "h": 48, "w": 40, "seed": 3}
        got, n = harvest_probe(pt, get_probe(spec, **kw), layers, "avg", 5, pipeline_depth=1)
        want, jn = jax_harvest(jt, jax_probe(spec, **kw), layers, "avg", 5)
        assert n == jn == 13
        for l in layers:
            assert got[l].shape == want[l].shape == (13, got[l].shape[1])
            np.testing.assert_allclose(got[l], want[l], rtol=1e-4,
                                       atol=1e-5 * np.abs(want[l]).max())


SMALL = {"bert_layers": 2, "model_config": {
    "name": "clip_custom", "temperature": 0.07,
    "image_encoder": {"model_type": "cnn", "variant": "efficientnet-test", "in_channels": 1},
    "text_encoder": {"pooling": "eos"},
    "projection_head": {"name": "linear", "proj_dim": 32}}}


@pytest.fixture(scope="module")
def dissectors():
    """The small BreastClip dissector of both packages, the port's with the JAX weights."""
    from mammodissect.dissect.dissectors import get_dissector as jax_get_dissector
    from mammodissect_torch.convert import breastclip_from_jax
    from mammodissect_torch.dissect.dissectors import get_dissector

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # toy-vocab warning
        jd = jax_get_dissector("breastclip", image_shape=(64, 48, 1), **SMALL)
        pd_ = get_dissector("breastclip", device="cpu", **SMALL)
    pd_.module.load_state_dict(breastclip_from_jax(jax.tree.map(np.array, jd.variables)))
    return jd, pd_


def test_dissector_encoders_match_jax(dissectors):
    """BreastClip's image and text entry points of the staged path: pooled features,
    float and uint8 embeddings, text features."""
    jd, pd_ = dissectors
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, size=(3, 64, 48, 1), dtype=np.uint8)
    x = rng.normal(size=(3, 64, 48, 1)).astype(np.float32)
    toks = pd_.tokenize(CONCEPTS[:4], max_length=16)
    pairs = [(pd_.encode_image(x), jd.encode_image(x)),
             (pd_.embed_images(x), jd.embed_images(x)),
             (pd_.embed_images_u8(u8, 0.3, 0.25), jd.embed_images_u8(u8, 0.3, 0.25)),
             (pd_.encode_text(toks["input_ids"], toks["attention_mask"]),
              jd.encode_text(toks["input_ids"], toks["attention_mask"]))]
    for got, want in pairs:
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_fused_staged_path_matches_jax(tmp_path, dissectors):
    """target = dissector = breastclip with resident=False: the fused stages 1-2."""
    from mammodissect.data.probes import ArrayProbe as JaxArrayProbe
    from mammodissect_torch.data.probes import ArrayProbe

    jd, pd_ = dissectors
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(19, 64, 48, 1), dtype=np.uint8)
    images[15:] = images[:4]  # repeated images: exact activation ties
    kw = dict(target_model="breastclip", clip_model="breastclip",
              target_layers=[f"blocks.{i}" for i in range(7)], d_probe="synthetic_u8",
              concept_set="tests/assets/tiny_concepts.txt", batch_size=8,
              num_top_concepts=3, num_top_images=4)
    _, jpath = jax_run_dissection(
        JaxDissectConfig(activation_dir=str(tmp_path / "ja"), result_dir=str(tmp_path / "jr"),
                         **kw), probe=JaxArrayProbe(images, mean=0.3, std=0.25), dissector=jd,
        log=lambda *_: None)
    logs = []
    _, path = run_dissection(
        DissectConfig(device="cpu", activation_dir=str(tmp_path / "pa"),
                      result_dir=str(tmp_path / "pr"), **kw),
        probe=ArrayProbe(images, mean=0.3, std=0.25), dissector=pd_, log=logs.append)
    assert any(l.startswith("[fused] harvested 7 layers + embedded 19 images") for l in logs), logs
    _assert_agree(path, jpath)


def test_resident_with_another_target_falls_back_to_staged(tmp_path):
    kw = _golden_kw(tmp_path)
    _, pt = _tiny_cnn_targets()
    logs = []
    df, _ = run_dissection(
        DissectConfig(device="cpu", resident=True, activation_dir=str(tmp_path / "a"),
                      result_dir=str(tmp_path / "r"), **kw), target=pt, log=logs.append)
    assert logs[0] == "[resident] not applicable (non-fused target/probe); using the staged path"
    assert any(l.startswith("[harvest] 32 images") for l in logs), logs
    assert len(df) == 56


@pytest.mark.parametrize("shape", [(5, 64, 64, 1), (3, 37, 29, 3), (16, 64, 48, 1)])
def test_random_dissector_matches_jax(shape):
    from mammodissect.dissect.dissectors import get_dissector as jax_get_dissector
    from mammodissect_torch.dissect.dissectors import get_dissector

    images = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    jd, pd_ = jax_get_dissector("random", seed=3), get_dissector("random", seed=3, device="cpu")
    np.testing.assert_array_equal(pd_.embed_images(images), jd.embed_images(images))
    np.testing.assert_array_equal(pd_.embed_texts(CONCEPTS), jd.embed_texts(CONCEPTS))
