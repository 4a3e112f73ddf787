"""The slice as a whole: the resident M-dissect through both packages' `run_dissection`
on one tiny probe (efficientnet-test tower, 2-layer BERT, the tiny concept set) with
the same weights, float32 on the CPU. The CSVs must agree on >= 99% of per-unit
top-1 concepts (exact at f32 is expected) and list the same top images. Also the
port's chunk spill and resume, its CLI on the CPU, the paths it took over from the
JAX package in later slices, and what it still refuses."""
import json
import os
import warnings

import jax
import numpy as np
import pandas as pd
import pytest

from mammodissect.dissect.dissectors import get_dissector as jax_get_dissector
from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
from mammodissect.dissect.engine import run_dissection as jax_run_dissection
from mammodissect_torch.convert import breastclip_from_jax
from mammodissect_torch.data.probes import ArrayProbe
from mammodissect_torch.dissect.dissectors import get_dissector
from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

SMALL = {"bert_layers": 2, "model_config": {
    "name": "clip_custom", "temperature": 0.07,
    "image_encoder": {"model_type": "cnn", "variant": "efficientnet-test", "in_channels": 1},
    "text_encoder": {"pooling": "eos"},
    "projection_head": {"name": "linear", "proj_dim": 32}}}
LAYERS = [f"blocks.{i}" for i in range(7)]


def _base(**kw):
    return dict(target_model="breastclip", clip_model="breastclip", target_layers=LAYERS,
                d_probe="synthetic_u8", concept_set="tests/assets/tiny_concepts.txt",
                batch_size=8, num_top_concepts=3, num_top_images=4, resident=True, **kw)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(20, 64, 48, 1), dtype=np.uint8)
    images[16:] = images[:4]  # repeated images: exact activation ties
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # toy-vocab warning
        jd = jax_get_dissector("breastclip", image_shape=(64, 48, 1), **SMALL)
        pd_ = get_dissector("breastclip", device="cpu", **SMALL)
    pd_.module.load_state_dict(breastclip_from_jax(jax.tree.map(np.array, jd.variables)))
    return images, jd, pd_


def _agreement(a, b):
    top_a = [row[0] for row in a["description"]]
    top_b = [row[0] for row in b["description"]]
    return np.mean([x == y for x, y in zip(top_a, top_b)])


def test_resident_csv_matches_jax(setup, tmp_path):
    from mammodissect.data.probes import ArrayProbe as JaxArrayProbe

    images, jd, pd_ = setup
    jcfg = JaxDissectConfig(activation_dir=str(tmp_path / "ja"), result_dir=str(tmp_path / "jr"),
                            wire_pack="off", **_base())
    jdf, jpath = jax_run_dissection(jcfg, probe=JaxArrayProbe(images, mean=0.3, std=0.25),
                                    dissector=jd, log=lambda *_: None)
    cfg = DissectConfig(activation_dir=str(tmp_path / "pa"), result_dir=str(tmp_path / "pr"),
                        device="cpu", **_base())
    logs = []
    df, path = run_dissection(cfg, probe=ArrayProbe(images, mean=0.3, std=0.25), dissector=pd_,
                              log=logs.append)
    assert any("[resident] dissected 20 images" in l for l in logs), logs
    # the CSVs as written, read back
    jdf, df = pd.read_csv(jpath), pd.read_csv(path)
    assert list(df["layer"]) == list(jdf["layer"]) and len(df) == 280
    assert _agreement(df, jdf) >= 0.99
    assert list(df["images"]) == list(jdf["images"])
    sim, jsim = (np.array([json.loads(s) for s in d["similarity"]]) for d in (df, jdf))
    assert np.isfinite(sim).all()
    np.testing.assert_allclose(sim, jsim, rtol=1e-4, atol=1e-4 * np.abs(jsim).max())


def test_resident_resume_reuses_spilled_chunks(setup, tmp_path):
    images, _, pd_ = setup
    probe = ArrayProbe(images, mean=0.3, std=0.25)
    cfg = DissectConfig(activation_dir=str(tmp_path / "a"), result_dir=str(tmp_path / "r"),
                        device="cpu", **_base())
    first, _ = run_dissection(cfg, probe=probe, dissector=pd_, log=lambda *_: None)
    assert any(f.endswith("_partial.npz") for f in os.listdir(tmp_path / "a"))
    logs = []
    again, _ = run_dissection(cfg, probe=probe, dissector=pd_, log=logs.append)
    assert any("[resident] resumed" in l for l in logs), logs
    pd.testing.assert_frame_equal(first, again)


def test_cli_runs_on_cpu(tmp_path, capsys):
    from mammodissect_torch.cli.dissect import main

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(["--target_model", "breastclip", "--clip_model", "breastclip",
                   "--target_layers", "image_encoder._blocks[2],blocks.5", "--resident",
                   "--d_probe", "synthetic_u8", "--batch_size", "4",
                   "--probe_kwargs", json.dumps({"n": 6, "h": 40, "w": 32}),
                   "--dissector_kwargs", json.dumps(SMALL),
                   "--concept_set", "tests/assets/tiny_concepts.txt", "--device", "cpu",
                   "--activation_dir", str(tmp_path / "a"), "--result_dir", str(tmp_path / "r")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Dissection done! 80 units described" in out  # 16 + 64 units


def test_cli_staged_on_cpu(tmp_path, capsys):
    """The CLI's staged path with the test target and the random dissector; a rerun
    reads the cache."""
    from mammodissect_torch.cli.dissect import main

    argv = ["--target_model", "tiny_cnn", "--clip_model", "random",
            "--target_layers", "blocks.0,image_encoder._blocks[3]", "--d_probe", "synthetic_u8",
            "--batch_size", "4", "--probe_kwargs", json.dumps({"n": 6, "h": 40, "w": 32}),
            "--concept_set", "tests/assets/tiny_concepts.txt", "--device", "cpu",
            "--wire_pack", "auto", "--activation_dir", str(tmp_path / "a"),
            "--result_dir", str(tmp_path / "r")]
    assert main(argv) == 0
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert out.count("Dissection done! 56 units described") == 2  # 16 + 40 units
    assert "[harvest] 6 images x 2 layers" in out
    assert "[harvest] all target activations cached, skipping" in out


@pytest.mark.parametrize("change,log", [
    ({"resident": False}, "[fused] harvested 7 layers + embedded 20 images"),
    ({"wire_pack": "on"}, "[resident] packed uint8 wire"),
    ({"target_model": "tiny_cnn"}, "[resident] not applicable"),
])
def test_formerly_refused_paths_run(setup, tmp_path, change, log):
    """The staged path, the packed wire and another target, which the port refused
    before they were ported: they run, and say which path they took."""
    images, _, pd_ = setup
    kw = _base()
    kw.update(change)
    cfg = DissectConfig(activation_dir=str(tmp_path / "a"), result_dir=str(tmp_path / "r"),
                        device="cpu", **kw)
    logs = []
    df, _ = run_dissection(cfg, probe=ArrayProbe(images, mean=0.3, std=0.25), dissector=pd_,
                           log=logs.append)
    assert any(l.startswith(log) for l in logs), logs
    assert len(df) == (280 if kw["target_model"] == "breastclip" else 304)  # B0 blocks 0-6
    assert np.isfinite(np.array([row for row in df["similarity"]])).all()


@pytest.mark.parametrize("arch", ["upmc_breast_clip_efficientnetv2-s_ft",
                                  "upmc_breast_clip_det_v2_ft"])
def test_v2_archs_resolve_to_a_v2_target(arch):
    """Both spellings of the EfficientNetV2 classifier arch, which the port refused
    before FusedMBConv was ported, resolve to a 40-block V2-S classifier target on
    the CPU whose harvest gives every block (tests/test_torch_efficientnet_v2.py
    holds it to the JAX package)."""
    from mammodissect_torch.dissect.targets import get_target_model
    from mammodissect_torch.models.efficientnet import FusedMBConvBlock

    target = get_target_model("breastclip_classifier", arch=arch, device="cpu")
    blocks = target.model.image_encoder._blocks
    assert len(blocks) == 40 and sum(isinstance(b, FusedMBConvBlock) for b in blocks) == 10
    layers = [f"blocks.{i}" for i in range(40)]
    images = np.random.default_rng(0).normal(size=(2, 32, 32, 1)).astype(np.float32)
    out = target.harvest(images, layers)
    assert list(out) == layers and out["blocks.39"].shape == (2, 256)
    assert all(np.isfinite(v).all() for v in out.values())


@pytest.mark.parametrize("change,match", [
    ({"target_model": "breastclip_classifier", "finetuned_ckpt": "<dir>"}, "orbax"),
])
def test_unported_paths_raise(setup, tmp_path, change, match):
    """What the port still refuses: the JAX trainer's orbax checkpoints (fine-tuning).
    The EfficientNetV2 archs it refused before resolve now
    (`test_v2_archs_resolve_to_a_v2_target`); the target zoo is held to the JAX
    package by tests/test_torch_zoo.py."""
    images, _, _ = setup
    kw = _base()
    kw.update(change)
    if kw.get("finetuned_ckpt") == "<dir>":
        kw["finetuned_ckpt"] = str(tmp_path)
    cfg = DissectConfig(activation_dir=str(tmp_path / "a"), result_dir=str(tmp_path / "r"),
                        device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=match):
        run_dissection(cfg, probe=ArrayProbe(images, mean=0.3, std=0.25), log=lambda *_: None)
