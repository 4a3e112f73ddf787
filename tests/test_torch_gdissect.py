"""G-dissect and zero-shot evaluation, the slice as a whole: `run_dissection` with a
narrow CLIP ViT as target and dissector through both packages on one probe with the
same weights (float32, CPU) must give identical top-1 concepts and top images and
similarities within 1e-4; the dissect CLI with the reference spellings, `--naming
og` and `--num_top_concepts 1`; a `clip_rn*` target reusing the dissector's caches;
zero-shot scores, retrieval metrics and description similarities against the JAX
package; the zero-shot CLI on the CPU."""
import json
import warnings

import jax
import numpy as np
import pandas as pd
import pytest

from mammodissect.data.probes import ArrayProbe as JaxArrayProbe
from mammodissect.dissect import evalmetrics as jax_evalmetrics
from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
from mammodissect.dissect.engine import run_dissection as jax_run_dissection
from mammodissect.models.clip_vit import OpenAIClip as JaxOpenAIClip
from mammodissect.zs import retrieval as jax_retrieval
from mammodissect.zs import zero_shot_scores as jax_zero_shot_scores
from mammodissect_torch.convert import clip_from_jax
from mammodissect_torch.data.probes import ArrayProbe
from mammodissect_torch.dissect import evalmetrics
from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
from mammodissect_torch.models.clip_vit import OpenAIClip
from mammodissect_torch.zs import retrieval, zero_shot_eval, zero_shot_scores

TINY = dict(vision_width=32, vision_layers=3, vision_heads=2, text_width=32, text_layers=2,
            text_heads=2, embed_dim=16, image_size=32)
CONCEPTS = "tests/assets/tiny_concepts.txt"
LAYERS = ["layers.0", "layers.1", "layers.2"]


@pytest.fixture(scope="module")
def setup():
    images = np.random.default_rng(0).normal(size=(20, 32, 32, 3)).astype(np.float32)
    jc = JaxOpenAIClip("ViT-B/16", **TINY)
    pc = OpenAIClip("ViT-B/16", device="cpu", **TINY)
    pc.module.load_state_dict(clip_from_jax(jax.tree.map(np.array, jc.variables)))
    return images, jc, pc


def _base(**kw):
    return dict(target_model="ViT-B/16", clip_model="ViT-B/16", target_layers=LAYERS,
                d_probe="synthetic", concept_set=CONCEPTS, batch_size=8, num_top_concepts=3,
                num_top_images=4, **kw)


def _similarities(df):
    return np.array([json.loads(s) if isinstance(s, str) else s for s in df["similarity"]])


def test_gdissect_csv_matches_jax(setup, tmp_path):
    images, jc, pc = setup
    # the JAX package's staged path cannot write a cache file for a target name with
    # a "/" (it names a directory that does not exist): its run takes "clip", the
    # same tower under another name
    jcfg = JaxDissectConfig(activation_dir=str(tmp_path / "ja"), result_dir=str(tmp_path / "jr"),
                            **{**_base(), "target_model": "clip"})
    _, jpath = jax_run_dissection(jcfg, probe=JaxArrayProbe(images), target=jc, dissector=jc,
                                  log=lambda *_: None)
    cfg = DissectConfig(activation_dir=str(tmp_path / "pa"), result_dir=str(tmp_path / "pr"),
                        device="cpu", **_base())
    logs = []
    _, path = run_dissection(cfg, probe=ArrayProbe(images), target=pc, dissector=pc,
                             log=logs.append)
    assert any(l.startswith("[harvest] 20 images x 3 layers") for l in logs), logs
    assert any(l.startswith("[scoring] 96 units x 10 concepts") for l in logs), logs
    jdf, df = pd.read_csv(jpath), pd.read_csv(path)
    assert list(df["layer"]) == list(jdf["layer"]) and len(df) == 96
    assert [json.loads(d.replace("'", '"'))[0] for d in df["description"]] == \
        [json.loads(d.replace("'", '"'))[0] for d in jdf["description"]]
    assert list(df["images"]) == list(jdf["images"])
    sim, jsim = _similarities(df), _similarities(jdf)
    assert np.isfinite(sim).all()
    np.testing.assert_allclose(sim, jsim, rtol=0, atol=1e-4 * np.abs(jsim).max())
    # the caches carry the reference's names, "/" stripped from the CLIP name
    assert (tmp_path / "pa" / "synthetic_ViT-B16_layers.0.npy").exists()
    assert (tmp_path / "pa" / "synthetic_ViT-B16.npy").exists()
    assert (tmp_path / "pa" / "tiny_concepts_ViT-B16.npy").exists()


def test_clip_rn_target_reuses_the_dissector_caches(setup, tmp_path):
    """A second run on the same probe and activation dir with another target harvests
    only the target: the dissector's image and text caches are read, not recomputed."""
    images, _, pc = setup
    probe = ArrayProbe(images)
    first = DissectConfig(activation_dir=str(tmp_path / "a"), result_dir=str(tmp_path / "r"),
                          device="cpu", **_base())
    run_dissection(first, probe=probe, target=pc, dissector=pc, log=lambda *_: None)
    second = DissectConfig(**{**first.__dict__, "target_model": "clip_rn50",
                              "target_layers": ["conv1", "layer1", "layer2", "layer3", "layer4"],
                              "target_kwargs": {"input_size": 32}})
    logs = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # num_class is dropped, loudly
        df, _ = run_dissection(second, probe=probe, log=logs.append)
    assert any(l.startswith("[harvest] 20 images x 5 layers") for l in logs), logs
    assert "[clip-img] probe embeddings cached, skipping" in logs
    assert not any(l.startswith("[clip-txt]") for l in logs), logs
    assert len(df) == 64 + 256 + 512 + 1024 + 2048
    assert np.isfinite(_similarities(df)).all()


def _cli_argv(tmp_path, *extra):
    return ["--target_model", "ViT-B/16", "--clip_model", "ViT-B/16",
            "--target_layers", "vision_model.encoder.layers[0],layers.2", "--d_probe", "synthetic",
            "--probe_kwargs", json.dumps({"n": 24, "h": 32, "w": 32, "c": 3}),
            "--target_kwargs", json.dumps(TINY), "--dissector_kwargs", json.dumps(TINY),
            "--concept_set", CONCEPTS, "--batch_size", "8", "--device", "cpu",
            "--activation_dir", str(tmp_path / "a"), "--result_dir", str(tmp_path / "r"), *extra]


@pytest.mark.parametrize("extra,stem,n_concepts", [
    ((), "synthetic_not_mammo_pretrained_ViT-B16_descriptions", 10),
    (("--naming", "og"), "clip_dissector_vindr_not_mammo_pretrained_breast_clip_descriptions", 10),
    (("--num_top_concepts", "1"), "synthetic_not_mammo_pretrained_ViT-B16_descriptions", 1),
])
def test_cli_gdissect_on_cpu(tmp_path, capsys, extra, stem, n_concepts):
    """The reference spellings (`run_og_clip.sh:8`), `describe_og_neurons.py`'s file
    names and `describe_clip_neurons.py`'s single concept per unit."""
    from mammodissect_torch.cli.dissect import main

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert main(_cli_argv(tmp_path, *extra)) == 0
    assert "Dissection done! 64 units described" in capsys.readouterr().out
    csvs = list((tmp_path / "r").rglob("*.csv"))
    assert len(csvs) == 1 and str(csvs[0]).endswith(stem + ".csv"), csvs
    df = pd.read_csv(csvs[0])
    assert sorted(set(df["layer"])) == ["layers.0", "layers.2"]
    assert {len(json.loads(d.replace("'", '"'))) for d in df["description"]} == {n_concepts}


class FakeDissector:
    """Seeded numpy embeddings: images through a fixed projection, texts by hash."""

    def __init__(self, dim=8):
        self.proj = np.random.default_rng(1).normal(size=(4 * 4 * 3, dim)).astype(np.float32)

    def embed_images(self, images):
        e = np.asarray(images, np.float32)[:, ::8, ::8].reshape(len(images), -1) @ self.proj
        return e / np.clip(np.linalg.norm(e, axis=1, keepdims=True), 1e-12, None)

    def embed_texts(self, texts):
        e = np.stack([np.random.default_rng(sum(map(ord, t))).normal(size=self.proj.shape[1])
                      for t in texts]).astype(np.float32)
        return e / np.linalg.norm(e, axis=1, keepdims=True)


PROMPTS = {"Mass": {"pos": ["there is a mass", "a mass is seen"], "neg": ["no mass"]},
           "Calc": {"pos": ["calcifications"], "neg": ["no calcifications", "clear"]}}


@pytest.mark.parametrize("dissector", ["fake", "clip"])
def test_zero_shot_scores_match_jax(setup, dissector):
    images, jc, pc = setup
    fake = FakeDissector()
    jd, d = (fake, fake) if dissector == "fake" else (jc, pc)
    for prompts in (None, PROMPTS):
        want = jax_zero_shot_scores(jd, JaxArrayProbe(images), prompts, batch_size=6)
        got = zero_shot_scores(d, ArrayProbe(images), prompts, batch_size=6)
        assert sorted(got) == sorted(want)
        for task in want:
            np.testing.assert_allclose(got[task], want[task], rtol=1e-4, atol=1e-5)
    labels = {"Mass": np.arange(20) % 2, "Calc": (np.arange(20) % 3 == 0).astype(float)}
    result = zero_shot_eval(d, ArrayProbe(images), labels, PROMPTS, batch_size=6)
    assert sorted(result) == ["Calc", "Mass"]
    assert all(np.isfinite(v) for r in result.values() for v in r.values())


def test_retrieval_metrics_match_jax(setup):
    images, _, _ = setup
    fake = FakeDissector()
    texts = [f"report {i}" for i in range(len(images))]
    dataset = [{"image": im, "text": t} for im, t in zip(images, texts)]
    want = jax_retrieval.evaluate_retrieval(fake, dataset, batch_size=6, ks=(1, 3, 5))
    assert retrieval.evaluate_retrieval(fake, dataset, batch_size=6, ks=(1, 3, 5)) == want
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(2, 30, 8)).astype(np.float32)
    assert retrieval.retrieval_metrics(a, b) == jax_retrieval.retrieval_metrics(a, b)


def test_description_similarity_matches_jax(setup):
    _, jc, pc = setup
    pred = ["mass", "calcification", "fat", "skin"]
    gt = ["mass", "calcifications", "fatty tissue", "nipple"]
    want = jax_evalmetrics.description_cos_similarity(pred, gt, jc.embed_texts)
    got = evalmetrics.description_cos_similarity(pred, gt, pc.embed_texts)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert got[0] == pytest.approx(1.0, abs=1e-6)
    assert (evalmetrics.get_cos_similarity(pred, gt, pc.embed_texts, FakeDissector().embed_texts)
            == (pytest.approx(float(np.mean(got))), pytest.approx(
                jax_evalmetrics.mean_description_similarity(pred, gt, FakeDissector().embed_texts))))
    with pytest.warns(UserWarning, match="RANDOM-INIT"):
        embed = evalmetrics.default_text_embedder("clip", device="cpu", **TINY)
    assert embed(["mass"]).shape == (1, 16)
    with pytest.raises(KeyError):
        evalmetrics.default_text_embedder("mpnet", ckpt_path="x")


def _rgb_folder(root, n=12, hw=32):
    from PIL import Image

    rng = np.random.default_rng(3)
    for i in range(n):
        d = root / ("0_neg" if i % 2 == 0 else "1_pos")
        d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, size=(hw, hw, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return root


def test_zseval_cli_on_cpu(tmp_path):
    from mammodissect_torch.cli.zseval import main

    root = _rgb_folder(tmp_path / "probe")
    out = tmp_path / "zs.json"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(["--clip_model", "ViT-B/16", "--d_probe", f"folder:{root}",
                   "--probe_kwargs", json.dumps({"image_shape": [32, 32, 3]}),
                   "--dissector_kwargs", json.dumps(TINY), "--tasks", "Mass",
                   "--batch_size", "5", "--device", "cpu", "--output", str(out)])
    assert rc == 0
    result = json.loads(out.read_text())
    assert sorted(result) == ["Mass"] and np.isfinite(result["Mass"]["auroc"])


@pytest.mark.parametrize("deterministic", [True, False])
def test_report_generation_matches_jax(deterministic):
    """`generate_report_from_labels` with an explicit Generator: the same report as the
    JAX package's from the same seed ('No Finding' suppresses the negatives)."""
    from mammodissect.data.prompts import generate_report_from_labels as jax_report
    from mammodissect_torch.data.prompts import default_zs_prompts, generate_report_from_labels

    with open("mammodissect/assets/dataset/prompts.json") as f:
        prompts = json.load(f)
    for findings in ([["Mass"], ["Suspicious Calcification"], ["Global Asymmetry"], ["Mass"]],
                     [["No Finding"], [], ["Mass"], ["Mass"]]):
        got = generate_report_from_labels(findings, prompts, deterministic,
                                          np.random.default_rng(7))
        want = jax_report(findings, prompts, deterministic, np.random.default_rng(7))
        assert got == want and got
    assert sorted(default_zs_prompts()) == ["Mass", "Suspicious_Calcification"]
