"""The CIFAR-100 probes (`cifar100_train`, `cifar100_val`) of the PyTorch port against
the JAX package's, with a seeded stand-in for `torchvision.datasets.CIFAR100` (no
CIFAR-100 files or torchvision are needed): the same images bit for bit and the same
labels, `ModuleNotFoundError` without torchvision, and a G-dissect that resolves the
probe by name through both packages' `run_dissection` on the same weights."""
import json
import sys
import types
import warnings

import flax.errors
import jax
import numpy as np
import pandas as pd
import pytest

import mammodissect.data.probes as J
import mammodissect_torch.data.probes as P
from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
from mammodissect.dissect.engine import run_dissection as jax_run_dissection
from mammodissect.models.clip_vit import OpenAIClip as JaxOpenAIClip
from mammodissect_torch.convert import clip_from_jax
from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
from mammodissect_torch.models.clip_vit import OpenAIClip

NAMES = ("cifar100_train", "cifar100_val")
N_IMAGES = 24
# tests/test_torch_gdissect.py's narrow CLIP, at CIFAR's 32x32
TINY = dict(vision_width=32, vision_layers=3, vision_heads=2, text_width=32, text_layers=2,
            text_heads=2, embed_dim=16, image_size=32)
CONCEPTS = "tests/assets/tiny_concepts.txt"
LAYERS = ["layers.0", "layers.1", "layers.2"]
AT_224 = {k: v for k, v in TINY.items() if k != "image_size"}  # the default, 224


def stand_in_torchvision(n=N_IMAGES, seed=0):
    """A `torchvision` module whose `datasets.CIFAR100` returns seeded uint8 `data`
    [n, 32, 32, 3] and `targets` in [0, 100) (one split a seed), and records each
    call's (root, train, download)."""
    calls = []

    class CIFAR100:
        def __init__(self, root, train=True, download=False):
            calls.append({"root": root, "train": train, "download": download})
            rng = np.random.default_rng(seed + int(train))
            self.data = rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
            self.targets = [int(t) for t in rng.integers(0, 100, size=n)]

    tv = types.ModuleType("torchvision")
    tv.datasets = types.SimpleNamespace(CIFAR100=CIFAR100)
    return tv, calls


@pytest.fixture
def torchvision(monkeypatch):
    tv, calls = stand_in_torchvision()
    monkeypatch.setitem(sys.modules, "torchvision", tv)
    return calls


@pytest.mark.parametrize("name", NAMES)
def test_cifar_probe_needs_torchvision(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "torchvision", None)
    for pkg in (J, P):
        with pytest.raises(ModuleNotFoundError, match="torchvision"):
            pkg.get_probe(name, data_root="/nonexistent")


@pytest.mark.parametrize("name", NAMES)
def test_cifar_probe_matches_jax(torchvision, tmp_path, name):
    root = str(tmp_path / "cifar")
    jp, pp = J.get_probe(name, data_root=root), P.get_probe(name, data_root=root)
    want = {"root": root, "train": name.endswith("train"), "download": False}
    assert torchvision == [want, want]
    assert len(pp) == len(jp) == N_IMAGES
    assert pp.image_shape == jp.image_shape == (32, 32, 3)
    for i in range(N_IMAGES):
        assert pp.image(i).dtype == np.float32
        np.testing.assert_array_equal(pp.image(i), jp.image(i))
        assert pp.label(i) == jp.label(i)
    # the ImageNet normalization of x / 255, not the uint8 path's min-max
    u8 = sys.modules["torchvision"].datasets.CIFAR100(root, name.endswith("train")).data
    x = u8[0].astype(np.float32) / 255.0
    np.testing.assert_allclose(pp.image(0), (x - [0.485, 0.456, 0.406]) / [0.229, 0.224, 0.225],
                               rtol=1e-6, atol=1e-6)


def test_cifar_probes_listed():
    for name in NAMES:
        assert name in P.PROBES and name in J.PROBES
    assert P.PROBES.index("cifar100_train") + 1 == P.PROBES.index("cifar100_val")


@pytest.fixture(scope="module")
def clips():
    """The narrow CLIP at image_size 32 in both packages, the same weights."""
    jc = JaxOpenAIClip("ViT-B/16", **TINY)
    pc = OpenAIClip("ViT-B/16", device="cpu", **TINY)
    pc.module.load_state_dict(clip_from_jax(jax.tree.map(np.array, jc.variables)))
    return jc, pc


def _base(tmp_path, tag, **kw):
    return dict(clip_model="ViT-B/16", target_layers=LAYERS, d_probe="cifar100_val",
                probe_kwargs={"data_root": str(tmp_path / "cifar")}, concept_set=CONCEPTS,
                batch_size=8, num_top_concepts=3, num_top_images=4,
                activation_dir=str(tmp_path / f"{tag}a"), result_dir=str(tmp_path / f"{tag}r"),
                **kw)


def _similarities(df):
    return np.array([json.loads(s) if isinstance(s, str) else s for s in df["similarity"]])


def test_cifar_gdissect_csv_matches_jax(torchvision, clips, tmp_path):
    """The probe resolved by name (`probe=None`) in both packages' staged engines."""
    jc, pc = clips
    # the JAX package's staged path cannot cache a target named with a "/": its run
    # takes "clip", the same tower under another name
    jcfg = JaxDissectConfig(target_model="clip", **_base(tmp_path, "j"))
    _, jpath = jax_run_dissection(jcfg, target=jc, dissector=jc, log=lambda *_: None)
    cfg = DissectConfig(target_model="ViT-B/16", device="cpu", **_base(tmp_path, "p"))
    logs = []
    _, path = run_dissection(cfg, target=pc, dissector=pc, log=logs.append)
    assert any(l.startswith(f"[harvest] {N_IMAGES} images x 3 layers") for l in logs), logs
    assert all(c["train"] is False and c["download"] is False for c in torchvision)
    jdf, df = pd.read_csv(jpath), pd.read_csv(path)
    assert list(df["layer"]) == list(jdf["layer"]) and len(df) == 96
    assert [json.loads(d.replace("'", '"'))[0] for d in df["description"]] == \
        [json.loads(d.replace("'", '"'))[0] for d in jdf["description"]]
    assert list(df["images"]) == list(jdf["images"])
    sim, jsim = _similarities(df), _similarities(jdf)
    assert np.isfinite(sim).all()
    np.testing.assert_allclose(sim, jsim, rtol=0, atol=1e-4 * np.abs(jsim).max())
    assert (tmp_path / "pa" / "cifar100_val_ViT-B16_layers.0.npy").exists()


def test_cifar_probe_needs_a_tower_of_its_size(torchvision, tmp_path):
    """Neither package resizes CIFAR's 32x32 images: a tower built for 224 (its
    positional table has 197 rows, the probe gives 5 tokens) raises in both, flax's
    ScopeParamShapeError in JAX, the port's ValueError."""
    jc = JaxOpenAIClip("ViT-B/16", **AT_224)
    pc = OpenAIClip("ViT-B/16", device="cpu", **AT_224)
    jcfg = JaxDissectConfig(target_model="clip", **_base(tmp_path, "j"))
    with warnings.catch_warnings(), pytest.raises(flax.errors.ScopeParamShapeError):
        warnings.simplefilter("ignore")
        jax_run_dissection(jcfg, target=jc, dissector=jc, log=lambda *_: None)
    cfg = DissectConfig(target_model="ViT-B/16", device="cpu", **_base(tmp_path, "p"))
    with pytest.raises(ValueError, match="positional table of image_size 224"):
        run_dissection(cfg, target=pc, dissector=pc, log=lambda *_: None)


def test_cli_dissects_cifar_by_name(torchvision, tmp_path, capsys):
    from mammodissect_torch.cli.dissect import main

    kw = json.dumps(TINY)
    argv = ["--target_model", "ViT-B/16", "--clip_model", "ViT-B/16", "--target_layers",
            ",".join(LAYERS), "--d_probe", "cifar100_val", "--probe_kwargs",
            json.dumps({"data_root": str(tmp_path / "cifar")}), "--target_kwargs", kw,
            "--dissector_kwargs", kw, "--concept_set", CONCEPTS, "--batch_size", "8",
            "--device", "cpu", "--activation_dir", str(tmp_path / "a"),
            "--result_dir", str(tmp_path / "r")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert main(argv) == 0
    assert "Dissection done! 96 units described" in capsys.readouterr().out
    assert torchvision and all(c == {"root": str(tmp_path / "cifar"), "train": False,
                                     "download": False} for c in torchvision)
    csvs = list((tmp_path / "r").rglob("*.csv"))
    assert len(csvs) == 1 and "cifar100_val" in csvs[0].name, csvs
    assert np.isfinite(_similarities(pd.read_csv(csvs[0]))).all()
