"""The rest of the EfficientNet family in the PyTorch port against the JAX package,
on the CPU: the EfficientNetV2-S tower (FusedMBConv blocks, always true SAME), its
training-mode forward and drop-connect, the space-to-depth stem, MammoEfficientNet
and the staged C-dissect of a V2 classifier. The JAX weights are carried across by
`convert.py`; JAX's variables are drawn from their shapes (`jax.eval_shape`), which
spares the 16 s compile of a V2 `init`."""
import ast
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mammodissect.models.classifier import BreastClipClassifierModule as JaxClassifier
from mammodissect.models.classifier import MammoEfficientNetModule as JaxMammoEfficientNet
from mammodissect.models.efficientnet import EfficientNet as JaxEfficientNet
from mammodissect.models.efficientnet import StemConv as JaxStemConv
from mammodissect_torch.convert import (
    classifier_from_jax,
    efficientnet_from_jax,
    mammo_efficientnet_from_jax,
)
from mammodissect_torch.models.classifier import MammoEfficientNetModule
from mammodissect_torch.models.efficientnet import (
    EfficientNet,
    FusedMBConvBlock,
    MBConvBlock,
    v2_block_args,
)

V2 = "efficientnetv2-s"
V2_ARCHS = ("upmc_breast_clip_efficientnetv2-s_ft", "upmc_breast_clip_det_v2_ft")


def _random_variables(module, x, seed):
    """Variables of `module` for input `x`, drawn from their shapes: unit-preserving
    kernels (std 1/sqrt(fan_in)), BN scales and variances in [0.5, 1.5], biases and
    means ~0.1, GeM's p at 3 (the default init shrinks activations by orders of
    magnitude over 40 blocks, which would make any tolerance vacuous)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "p":
            return np.full(leaf.shape, 3.0, np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


@pytest.fixture(scope="module")
def v2_classifier():
    """The JAX V2-S classifier (3-channel encoder, fp32) and its random variables."""
    module = JaxClassifier(variant=V2)
    return module, _random_variables(module, jnp.ones((1, 64, 64, 1)), seed=0)


def _backbone(variables):
    return {"params": variables["params"]["image_encoder"]["backbone"],
            "batch_stats": variables["batch_stats"]["image_encoder"]["backbone"]}


def test_v2_block_table():
    """40 blocks, the first 10 FusedMBConv, and 28 stride-1 expanded MBConv blocks:
    the blocks whose front half kernel 2 runs in inference."""
    blocks = v2_block_args()
    assert len(blocks) == 40 and [b.fused for b in blocks] == [True] * 10 + [False] * 30
    model = EfficientNet(V2, in_channels=3)
    assert [type(b) for b in model._blocks] == [FusedMBConvBlock] * 10 + [MBConvBlock] * 30
    fronts = [(b.args.input_filters, b.args.input_filters * b.args.expand_ratio)
              for b in model._blocks if b.fused_front]
    assert len(fronts) == 28
    assert sorted(set(fronts)) == [(128, 512), (128, 768), (160, 960), (256, 1536)]
    assert model.out_dim == 1280 and model._conv_stem.out_channels == 24
    assert model.pad_mode == "same"  # V2 is always true SAME
    names = set(model.state_dict())
    assert {"_blocks.0._project_conv.weight", "_blocks.0._bn2.weight",
            "_blocks.2._expand_conv.weight", "_blocks.2._bn0.running_var",
            "_blocks.2._project_conv.weight"} <= names
    assert "_blocks.0._expand_conv.weight" not in names
    assert not any(k.startswith("_blocks.9._depthwise") for k in names)


@pytest.mark.parametrize("channels", [1, 3])
def test_v2_tower_captures_match_jax(v2_classifier, channels):
    """The V2-S tower at 64x64, grayscale (broadcast to the tower's 3 channels) and
    3-channel input, in eval: every one of the 40 captured blocks and the head
    within 1e-4 of the largest entry of the JAX tower's, float32."""
    _, variables = v2_classifier
    jm = JaxEfficientNet(variant=V2, in_channels=3)
    v = _backbone(variables)
    x = np.random.default_rng(1).normal(size=(2, 64, 64, channels)).astype(np.float32)
    feats, cap = jax.jit(lambda v, x: jm.apply(v, x, capture=tuple(range(40))))(v, jnp.asarray(x))
    model = EfficientNet(V2, in_channels=3).eval()
    model.load_state_dict(efficientnet_from_jax(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got, captured = model(torch.from_numpy(x), capture=tuple(range(40)))
    assert sorted(captured, key=lambda k: int(k.split(".")[1])) == [f"blocks.{i}" for i in range(40)]
    for k, want in cap.items():
        assert _rel_err(captured[k].numpy(), want) <= 1e-4, k
    assert _rel_err(got.permute(0, 2, 3, 1).numpy(), feats) <= 1e-4


def test_v2_training_forward_matches_flax(v2_classifier):
    """One training-mode forward at 64x64, batch 4, bn_momentum 0.9, drop-connect rate
    0 (JAX's masks come from jax.random and cannot be replayed): the output and every
    updated running mean and variance against flax's mutable batch_stats. The last
    stage's maps are 2x2, where the unbiased variance would be 16/15 of flax's."""
    _, variables = v2_classifier
    jm = JaxEfficientNet(variant=V2, in_channels=3, drop_connect_rate=0.0, bn_momentum=0.9)
    v = _backbone(variables)
    x = np.random.default_rng(2).normal(size=(4, 64, 64, 1)).astype(np.float32)
    (feats, _), mutated = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                                        mutable=["batch_stats"]))(v, jnp.asarray(x))
    model = EfficientNet(V2, in_channels=3, drop_connect_rate=0.0, bn_momentum=0.9)
    model.load_state_dict(efficientnet_from_jax(v["params"], v["batch_stats"]))
    got, _ = model.train()(torch.from_numpy(x))
    assert _rel_err(got.permute(0, 2, 3, 1).detach().numpy(), feats) <= 1e-4
    want = efficientnet_from_jax(v["params"], mutated["batch_stats"])
    state = model.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    # every BatchNorm's pair: stem and head, 2 + 8 x 2 in the fused blocks, 30 x 3
    assert len(stats) == 2 * (2 + 2 + 8 * 2 + 30 * 3)
    for k in stats:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_v2_drop_connect_masks_with_and_without_remat():
    """The V2 tower (8 residual FusedMBConv blocks, drop-connect up to 0.2 * 39/40) in
    training mode with the same generator seed, with and without remat: the same loss,
    gradients and running statistics; another seed draws other masks. As
    tests/test_torch_train.py holds B0's; the recompute runs the same float32
    operations on the same inputs."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(4, 32, 32, 1)).astype(np.float32))
    state = EfficientNet(V2, in_channels=1).state_dict()
    runs = {}
    for name, remat, seed in (("plain", False, 7), ("remat", True, 7), ("other", False, 8)):
        model = EfficientNet(V2, in_channels=1, remat=remat)
        model.load_state_dict(state)
        features, _ = model.train()(x, generator=torch.Generator().manual_seed(seed))
        loss = features.square().mean()
        loss.backward()
        runs[name] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
                      {k: v for k, v in model.state_dict().items() if "running" in k})
    assert sum(b.residual for b in model._blocks if isinstance(b, FusedMBConvBlock)) == 8
    torch.testing.assert_close(runs["remat"][0], runs["plain"][0])
    for k, g in runs["plain"][1].items():
        torch.testing.assert_close(runs["remat"][1][k], g, msg=k)
    for k, v in runs["plain"][2].items():
        torch.testing.assert_close(runs["remat"][2][k], v, msg=k)
    assert not torch.allclose(runs["other"][0], runs["plain"][0])


@pytest.mark.parametrize("hw", [(64, 48), (63, 47)])
def test_s2d_stem_matches_the_plain_stem_and_jax(hw):
    """The port's stem (the plain 3x3/s2 conv, at the pad its tower computes) against
    JAX's StemConv with and without space-to-depth, within 1e-5, on the same
    canonical weight: even dims take JAX's s2d path, odd dims its plain fallback
    (as tests/test_efficientnet.py:101 holds JAX's). A config's
    `image_encoder.s2d_stem` builds the same tower as without it."""
    from mammodissect_torch.models.breastclip import BreastClip, default_model_config
    from mammodissect_torch.models.efficientnet import _pad

    h, w = hw
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, 3, 32)) / np.sqrt(27)).astype(np.float32)
    pad = tuple(((0, 1) if d % 2 == 0 else (1, 1)) for d in hw)  # TF-SAME, k3/s2
    jax_outs = [np.asarray(JaxStemConv(32, padding=pad, s2d=s2d).apply(
        {"params": {"kernel": kernel}}, jnp.asarray(x))) for s2d in (True, False)]
    tower = EfficientNet("efficientnet-b0", in_channels=3, pad_mode="same")
    stem_pad, _ = tower._paddings(hw)
    assert stem_pad == pad
    with torch.no_grad():
        tower._conv_stem.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        got = tower._conv_stem(_pad(xt, stem_pad)).permute(0, 2, 3, 1).numpy()
    for want in jax_outs:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    models = []
    for s2d in (False, True):
        cfg = default_model_config()
        cfg["image_encoder"].update(variant="efficientnet-test", s2d_stem=s2d)
        models.append(BreastClip.create(model_config=cfg, bert_layers=1, vocab_size=64,
                                        device="cpu").module.image_encoder)
    sds = [m.state_dict() for m in models]
    assert sds[0].keys() == sds[1].keys()
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])
    with torch.no_grad():
        outs = [m(torch.from_numpy(x))[0] for m in models]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("return_features", [False, True])
def test_mammo_efficientnet_matches_jax(return_features):
    """MammoEfficientNetModule (efficientnet-test backbone, GeM, single-logit fc) at
    64x48, grayscale, eval: logits and pooled features within 1e-4 of the largest
    entry of JAX's."""
    jm = JaxMammoEfficientNet(variant="efficientnet-test", return_features=return_features)
    x = np.random.default_rng(5).normal(size=(3, 64, 48, 1)).astype(np.float32)
    variables = _random_variables(jm, jnp.asarray(x), seed=6)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    model = MammoEfficientNetModule("efficientnet-test", return_features=return_features).eval()
    model.load_state_dict(mammo_efficientnet_from_jax(jax.tree.map(np.array, variables)))
    assert {k.split(".")[0] for k in model.state_dict()} == {"encoder", "fc"}
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    if return_features:
        (pooled, logits), (jpooled, jlogits) = got, want
        assert pooled.shape == (3, model.encoder.out_dim)
        assert _rel_err(pooled.numpy(), jpooled) <= 1e-4
    else:
        logits, jlogits = got, want
    assert logits.shape == (3, 1)
    assert _rel_err(logits.numpy(), jlogits) <= 1e-4


def _read(path):
    df = pd.read_csv(path)
    return df, np.array([json.loads(s) for s in df["similarity"]])


def _decided_layers(tmp_path, layers, top_k):
    """{layer: decided} from the two packages' activation caches. A layer is decided
    when every unit's top_k + 1 images are ranked apart by more than 4x the largest
    difference between the port's and JAX's activations of that unit: no rounding
    can then swap two of them. soft-WPMI weighs images by rank and normalizes each
    concept over the layer's units (log p(d)), so one swapped pair moves every
    similarity of its layer. Also holds each layer's activations to JAX's within
    1e-4 of the largest entry."""
    out = {}
    for layer in layers:
        name = f"synthetic_breastclip_classifier_{layer}.npy"
        want, got = np.load(tmp_path / "ja" / name), np.load(tmp_path / "pa" / name)
        assert _rel_err(got, want) <= 1e-4, layer
        err = np.abs(got - want).max(axis=0)
        gaps = -np.diff(-np.sort(-want, axis=0)[:top_k + 1], axis=0)
        out[layer] = bool((gaps.min(axis=0) > 4 * err).all())
    return out


# the layers whose image rankings a float32 rounding can swap with these weights and
# this probe (`_decided_layers`): deep blocks of a random tower vary little between
# noise images, so one or a few of their units rank two images within 4x the
# port-vs-JAX difference of their activations
UNDECIDED_V2_LAYERS = {10, 13, 19, 26, 29, 32, 33, 34, 35, 37, 38, 39}


def test_v2_c_dissect_csv_matches_jax(v2_classifier, tmp_path):
    """The staged C-dissect of a V2-S classifier (all 40 blocks, 6544 units) on 24
    synthetic 64x64 images with the random dissector, through both packages'
    `run_dissection` on the same weights.

    - Harvest and scoring end to end: every layer's activations within 1e-4 of the
      largest entry; in each layer whose image rankings no rounding can swap
      (`_decided_layers`: all but the 12 pinned in `UNDECIDED_V2_LAYERS`), the
      rows equal JAX's: descriptions and top images identical, similarities within
      1e-4 of the largest. In a pinned layer a unit ranks two images within float32
      noise, and soft-WPMI's rank weights and per-layer log p(d) then move every
      similarity of the layer.
    - Scoring and results on JAX's activation and embedding caches: the port's
      `run_dissection` reads them (harvest and embeddings skipped) and writes JAX's
      CSV for all 40 layers: top images identical, similarities within 1e-4 of the
      largest, descriptions identical.

    A row's descriptions may differ only where two concepts tie within the scoring's
    float32 noise: at the first concept that differs, the two similarities within
    1e-6 of the largest (the port-vs-JAX similarity differences reach 4.8e-6 of it
    on JAX's caches). One such row (blocks.32, third concept, 1e-6 apart) is
    allowed."""
    import shutil

    from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
    from mammodissect.dissect.engine import run_dissection as jax_run_dissection
    from mammodissect.dissect.targets import EfficientNetTarget as JaxTarget
    from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
    from mammodissect_torch.dissect.targets import get_target_model

    module, variables = v2_classifier
    concepts = tmp_path / "concepts.txt"
    concepts.write_text("\n".join(["mass", "calcification", "fatty tissue", "dog",
                                   "spiculated margin", "dense breast", "bright spot"]))
    layers = [f"blocks.{i}" for i in range(40)]
    kw = dict(target_model="breastclip_classifier", clip_model="random", target_layers=layers,
              d_probe="synthetic", probe_kwargs={"n": 24, "h": 64, "w": 64, "c": 1, "seed": 0},
              concept_set=str(concepts), batch_size=8, similarity_fn="soft_wpmi", top_k=8,
              num_top_concepts=3, num_top_images=4)
    _, jpath = jax_run_dissection(
        JaxDissectConfig(activation_dir=str(tmp_path / "ja"), result_dir=str(tmp_path / "jr"),
                         **kw), target=JaxTarget(module, variables), log=lambda *_: None)
    shutil.copytree(tmp_path / "ja", tmp_path / "jax_caches")
    target = get_target_model("breastclip_classifier", arch=V2_ARCHS[0], device="cpu")
    target.model.load_state_dict(classifier_from_jax(jax.tree.map(np.array, variables)))
    runs = {}
    for acts in ("pa", "jax_caches"):
        logs = []
        _, path = run_dissection(
            DissectConfig(device="cpu", activation_dir=str(tmp_path / acts),
                          result_dir=str(tmp_path / f"r_{acts}"), **kw),
            target=target, log=logs.append)
        runs[acts] = (_read(path), logs)
    want, jsim = _read(jpath)
    tol = 1e-4 * np.abs(jsim).max()
    assert any(l.startswith("[harvest] 24 images x 40 layers") for l in runs["pa"][1])
    assert "[harvest] all target activations cached, skipping" in runs["jax_caches"][1]
    decided = _decided_layers(tmp_path, layers, top_k=8)
    assert {int(k.split(".")[1]) for k, d in decided.items() if not d} == UNDECIDED_V2_LAYERS
    for acts, rows in (("pa", np.array([decided[layer] for layer in want["layer"]])),
                       ("jax_caches", np.ones(len(want), bool))):
        (got, sim), _ = runs[acts]
        assert len(got) == 6544 and list(got["layer"]) == list(want["layer"])
        assert list(got["unit"]) == list(want["unit"])
        assert np.isfinite(sim).all()
        np.testing.assert_allclose(sim[rows], jsim[rows], rtol=0, atol=tol)
        assert list(got["images"][rows]) == list(want["images"][rows]), acts
        ties = [i for i in np.flatnonzero(rows) if got["description"][i] != want["description"][i]]
        assert len(ties) <= 1, (acts, ties)
        for i in ties:
            a, b = ast.literal_eval(got["description"][i]), ast.literal_eval(want["description"][i])
            k = next(j for j in range(len(b)) if a[j] != b[j])
            assert abs(sim[i, k] - jsim[i, k]) <= 1e-6 * np.abs(jsim).max(), (acts, i)


def test_finetune_cli_trains_a_v2_classifier(tmp_path):
    """`cli.finetune --arch upmc_breast_clip_efficientnetv2-s_ft` on the CPU: one epoch
    at 32x24 builds and trains a V2-S classifier, and its `.pth` loads as the V2
    `breastclip_classifier` C-dissect target with an equal state dict."""
    from PIL import Image

    from mammodissect_torch.cli.finetune import main as finetune_main
    from mammodissect_torch.dissect.targets import get_target_model
    from mammodissect_torch.train.checkpoints import load_checkpoint

    rng = np.random.default_rng(7)
    rows = []
    for i in range(12):
        Image.fromarray((rng.random((32, 24)) * 255).astype(np.uint8)).save(tmp_path / f"i{i}.png")
        rows.append({"image_path": f"i{i}.png", "Mass": i % 2,
                     "split": "training" if i < 8 else "test"})
    pd.DataFrame(rows).to_csv(tmp_path / "meta.csv", index=False)
    assert finetune_main([
        "--csv-file", str(tmp_path / "meta.csv"), "--data-dir", str(tmp_path), "--label",
        "Mass", "--arch", V2_ARCHS[0], "--img-size", "32", "24", "--epochs", "1",
        "--batch-size", "4", "--dtype", "float32", "--checkpoints", str(tmp_path / "ck"),
        "--output-path", str(tmp_path / "out"), "--tensorboard-path", str(tmp_path / "tb"),
        "--device", "cpu"]) == 0
    (ckpt,) = (tmp_path / "ck").glob("*.pth")
    saved = load_checkpoint(str(ckpt))["model"]
    assert "image_encoder._blocks.39._bn2.running_var" in saved
    assert "image_encoder._blocks.0._project_conv.weight" in saved
    target = get_target_model("breastclip_classifier", arch=V2_ARCHS[1], finetuned_ckpt=str(ckpt),
                              device="cpu")
    state = target.model.state_dict()
    assert set(state) == set(saved) and all(torch.equal(state[k], v) for k, v in saved.items())
