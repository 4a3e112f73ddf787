"""C-Mammo-CLIP Dissect in the PyTorch port: the fine-tuned classifier
(`mammodissect_torch/models/classifier.py`) against the JAX package's on the same
weights (carried across with `classifier_from_jax`) and inputs, float32 on the CPU,
its checkpoint loading, and the staged C-dissect run against the JAX package's."""
import ast
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import mammodissect.models.classifier as JC
import mammodissect_torch.models.classifier as PC
from mammodissect_torch.convert import classifier_from_jax
from mammodissect_torch.dissect.engine import DissectConfig, run_dissection

TEST_ARCH = "upmc_breast_clip_det_test_ft"


def _jax_classifier(n_class=1, seed=0):
    """The JAX breastclip_classifier target at efficientnet-test, its weights and BN
    statistics redrawn with numpy at unit-preserving scales (the default init shrinks
    activations by orders of magnitude over the blocks, which would make any
    tolerance vacuous)."""
    from mammodissect.dissect.targets import get_target_model as jax_target

    jt = jax_target("breastclip_classifier", arch=TEST_ARCH, image_shape=(64, 48, 1),
                    num_class=n_class)
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = str(path[-1].key)
        leaf = np.asarray(leaf)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)  # bias, mean

    jt.variables = jax.tree_util.tree_map_with_path(redraw, jt.variables)
    return jt


def _port_classifier(jt, n_class=1):
    m = PC.BreastClipClassifierModule("efficientnet-test", n_class=n_class).eval()
    m.load_state_dict(classifier_from_jax(jax.tree.map(np.array, jt.variables)))
    return m


def test_classifier_matches_jax():
    jt = _jax_classifier(n_class=3)
    m = _port_classifier(jt, n_class=3)
    x = np.random.default_rng(1).normal(size=(3, 64, 48, 1)).astype(np.float32)
    capture = tuple(range(7))
    jlogits, jcap = jax.jit(lambda v, x: jt.model.apply(v, x, capture=capture))(
        jt.variables, jnp.asarray(x))
    with torch.inference_mode():
        logits, cap = m(torch.from_numpy(x), capture=capture)
        plain = m(torch.from_numpy(x))
    assert logits.shape == (3, 3) and sorted(cap) == sorted(jcap) and len(cap) == 7
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(plain, logits, rtol=0, atol=0)
    for k in cap:
        np.testing.assert_allclose(cap[k].numpy(), np.asarray(jcap[k]), rtol=1e-4, atol=1e-5)


ARCHS = ["upmc_breast_clip_det_b5_period_n_ft", "upmc_breast_clip_det_b5_period_n_lp",
         "upmc_breast_clip_det_b2_period_n_ft", "upmc_vindr_breast_clip_det_b2_period_n_lp",
         "b5", "x_b7", "breast_clip_det_test_ft", "t_test", "upmc_breast_clip_efficientnetv2_ft",
         "something_v2_lp", "plain", "det_b9_ft", "_b0_"]


@pytest.mark.parametrize("arch", ARCHS)
def test_arch_helpers_match_jax(arch):
    assert PC.arch_variant(arch) == JC.arch_variant(arch)
    assert PC.arch_is_linear_probe(arch) == JC.arch_is_linear_probe(arch)


def test_linear_probe_keeps_the_encoder_in_eval():
    m = PC.BreastClipClassifierModule("efficientnet-test", freeze_encoder=True).train()
    assert m.training and m.classifier.training and not m.image_encoder.training
    m = PC.BreastClipClassifierModule("efficientnet-test").train()
    assert m.image_encoder.training


def test_reference_named_pth_loads(tmp_path):
    """A fine-tuned `.pth` with the reference's names (`image_encoder.*`,
    `classifier.fc.*`), saved from a DDP wrapper (`module.` prefix), loads into the
    `breastclip_classifier` target over the Mammo-CLIP checkpoint."""
    from mammodissect_torch.dissect.targets import get_target_model

    jt = _jax_classifier(n_class=2, seed=4)
    sd = classifier_from_jax(jax.tree.map(np.array, jt.variables))
    torch.save({"module." + k: v for k, v in sd.items()}, tmp_path / "ft.pth")
    clip_sd = {k: torch.zeros_like(v) for k, v in sd.items() if k.startswith("image_encoder.")}
    clip_sd["text_encoder.embeddings.word_embeddings.weight"] = torch.zeros(3, 4)
    torch.save({"model": clip_sd, "config": {}}, tmp_path / "clip.tar")
    target = get_target_model("breastclip_classifier", arch=TEST_ARCH, num_class=2,
                              device="cpu", ckpt_path=str(tmp_path / "clip.tar"),
                              finetuned_ckpt=str(tmp_path / "ft.pth"))
    got = target.model.state_dict()
    for k, v in sd.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    # the Mammo-CLIP checkpoint alone: the encoder loads, the head keeps its init
    only_clip = get_target_model("breastclip_classifier", arch=TEST_ARCH, num_class=2,
                                 device="cpu", ckpt_path=str(tmp_path / "clip.tar"))
    assert all(float(v.abs().sum()) == 0 for k, v in only_clip.model.state_dict().items()
               if k.startswith("image_encoder.") and v.is_floating_point()
               and "running_var" not in k)
    assert float(only_clip.model.classifier.fc.weight.detach().abs().sum()) > 0
    # the `breastclip` target takes the image encoder of the same checkpoint
    encoder = get_target_model("breastclip", variant="efficientnet-test", dtype="float32",
                               device="cpu", ckpt_path=str(tmp_path / "clip.tar"))
    got = encoder.model.state_dict()
    for k, v in clip_sd.items():
        if k.startswith("image_encoder."):
            torch.testing.assert_close(got[k[len("image_encoder."):]], v, rtol=0, atol=0)


def test_c_dissect_staged_matches_jax(tmp_path):
    """C-Mammo-CLIP Dissect: the classifier target (its JAX weights carried across),
    dissected by the random dissector through the staged path of both packages.
    Blocks 0-4: at 64x48 the last two blocks pool a 2x2 map whose activations spread
    by ~1e-5 across images, a few float32 roundings, so their image rankings are set
    by rounding (test_classifier_matches_jax holds their values)."""
    from mammodissect.data.probes import ArrayProbe as JaxArrayProbe
    from mammodissect_torch.data.probes import ArrayProbe
    from mammodissect_torch.dissect.targets import EfficientNetTarget
    from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
    from mammodissect.dissect.engine import run_dissection as jax_run_dissection

    jt = _jax_classifier(seed=2)
    target = EfficientNetTarget(_port_classifier(jt), torch.device("cpu"))
    rng = np.random.default_rng(5)
    # mammogram-shaped: a textured region of random extent on a black background, so
    # that images differ in more than noise (pooled noise gives near-ties everywhere)
    images = np.zeros((21, 64, 48, 1), np.uint8)
    for img in images[:17]:
        hh, ww = rng.integers(16, 65), rng.integers(12, 49)
        img[:hh, :ww] = rng.integers(1, 256, size=(hh, ww, 1), dtype=np.uint8)
    images[17:] = images[:4]  # repeated images: exact activation ties
    kw = dict(target_model="breastclip_classifier", clip_model="random",
              target_layers=[f"blocks.{i}" for i in range(5)], d_probe="synthetic_u8",
              concept_set="tests/assets/tiny_concepts.txt", batch_size=8,
              num_top_concepts=3, num_top_images=4, resident=True,
              target_kwargs={"arch": TEST_ARCH})
    _, jpath = jax_run_dissection(
        JaxDissectConfig(activation_dir=str(tmp_path / "ja"), result_dir=str(tmp_path / "jr"),
                         **kw), probe=JaxArrayProbe(images, mean=0.3, std=0.25), target=jt,
        log=lambda *_: None)
    logs = []
    df, path = run_dissection(
        DissectConfig(device="cpu", activation_dir=str(tmp_path / "pa"),
                      result_dir=str(tmp_path / "pr"), **kw),
        probe=ArrayProbe(images, mean=0.3, std=0.25), target=target, log=logs.append)
    assert logs[0].startswith("[resident] not applicable"), logs
    assert len(df) == sum(b.output_filters for b in target.tower.block_args[:5])
    (df, jdf) = pd.read_csv(path), pd.read_csv(jpath)
    top = [[ast.literal_eval(r)[0] for r in d["description"]] for d in (df, jdf)]
    assert np.mean([a == b for a, b in zip(*top)]) >= 0.99
    assert list(df["images"]) == list(jdf["images"])
    sim, jsim = (np.array([json.loads(s) for s in d["similarity"]]) for d in (df, jdf))
    np.testing.assert_allclose(sim, jsim, rtol=1e-4, atol=1e-4 * np.abs(jsim).max())
