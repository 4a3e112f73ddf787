"""The OpenAI CLIP towers of the PyTorch port against the JAX package at float32: the
residual attention block, a narrow ClipModule with the real 49408-token vocab (image
and text embeddings, every captured layer), the BPE copy, the HF-layout rewrite and
geometry inference, and a narrow ModifiedResNet. Weights are carried from JAX by
`convert.clip_from_jax` / `modified_resnet_from_jax` (strict: every name must
match); inputs are numpy from a seed."""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mammodissect.models import clip_vit as jax_clip_vit
from mammodissect.models import modified_resnet as jax_mrn
from mammodissect.models.tokenizers import ClipBPETokenizer as JaxBPE
from mammodissect_torch.convert import _clip_blocks, clip_from_jax, modified_resnet_from_jax
from mammodissect_torch.dissect.dissectors import get_dissector
from mammodissect_torch.dissect.targets import get_target_model
from mammodissect_torch.models import clip_vit, modified_resnet
from mammodissect_torch.models.tokenizers import ClipBPETokenizer

TINY = dict(vision_width=32, vision_layers=3, vision_heads=2, text_width=32, text_layers=2,
            text_heads=2, embed_dim=16, image_size=32)
CONCEPT_SET = "mammodissect/assets/concepts/Specific_concepts_sorted.txt"
TEXTS = ["mass", "spiculated margin", "fatty tissue", "skin thickening", "a naïve café",
         "BI-RADS 4, 2 masses at 10 o'clock", "microcalcifications " * 40]


def _rel_close(got, want, tol=1e-4):
    """Within `tol` of the largest entry of `want`."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _np(tree):
    return jax.tree.map(np.array, tree)


@pytest.mark.parametrize("causal", [False, True])
def test_residual_attention_block_matches_jax(causal):
    d, heads, b, t = 32, 4, 2, 7
    x = np.random.default_rng(0).normal(size=(b, t, d)).astype(np.float32)
    block = jax_clip_vit.ResidualAttentionBlock(d, heads, causal=causal)
    variables = block.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jax.jit(block.apply)(variables, jnp.asarray(x)))
    sd = {}
    _clip_blocks(sd, {"resblocks_0": _np(variables["params"])}, "t")
    port = clip_vit.ResidualAttentionBlock(d, heads, causal=causal)
    port.load_state_dict({k[len("t.resblocks.0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)  # the JAX package's own bar


@pytest.fixture(scope="module")
def pair():
    """(JAX OpenAIClip, port OpenAIClip on the CPU) with the same narrow weights."""
    jc = jax_clip_vit.OpenAIClip("ViT-B/16", **TINY)
    pc = clip_vit.OpenAIClip("ViT-B/16", device="cpu", **TINY)
    pc.module.load_state_dict(clip_from_jax(_np(jc.variables)))
    return jc, pc


def test_image_embeddings_and_every_layer_match_jax(pair):
    jc, pc = pair
    imgs = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
    _rel_close(pc.embed_images(imgs), jc.embed_images(imgs))
    layers = ["vision_model.encoder.layers[0]", "layers.1", "visual.transformer.layers[2]"]
    want, got = jc.harvest(imgs, layers), pc.harvest(imgs, layers)
    assert set(got) == set(want) == {"layers.0", "layers.1", "layers.2"}
    for name in want:
        _rel_close(got[name], want[name])
    # the 3-D rule: the CLS token whatever the pool mode
    _rel_close(pc.harvest(imgs, ["layers.1"], pool_mode="max")["layers.1"], want["layers.1"])
    # the full token tensors of each block
    with torch.no_grad():
        _, tokens = pc.module.encode_image(torch.from_numpy(imgs).permute(0, 3, 1, 2), (0, 2))
    _, jtokens = jax.jit(lambda v, x: jc.module.apply(
        v, x, (0, 2), method=jax_clip_vit.ClipModule.encode_image))(jc.variables, jnp.asarray(imgs))
    for name in ("layers.0", "layers.2"):
        _rel_close(tokens[name].numpy(), np.asarray(jtokens[name]))


def test_text_embeddings_match_jax_with_the_real_vocab(pair):
    jc, pc = pair
    assert pc.module.vocab_size == 49408
    words = open(CONCEPT_SET).read().split("\n")[:40] + TEXTS
    _rel_close(pc.embed_texts(words), jc.embed_texts(words))


def test_logits_match_jax(pair):
    jc, pc = pair
    imgs = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    toks = pc.tokenize(TEXTS[:3])
    want = jax.jit(jc.module.apply)(jc.variables, jnp.asarray(imgs), jnp.asarray(toks))
    with torch.no_grad():
        got = pc.module(torch.from_numpy(imgs).permute(0, 3, 1, 2), torch.from_numpy(toks).long())
    for g, w in zip(got, want):
        _rel_close(g.numpy(), np.asarray(w))


def test_probe_at_another_size_fails_clearly(pair):
    _, pc = pair
    with pytest.raises(ValueError, match="positional table of image_size 32"):
        pc.embed_images(np.zeros((1, 48, 48, 3), np.float32))


def test_bf16_follows_flax_promotion():
    """dtype=bfloat16: dense layers compute in bf16, LayerNorm returns float32, so the
    vision stream is float32 after ln_pre and the text stream stays bf16, as in JAX;
    both towers' outputs are float32."""
    m = clip_vit.ClipModule(dtype=torch.bfloat16, **TINY).eval()
    clip_vit.init_clip_weights(m, torch.Generator().manual_seed(0))
    seen = {}
    for name, mod in (("vision", m.visual.transformer.resblocks[0]),
                      ("text", m.transformer.resblocks[0])):
        mod.register_forward_hook(lambda _m, _i, out, name=name: seen.__setitem__(name, out.dtype))
    with torch.no_grad():
        img = m.encode_image(torch.zeros(1, 3, 32, 32))
        txt = m.encode_text(torch.tensor([[49406, 320, 49407]]))
    assert seen == {"vision": torch.float32, "text": torch.bfloat16}
    assert img.dtype == txt.dtype == torch.float32
    assert m.visual.proj.dtype == m.visual.class_embedding.dtype == torch.float32


def test_bpe_copy_matches_jax_on_every_concept():
    words = [w for w in open(CONCEPT_SET).read().split("\n") if w.strip()]
    texts = words + TEXTS + ["Ünïcödé résumé 123", "<|endoftext|> raw", "", "x" * 300]
    want, got = JaxBPE.default()(texts), ClipBPETokenizer.default()(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-5, -1] == 49407  # over-length: truncated with EOT kept last
    with pytest.raises(ValueError, match="too long"):
        ClipBPETokenizer.default()(["word " * 100], truncate=False)


def _hf_state_dict(rng, prefix="clip."):
    """A synthesized HF-transformers CLIPModel state dict (no `transformers` needed):
    64-wide towers, 2 vision layers at 32x32 / patch 8, 1 text layer, vocab 99."""
    sd = {}

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    for tower, n in (("vision_model", 2), ("text_model", 1)):
        for i in range(n):
            s = f"{prefix}{tower}.encoder.layers.{i}."
            for t in ("q", "k", "v", "out"):
                sd[s + f"self_attn.{t}_proj.weight"] = r(64, 64)
                sd[s + f"self_attn.{t}_proj.bias"] = r(64)
            sd[s + "mlp.fc1.weight"], sd[s + "mlp.fc1.bias"] = r(256, 64), r(256)
            sd[s + "mlp.fc2.weight"], sd[s + "mlp.fc2.bias"] = r(64, 256), r(64)
            for ln in ("layer_norm1", "layer_norm2"):
                sd[s + ln + ".weight"], sd[s + ln + ".bias"] = 1 + r(64), r(64)
    v = f"{prefix}vision_model."
    sd[v + "embeddings.class_embedding"] = r(64)
    sd[v + "embeddings.patch_embedding.weight"] = r(64, 3, 8, 8)
    sd[v + "embeddings.position_embedding.weight"] = r(17, 64)
    sd[v + "embeddings.position_ids"] = np.arange(17)[None]  # a buffer: dropped
    sd[v + "pre_layrnorm.weight"], sd[v + "pre_layrnorm.bias"] = 1 + r(64), r(64)
    sd[v + "post_layernorm.weight"], sd[v + "post_layernorm.bias"] = 1 + r(64), r(64)
    t = f"{prefix}text_model."
    sd[t + "embeddings.token_embedding.weight"] = r(99, 64)
    sd[t + "embeddings.position_embedding.weight"] = r(16, 64)
    sd[t + "final_layer_norm.weight"], sd[t + "final_layer_norm.bias"] = 1 + r(64), r(64)
    sd[f"{prefix}visual_projection.weight"] = r(16, 64)
    sd[f"{prefix}text_projection.weight"] = r(16, 64)
    sd[f"{prefix}logit_scale"] = np.asarray(2.6593, np.float32)
    return sd


@pytest.mark.parametrize("prefix", ["", "clip."])
def test_hf_layout_and_geometry_match_jax(prefix):
    sd = _hf_state_dict(np.random.default_rng(3), prefix)
    want, got = jax_clip_vit.hf_clip_to_openai_layout(sd), clip_vit.hf_clip_to_openai_layout(sd)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    geometry = clip_vit.clip_config_from_state_dict(got)
    assert geometry == jax_clip_vit.clip_config_from_state_dict(want)
    assert geometry["image_size"] == 32 and geometry["vision_layers"] == 2
    # vision-only: the text defaults stay
    vision = {k: v for k, v in got.items() if k.startswith("visual.")}
    assert (clip_vit.clip_config_from_state_dict(vision)
            == jax_clip_vit.clip_config_from_state_dict(vision))


def test_hf_checkpoint_loads_as_in_jax(tmp_path):
    """The same HF-layout `.pth` through both packages' `ckpt_path`: the geometry comes
    from the file, and the image and text features agree."""
    sd = _hf_state_dict(np.random.default_rng(4))
    path = tmp_path / "hf_clip.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    logs = []
    pc = clip_vit.OpenAIClip(ckpt_path=str(path), device="cpu", log=logs.append)
    jc = jax_clip_vit.OpenAIClip(ckpt_path=str(path))
    assert pc.module.vision_layers == jc.module.vision_layers == 2
    assert pc.module.vocab_size == 99 and pc.module.image_size == 32
    assert logs == []  # every entry of the rewritten file loads
    imgs = np.random.default_rng(5).normal(size=(2, 32, 32, 3)).astype(np.float32)
    _rel_close(pc.embed_images(imgs), jc.embed_images(imgs))
    ids = np.array([[1, 5, 7, 98] + [0] * 12, [1, 9, 98, 0] + [0] * 12], np.int32)
    want = jax.jit(lambda v, t: jc.module.apply(
        v, t, method=jax_clip_vit.ClipModule.encode_text))(jc.variables, jnp.asarray(ids))
    with torch.no_grad():
        got = pc.module.encode_text(torch.from_numpy(ids).long())
    _rel_close(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def rn_pair():
    """(JAX ModifiedResNetTarget, port ModifiedResNetTarget) of a narrow spec injected
    into both packages' MODIFIED_RESNET_SPECS, with the same weights and non-default
    BatchNorm statistics."""
    spec = ((1, 1, 1, 1), 8, 16)
    jax_mrn.MODIFIED_RESNET_SPECS.setdefault("rn-test", spec)
    modified_resnet.MODIFIED_RESNET_SPECS.setdefault("rn-test", spec)
    jt = jax_mrn.ModifiedResNetTarget(variant="rn-test", input_size=32)
    rng = np.random.default_rng(6)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, size=a.shape)
                         .astype(np.float32), _np(jt.variables["batch_stats"]))
    jt.variables = {"params": jt.variables["params"], "batch_stats": stats}
    jt._jit = {}
    pt = modified_resnet.ModifiedResNetTarget(variant="rn-test", input_size=32, device="cpu")
    pt.model.load_state_dict(modified_resnet_from_jax(_np(jt.variables)))
    return jt, pt


@pytest.mark.parametrize("channels", [3, 1])
def test_modified_resnet_matches_jax(rn_pair, channels):
    jt, pt = rn_pair
    x = np.random.default_rng(7).normal(size=(2, 32, 32, channels)).astype(np.float32)
    _rel_close(pt.embed_images(x), jt.embed_images(x))
    layers = ["conv1", "layer1", "layer2", "layer3", "layer4"]
    for mode in ("avg", "max"):
        want, got = jt.harvest(x, layers, mode), pt.harvest(x, layers, mode)
        assert set(got) == set(want) == set(layers)
        for name in layers:
            _rel_close(got[name], want[name])


def test_attention_pool_grid_mismatch_raises(rn_pair):
    jt, pt = rn_pair
    x = np.zeros((1, 64, 64, 3), np.float32)
    with pytest.raises(ValueError, match="does not match spacial_dim"):
        jt.embed_images(x)
    with pytest.raises(ValueError, match="does not match spacial_dim 1"):
        pt.embed_images(x)


def test_modified_resnet_loads_an_openai_state_dict(rn_pair, tmp_path):
    """An OpenAI RN checkpoint (`visual.*` names, `downsample.0/1`,
    `attnpool.{q,k,v,c}_proj`) loads with nothing missing or unexpected."""
    _, pt = rn_pair
    path = tmp_path / "rn.pth"
    torch.save({f"visual.{k}": v for k, v in pt.model.state_dict().items()}, path)
    logs = []
    loaded = modified_resnet.ModifiedResNetTarget(variant="rn-test", input_size=32, seed=9,
                                                  ckpt_path=str(path), device="cpu",
                                                  log=logs.append)
    assert logs == []
    x = np.random.default_rng(8).normal(size=(2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(loaded.embed_images(x), pt.embed_images(x))


NARROW = dict(vision_width=32, vision_layers=1, vision_heads=2, text_width=32, text_layers=1,
              text_heads=2, vocab_size=600)


@pytest.mark.parametrize("name,patch", [("ViT-B/32", 32), ("ViT-B/16", 16), ("ViT-L/14", 14),
                                        ("clip", 16), ("clip-cub", 16), ("clip-bloodmnist", 16)])
def test_clip_names_build_on_the_cpu(name, patch):
    d = get_dissector(name, device="cpu", image_size=2 * patch, **NARROW)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t = get_target_model(name, device="cpu", image_size=2 * patch, finetuned_ckpt=None,
                             num_class=1, ckpt_path=None, **NARROW)
    assert any("ignores ['num_class']" in str(w.message) for w in caught)
    for m in (d, t):
        assert isinstance(m, clip_vit.OpenAIClip) and m.module.patch_size == patch
    assert d.module.embed_dim == (768 if name == "ViT-L/14" else 512)
    x = np.zeros((1, 2 * patch, 2 * patch, 3), np.float32)
    assert t.harvest(x, ["layers.0"])["layers.0"].shape == (1, 32)


@pytest.mark.parametrize("name,widths", [("clip_rn50", (64, 2048)), ("clip_rn101", (64, 2048)),
                                         ("clip_rn50x4", (80, 2560))])
def test_clip_rn_targets_resolve_from_their_names(name, widths):
    t = get_target_model(name, device="cpu", input_size=32, ckpt_path=None,
                         finetuned_ckpt=None, num_class=None)
    assert isinstance(t, modified_resnet.ModifiedResNetTarget)
    out = t.harvest(np.zeros((1, 32, 32, 3), np.float32), ["conv1", "layer4"])
    assert (out["conv1"].shape[1], out["layer4"].shape[1]) == widths
