"""The target zoo of the PyTorch port against the JAX package, float32 on the CPU: the
torchvision ResNets, the HF-style ViT encoder and the Swin encoder at narrow
geometry, with the JAX weights carried across by `convert.*_from_jax`. Each capture
must agree within 1e-4 of the largest entry. Also the JAX package's traps: the
ResNet `conv1` capture before BatchNorm, the ViT position table resized above,
below and off the native grid (`jax.image.resize`'s antialiased bilinear), the Swin
window padding, the dropped shift and the odd-row crop; the converters against
the JAX `*_torch_to_flax`; HF checkpoints loading by name; BreastClip's Swin and ViT
image towers; the target names (the deliberate `vit-bloodmnist` difference); and a
whole staged dissection with a ResNet and with a Swin target against the JAX CSV."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mammodissect.dissect import targets as jax_targets
from mammodissect.dissect.engine import DissectConfig as JaxDissectConfig
from mammodissect.dissect.engine import run_dissection as jax_run_dissection
from mammodissect.models import resnet as jr
from mammodissect.models import swin as js
from mammodissect.models import vit_encoder as jv
from mammodissect_torch import convert
from mammodissect_torch.dissect import targets
from mammodissect_torch.dissect.engine import DissectConfig, run_dissection
from mammodissect_torch.models import resnet as pr
from mammodissect_torch.models import swin as ps
from mammodissect_torch.models import vit_encoder as pv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN_SPEC = dict(embed=16, depths=(2, 1), heads=(2, 2))
VIT_GEOMETRY = dict(image_size=64, patch_size=16, width=32, layers=2, heads=2)
CONCEPTS = "tests/assets/tiny_concepts.txt"


def _np(tree):
    return jax.tree.map(np.array, tree)


def _init(module, shape, seed):
    """The flax module's variables (numpy), from a jitted init on ones of `shape`."""
    return _np(jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.ones(shape, jnp.float32)))


def _apply(module, variables, x, **kw):
    """The flax module's output on x, jitted (much faster than op by op)."""
    return jax.jit(lambda v, x: module.apply(v, x, **kw))(variables, jnp.asarray(x))


def _close(got, want):
    """Within 1e-4 of the largest entry, at float32."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-6))


def _random_stats(stats, rng):
    """BatchNorm statistics away from identity, so that BatchNorm shows."""
    return {k: _random_stats(v, rng) if isinstance(v, dict) else
            (rng.normal(scale=0.1, size=v.shape) if k == "mean"
             else rng.uniform(0.5, 1.5, size=v.shape)).astype(np.float32)
            for k, v in stats.items()}


# ---------------------------------------------------------------------------- ResNet
@pytest.fixture(scope="module", params=["basic", "bottleneck"])
def resnet_pair(request):
    """A one-block-a-stage ResNet of each block kind, injected into both packages'
    tables under the same name, with JAX's weights and random BatchNorm statistics."""
    name = f"resnet-test-{request.param}"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jr.RESNET_SPECS, name, (
            jr.BasicBlock if request.param == "basic" else jr.Bottleneck, (1, 1, 1, 1)))
        mp.setitem(pr.RESNET_SPECS, name, (
            pr.BasicBlock if request.param == "basic" else pr.Bottleneck, (1, 1, 1, 1)))
        jm = jr.ResNet(variant=name, num_classes=5)
        v = _init(jm, (1, 32, 32, 3), 0)
        v["batch_stats"] = _random_stats(v["batch_stats"], np.random.default_rng(1))
        pm = pr.ResNet(name, num_classes=5)
        pm.load_state_dict(convert.resnet_from_jax(v))
        yield name, jm, v, pm.eval()


CAPTURE = ("conv1", "layer1", "layer2", "layer3", "layer4")


@pytest.mark.parametrize("pool_mode", ["avg", "max"])
def test_resnet_captures_match_jax(resnet_pair, pool_mode):
    """Grayscale input (repeated to RGB), every capture point and the logits."""
    _, jm, v, pm = resnet_pair
    x = np.random.default_rng(2).normal(size=(2, 40, 36, 1)).astype(np.float32)
    jl, jc = _apply(jm, v, x, capture=CAPTURE, pool_mode=pool_mode)
    with torch.no_grad():
        pl, pc = pm(torch.from_numpy(x).permute(0, 3, 1, 2), capture=CAPTURE,
                    pool_mode=pool_mode)
    assert sorted(pc) == sorted(CAPTURE)
    for k in CAPTURE:
        _close(pc[k], jc[k])
    _close(pl, jl)


def test_resnet_conv1_capture_is_before_batchnorm(resnet_pair):
    """The reference hooks the conv1 MODULE (`utils.py:80`): its capture is the
    convolution alone, not its BatchNorm and ReLU."""
    _, _, _, pm = resnet_pair
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 3, 32, 32)).astype(np.float32))
    with torch.no_grad():
        _, cap = pm(x, capture=("conv1",))
        conv = torch.nn.functional.conv2d(x, pm.conv1.weight, stride=2, padding=3)
        after = torch.relu(pm.bn1(conv))
    _close(cap["conv1"], conv.mean(dim=(2, 3)))
    assert not np.allclose(cap["conv1"].numpy(), after.mean(dim=(2, 3)).numpy(), atol=1e-2)


def test_resnet_converter_round_trips_through_jax(resnet_pair):
    name, _, v, pm = resnet_pair
    sd = {k: t.numpy() for k, t in pm.state_dict().items() if "num_batches" not in k}
    params, stats = jr.resnet_torch_to_flax(sd, name)
    for got, want in ((params, v["params"]), (stats, v["batch_stats"])):
        jax.tree.map(np.testing.assert_array_equal, got, want)


def test_resnet_checkpoint_loader_unwraps_and_strips_module(tmp_path, capsys):
    """The Places365 layout: {"state_dict": ...} with DDP's `module.` prefix."""
    src = pr.ResNetTarget("resnet18", num_classes=365, seed=4, device="cpu")
    path = tmp_path / "places.pth.tar"
    torch.save({"state_dict": {f"module.{k}": v for k, v in src.model.state_dict().items()},
                "epoch": 3}, path)
    loaded = targets.get_target_model("resnet18_places", ckpt_path=str(path), seed=5,
                                      num_class=1, device="cpu")
    assert loaded.model.fc.out_features == 365
    for k, v in src.model.state_dict().items():
        torch.testing.assert_close(loaded.model.state_dict()[k], v, rtol=0, atol=0)
    assert "[convert]" not in capsys.readouterr().out  # every entry matched


def test_resnet_kwargs_alias_and_loud_drop():
    """The engine's `num_class` reaches `num_classes`; a fine-tuned checkpoint the
    target cannot take is dropped loudly."""
    t = targets.get_target_model("resnet18", num_class=7, device="cpu")
    assert t.model.fc.out_features == 7 and t.model.num_classes == 7
    with pytest.warns(UserWarning, match="ignores.*finetuned_ckpt"):
        targets.get_target_model("resnet18", finetuned_ckpt="/x.pth", device="cpu")
    imgs = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(np.float32)
    out = t.harvest(imgs, ["conv1", "layer2"], "max")
    assert {k: v.shape for k, v in out.items()} == {"conv1": (3, 64), "layer2": (3, 128)}


# ------------------------------------------------------------------------------ ViT
@pytest.fixture(scope="module")
def vit_pair():
    jm = jv.ViTImageEncoder(**VIT_GEOMETRY)
    v = _init(jm, (1, 64, 64, 3), 1)
    pm = pv.ViTImageEncoder(**VIT_GEOMETRY)
    pm.load_state_dict(convert.vit_encoder_from_jax(v["params"]))
    return jm, v, pm.eval()


@pytest.mark.parametrize("gh,gw", [(18, 18), (10, 10), (14, 10), (14, 14)])
def test_vit_position_table_resize_matches_jax(gh, gw):
    """Above, below and off the native 14x14 grid (288 px, 160 px, 224x160 at patch
    16): `jax.image.resize`'s bilinear antialiases when it shrinks; at the native
    grid the table is used as is."""
    pos = np.random.default_rng(4).normal(size=(1, 197, 24)).astype(np.float32)
    want = np.asarray(jv._interp_pos(jnp.asarray(pos), 14, gh, gw))
    got = pv.interp_pos(torch.from_numpy(pos), 14, gh, gw).numpy()
    _close(got, want)
    if (gh, gw) == (14, 14):
        np.testing.assert_array_equal(got, pos)


@pytest.mark.parametrize("hw", [(64, 64), (96, 96), (48, 48), (64, 48)])
def test_vit_encoder_matches_jax(vit_pair, hw):
    """At the native grid, above it, below it and off-square, grayscale input
    repeated to RGB: the last hidden state and every layer's CLS capture."""
    jm, v, pm = vit_pair
    x = np.random.default_rng(5).normal(size=(2, *hw, 1)).astype(np.float32)
    jo, jc = _apply(jm, v, x, capture=(0, 1))
    with torch.no_grad():
        po, pc = pm(torch.from_numpy(x), capture=(0, 1))
    _close(po, jo)
    for k in ("layers.0", "layers.1"):
        _close(pc[k], jc[k])


def test_vit_converter_round_trips_through_jax(vit_pair):
    _, v, pm = vit_pair
    sd = {f"vit.{k}": t.numpy() for k, t in pm.state_dict().items()}
    jax.tree.map(np.testing.assert_array_equal, jv.vit_torch_to_flax(sd), v["params"])


def test_vit_target_captures_cls_whatever_the_pool_mode(vit_pair, tmp_path):
    """A `ViTForImageClassification`-style checkpoint (`vit.` prefix) loads into the
    target; every layer pools to CLS in both pool modes, as in JAX."""
    jm, v, pm = vit_pair
    path = tmp_path / "vit.pth"
    torch.save({f"vit.{k}": t for k, t in pm.state_dict().items()}, path)
    t = targets.get_target_model("dino", ckpt_path=str(path), device="cpu", **VIT_GEOMETRY)
    x = np.random.default_rng(6).normal(size=(3, 64, 64, 3)).astype(np.float32)
    _, jc = _apply(jm, v, x, capture=(0, 1))
    for mode in ("avg", "max"):
        out = t.harvest(x, ["layers.0", "vision_model.encoder.layers[1]"], mode)
        assert sorted(out) == ["layers.0", "layers.1"]
        for k in out:
            _close(out[k], jc[k])


# ----------------------------------------------------------------------------- Swin
@pytest.fixture(scope="module")
def swin_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(js.SWIN_SPECS, "swin-zoo-test", dict(SWIN_SPEC))
        jm = js.SwinEncoder(variant="swin-zoo-test", window=4, in_channels=1)
        v = _init(jm, (1, 16, 16, 1), 2)
        pm = ps.SwinEncoder(window=4, in_channels=1, spec=SWIN_SPEC)
        pm.load_state_dict(convert.swin_from_jax(v["params"]))
        yield jm, v, pm.eval()


def test_swin_window_bookkeeping_matches_jax():
    np.testing.assert_array_equal(ps._rel_pos_index(7), js._rel_pos_index(7))
    mask = ps._shift_mask(14, 21, 7, 3)
    np.testing.assert_array_equal(mask, js._shift_mask(14, 21, 7, 3))
    assert set(np.unique(mask)) == {0.0, np.float32(-1e9)}  # -1e9, not -inf


@pytest.mark.parametrize("hw,pool_mode", [((60, 44), "avg"), ((64, 48), "max")])
def test_swin_encoder_matches_jax(swin_pair, hw, pool_mode):
    """60x44 at patch 4 and window 4: a 15x11 grid padded to 16x12 for the shifted
    windows and cropped after them, and merging crops the odd row and column
    (15x11 -> 7x5)."""
    jm, v, pm = swin_pair
    x = np.random.default_rng(7).normal(size=(2, *hw, 1)).astype(np.float32)
    jo, jc = _apply(jm, v, x, capture=(0, 1), pool_mode=pool_mode)
    with torch.no_grad():
        po, pc = pm(torch.from_numpy(x), capture=(0, 1), pool_mode=pool_mode)
    _close(po, jo)
    for k in ("layers.0", "layers.1"):
        _close(pc[k], jc[k])


@pytest.mark.parametrize("hw,shifted", [((4, 4), False), ((3, 3), False), ((6, 7), True)])
def test_swin_block_pads_and_drops_the_shift_as_jax(hw, shifted):
    """A padded grid that fits one window takes no shift (the shifted block equals
    the unshifted one); a larger one does; both against the JAX block."""
    x = np.random.default_rng(8).normal(size=(2, *hw, 8)).astype(np.float32)
    jb = js.SwinBlock(8, 2, window=4, shift=2)
    v = _init(jb, x.shape, 3)
    want = np.asarray(_apply(jb, v, x))
    blocks = {s: ps.SwinBlock(8, 2, window=4, shift=s) for s in (0, 2)}
    sd = convert.swin_from_jax({"patch_embed": {"kernel": np.zeros((4, 4, 1, 8)),
                                                "bias": np.zeros(8)},
                                "patch_norm": v["params"]["ln1"], "stage0_block0": v["params"],
                                "ln_final": v["params"]["ln1"]})
    prefix = "encoder.layers.0.blocks.0."
    with torch.no_grad():
        out = {}
        for s, b in blocks.items():
            b.load_state_dict({k[len(prefix):]: t for k, t in sd.items() if k.startswith(prefix)})
            out[s] = b(torch.from_numpy(x)).numpy()
    _close(out[2], want)
    assert np.allclose(out[0], out[2], atol=1e-6) != shifted


def test_patch_merging_crops_odd_and_gathers_as_jax():
    x = np.random.default_rng(9).normal(size=(2, 5, 7, 6)).astype(np.float32)
    jm = js.PatchMerging()
    v = _init(jm, x.shape, 4)
    pm = ps.PatchMerging(6)
    pm.load_state_dict({"norm.weight": torch.from_numpy(v["params"]["ln"]["scale"]),
                        "norm.bias": torch.from_numpy(v["params"]["ln"]["bias"]),
                        "reduction.weight": torch.from_numpy(v["params"]["reduction"]["kernel"].T)})
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2, 3, 12)
    _close(got, _apply(jm, v, x))


def test_swin_converter_round_trips_through_jax(swin_pair):
    _, v, pm = swin_pair
    sd = {f"swin.{k}": t.numpy() for k, t in pm.state_dict().items()}
    jax.tree.map(np.testing.assert_array_equal, js.swin_torch_to_flax(sd), v["params"])


def _hf_block(i, attn):
    names = ("attention.output.dense", f"{attn}.key", f"{attn}.query", f"{attn}.value",
             "intermediate.dense", "layernorm_after", "layernorm_before", "output.dense")
    return [f"{i}.{n}.{w}" for n in names for w in ("bias", "weight")]


# the state-dict names of HF `SwinModel(SwinConfig(embed_dim=8, depths=[1, 1],
# num_heads=[2, 2], window_size=2, num_channels=1))` and `ViTModel(ViTConfig(
# hidden_size=16, num_hidden_layers=1, ...), add_pooling_layer=False)`
HF_NAMES = {
    "swin": ["embeddings.norm.bias", "embeddings.norm.weight",
             "embeddings.patch_embeddings.projection.bias",
             "embeddings.patch_embeddings.projection.weight",
             *_hf_block("encoder.layers.0.blocks.0", "attention.self"),
             "encoder.layers.0.blocks.0.attention.self.relative_position_bias_table",
             "encoder.layers.0.blocks.0.attention.self.relative_position_index",
             "encoder.layers.0.downsample.norm.bias", "encoder.layers.0.downsample.norm.weight",
             "encoder.layers.0.downsample.reduction.weight",
             *_hf_block("encoder.layers.1.blocks.0", "attention.self"),
             "encoder.layers.1.blocks.0.attention.self.relative_position_bias_table",
             "encoder.layers.1.blocks.0.attention.self.relative_position_index",
             "layernorm.bias", "layernorm.weight"],
    "vit": ["embeddings.cls_token", "embeddings.patch_embeddings.projection.bias",
            "embeddings.patch_embeddings.projection.weight", "embeddings.position_embeddings",
            *_hf_block("encoder.layer.0", "attention.attention"), "layernorm.bias",
            "layernorm.weight"],
}


@pytest.mark.parametrize("tower", ["swin", "vit"])
def test_state_dict_names_are_hf(tower, tmp_path):
    """The port's names are HF's; an HF Swin checkpoint (its `relative_position_index`
    buffers included, `swin.` prefix) loads into the target with every entry matched."""
    if tower == "swin":
        pm = ps.SwinEncoder(window=2, in_channels=3,
                            spec=dict(embed=8, depths=(1, 1), heads=(2, 2)))
        want = ps.drop_rel_pos_index(dict.fromkeys(HF_NAMES["swin"]))
    else:
        pm = pv.ViTImageEncoder(image_size=32, patch_size=16, width=16, layers=1, heads=2)
        want = HF_NAMES["vit"]
    assert sorted(pm.state_dict()) == sorted(want)
    if tower == "swin":
        sd = {f"swin.{k}": v for k, v in pm.state_dict().items()}
        for k in HF_NAMES["swin"]:
            if k.endswith("relative_position_index"):
                sd[f"swin.{k}"] = torch.from_numpy(ps._rel_pos_index(2))
        torch.save(sd, tmp_path / "swin.pth")
        logs = []
        t = targets.SwinTarget(spec=dict(embed=8, depths=(1, 1), heads=(2, 2)), window=2,
                               hf_ckpt=str(tmp_path / "swin.pth"), seed=1, device="cpu",
                               log=logs.append)
        assert not logs, logs
        for k, v in pm.state_dict().items():
            torch.testing.assert_close(t.model.state_dict()[k], v, rtol=0, atol=0)


def test_swin_target_spec_leaves_the_table_alone():
    before = {k: dict(v) for k, v in ps.SWIN_SPECS.items()}
    t = targets.get_target_model("breastclip_swin", variant="custom", spec=SWIN_SPEC,
                                 window=4, in_channels=1, device="cpu")
    assert ps.SWIN_SPECS == before
    out = t.harvest(np.zeros((2, 32, 24, 1), np.float32), ["layers.0", "layers.1"], "avg")
    assert {k: v.shape for k, v in out.items()} == {"layers.0": (2, 16), "layers.1": (2, 32)}


# ------------------------------------------------------------------------ BreastClip
@pytest.mark.parametrize("tower", ["swin", "vit"])
def test_breastclip_swin_and_vit_towers_match_jax(tower, monkeypatch):
    """`embed_images` of a BreastClip whose config names a swin or vit image tower
    (narrow: the JAX module builds its default geometry, so the test narrows it)."""
    import functools

    from mammodissect.models.breastclip import BreastClip as JaxBreastClip
    from mammodissect_torch.models.breastclip import BreastClip

    ie = {"model_type": tower, "name": tower, "in_channels": 3}
    if tower == "swin":
        monkeypatch.setitem(js.SWIN_SPECS, "swin-narrow", dict(SWIN_SPEC))
        ie.update(variant="swin-narrow", spec=SWIN_SPEC)
    else:
        monkeypatch.setattr(jv, "ViTImageEncoder",
                            functools.partial(jv.ViTImageEncoder, **VIT_GEOMETRY))
        ie.update(VIT_GEOMETRY)
    cfg = {"image_encoder": ie, "text_encoder": {"pooling": "eos"},
           "projection_head": {"name": "linear", "proj_dim": 16}}
    jc = JaxBreastClip.create(model_config=cfg, image_shape=(32, 24, 1), bert_layers=1,
                              vocab_size=40)
    pc = BreastClip.create(model_config=cfg, bert_layers=1, vocab_size=40, device="cpu")
    pc.module.load_state_dict(convert.breastclip_from_jax(_np(jc.variables)))
    x = np.random.default_rng(12).normal(size=(3, 40, 28, 1)).astype(np.float32)
    _close(pc.embed_images(x), jc.embed_images(x))
    u8 = np.random.default_rng(13).integers(0, 256, size=(3, 40, 28, 1), dtype=np.uint8)
    _close(pc.embed_images_u8(u8, 0.3, 0.25), jc.embed_images_u8(u8, 0.3, 0.25))


# ---------------------------------------------------------------------------- names
_NAMES = r"""
from mammodissect_torch.dissect import targets as T
tiny = dict(image_size=32, width=16, layers=1, heads=2, device="cpu")
# in a fresh interpreter, before any zoo module is imported
t = T.get_target_model("vit-bloodmnist", **tiny)
assert type(t).__name__ == "ViTTarget", type(t)
assert type(T.get_target_model("resnet18", device="cpu")).__name__ == "ResNetTarget"
assert type(T.get_target_model("breastclip_swin", spec={"embed": 8, "depths": (1,),
            "heads": (2,)}, device="cpu")).__name__ == "SwinTarget"
names = ["resnet18", "resnet34", "resnet50", "resnet101", "resnet152", "resnet", "resnet-cub",
         "resnet-bloodmnist", "resnet18_places", "vit", "dino", "mae", "vit-cub",
         "vit-bloodmnist", "dino-cub", "dino-bloodmnist", "mae-cub", "mae-bloodmnist",
         "breastclip_swin"]
missing = [n for n in names if n not in T.TARGETS]
assert not missing, missing
# the JAX dispatch sends "vit-bloodmnist" to its CLIP module, which does not register it
from mammodissect.dissect.targets import get_target_model as jax_target
try:
    jax_target("vit-bloodmnist")
except KeyError:
    print("jax KeyError")
print("ok")
"""


def test_every_zoo_name_resolves_in_a_fresh_interpreter():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _NAMES], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["jax", "KeyError", "ok"], proc.stdout


# ------------------------------------------------------------- whole staged dissection
def _staged(tmp_path, target_model, layers, jt, pt, images):
    kw = dict(target_model=target_model, clip_model="random", target_layers=layers,
              d_probe="synthetic", concept_set=CONCEPTS, batch_size=8, top_k=8,
              num_top_concepts=3, num_top_images=4)
    from mammodissect.data.probes import ArrayProbe as JaxArrayProbe
    from mammodissect_torch.data.probes import ArrayProbe

    _, jpath = jax_run_dissection(JaxDissectConfig(activation_dir=str(tmp_path / "ja"),
                                                   result_dir=str(tmp_path / "jr"), **kw),
                                  probe=JaxArrayProbe(images), target=jt, log=lambda *_: None)
    logs = []
    _, path = run_dissection(DissectConfig(device="cpu", activation_dir=str(tmp_path / "pa"),
                                           result_dir=str(tmp_path / "pr"), **kw),
                             probe=ArrayProbe(images), target=pt, log=logs.append)
    assert any(l.startswith(f"[harvest] {len(images)} images x {len(layers)} layers")
               for l in logs), logs
    df, jdf = pd.read_csv(path), pd.read_csv(jpath)
    assert list(df["layer"]) == list(jdf["layer"]) and list(df["unit"]) == list(jdf["unit"])
    assert list(df["description"]) == list(jdf["description"])
    assert list(df["images"]) == list(jdf["images"])
    sim = np.array([json.loads(s) for s in df["similarity"]])
    jsim = np.array([json.loads(s) for s in jdf["similarity"]])
    assert np.isfinite(sim).all()
    np.testing.assert_allclose(sim, jsim, rtol=0, atol=1e-4 * np.abs(jsim).max())
    return df


def test_staged_resnet_dissection_matches_jax(resnet_pair, tmp_path):
    name, jm, v, pm = resnet_pair
    jt = jr.ResNetTarget.__new__(jr.ResNetTarget)
    jt.model, jt.variables, jt._jit = jm, v, {}
    pt = pr.ResNetTarget.__new__(pr.ResNetTarget)
    pt.model, pt.device = pm, torch.device("cpu")
    images = np.random.default_rng(14).normal(size=(20, 32, 32, 3)).astype(np.float32)
    df = _staged(tmp_path, name, ["conv1", "layer1", "layer4"], jt, pt, images)
    widths = {"basic": 64 + 64 + 512, "bottleneck": 64 + 256 + 2048}
    assert len(df) == widths[name.rsplit("-", 1)[1]]


def test_staged_swin_dissection_matches_jax(swin_pair, tmp_path, monkeypatch):
    monkeypatch.setitem(js.SWIN_SPECS, "swin-staged", dict(SWIN_SPEC))
    jt = jax_targets.SwinTarget(variant="swin-staged", in_channels=1, window=4, input_size=32)
    pt = targets.get_target_model("breastclip_swin", spec=SWIN_SPEC, in_channels=1, window=4,
                                  device="cpu")
    pt.model.load_state_dict(convert.swin_from_jax(_np(jt.variables["params"])))
    images = np.random.default_rng(15).normal(size=(20, 40, 28, 1)).astype(np.float32)
    df = _staged(tmp_path, "breastclip_swin", ["layers.0", "layers.1"], jt, pt, images)
    assert len(df) == 16 + 32
