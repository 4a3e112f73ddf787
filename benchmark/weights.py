"""Seeded random weights in the port's state-dict names, made on the device.

The names and shapes come from the configuration alone (`reference/efficientnet.py`'s
block table, BERT's geometry), so a renamed or reshaped parameter in the program
fails its strict `load_state_dict` instead of going unnoticed. All normal draws come
from one `torch.Generator` on the device in one call, then each tensor is a scaled
slice of them, cast to the dtype it is served in: products (convolutions, dense
layers, embeddings) in the configuration's `dtype`, normalization parameters and
statistics in float32. The image tower's BatchNorm statistics are then taken from
probe images by the plain reference (`calibrate`): with drawn statistics a deep
random tower forgets its input, and every unit's scores tie. The last BatchNorm of
each residual branch is scaled down (`residual_bn_scale`), as trained EfficientNets'
are small: with unit scales the residual stream of a random tower grows from block
to block and amplifies any rounding chaotically, so that bf16 and fp8 would read
alike against float32."""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference.efficientnet import block_table, head_width, normalize_u8, stem_width, tower

# (name, shape, kind); kind: "w" a product's weight (LeCun normal over its fan-in),
# "b" a product's bias, "bn" a BatchNorm, "bn_residual" the last BatchNorm of a
# residual branch (its scale and shift times the configuration's
# `residual_bn_scale`), "ln" a LayerNorm, "emb" an embedding table, "scale" the CLIP
# logit scale
Spec = List[Tuple[str, Tuple[int, ...], str]]


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def efficientnet_spec(cfg: dict, prefix: str) -> Spec:
    p = prefix
    spec: Spec = [(p + "_conv_stem.weight", (stem_width(cfg), cfg["image_in_channels"], 3, 3), "w"),
                  (p + "_bn0", (stem_width(cfg),), "bn")]
    for i, b in enumerate(block_table(cfg)):
        q = f"{p}_blocks.{i}."
        if b["expand"] != 1:
            spec += [(q + "_expand_conv.weight", (b["cexp"], b["cin"], 1, 1), "w"),
                     (q + "_bn0", (b["cexp"],), "bn")]
        spec += [(q + "_depthwise_conv.weight", (b["cexp"], 1, b["k"], b["k"]), "w"),
                 (q + "_bn1", (b["cexp"],), "bn"),
                 (q + "_se_reduce.weight", (b["se"], b["cexp"], 1, 1), "w"),
                 (q + "_se_reduce.bias", (b["se"],), "b"),
                 (q + "_se_expand.weight", (b["cexp"], b["se"], 1, 1), "w"),
                 (q + "_se_expand.bias", (b["cexp"],), "b"),
                 (q + "_project_conv.weight", (b["cout"], b["cexp"], 1, 1), "w"),
                 (q + "_bn2", (b["cout"],), "bn_residual" if b["residual"] else "bn")]
    last = block_table(cfg)[-1]["cout"]
    spec += [(p + "_conv_head.weight", (head_width(cfg), last, 1, 1), "w"),
             (p + "_bn1", (head_width(cfg),), "bn")]
    return spec


def bert_spec(cfg: dict, prefix: str) -> Spec:
    p, h, f = prefix, cfg["hidden_size"], cfg["intermediate_size"]
    spec: Spec = [(p + "embeddings.word_embeddings.weight", (cfg["vocab_size"], h), "emb"),
                  (p + "embeddings.position_embeddings.weight",
                   (cfg["max_position_embeddings"], h), "emb"),
                  (p + "embeddings.token_type_embeddings.weight", (cfg["type_vocab_size"], h), "emb"),
                  (p + "embeddings.LayerNorm", (h,), "ln")]
    for i in range(cfg["num_hidden_layers"]):
        q = f"{p}encoder.layer.{i}."
        for name, shape in (("attention.self.query", (h, h)), ("attention.self.key", (h, h)),
                            ("attention.self.value", (h, h)), ("attention.output.dense", (h, h)),
                            ("intermediate.dense", (f, h)), ("output.dense", (h, f))):
            spec += [(q + name + ".weight", shape, "w"), (q + name + ".bias", shape[:1], "b")]
        spec += [(q + "attention.output.LayerNorm", (h,), "ln"), (q + "output.LayerNorm", (h,), "ln")]
    return spec


def breastclip_spec(cfg: dict) -> Spec:
    """The Mammo-CLIP dual encoder: image tower, BERT, both projections, logit scale."""
    d = cfg["proj_dim"]
    return (efficientnet_spec(cfg, "image_encoder.") + bert_spec(cfg, "text_encoder.")
            + [("image_projection.projection.weight", (d, head_width(cfg)), "w"),
               ("image_projection.projection.bias", (d,), "b"),
               ("text_projection.projection.weight", (d, cfg["hidden_size"]), "w"),
               ("text_projection.projection.bias", (d,), "b"),
               ("logit_scale", (), "scale")])


def classifier_spec(cfg: dict) -> Spec:
    return efficientnet_spec(cfg, "image_encoder.") + [
        ("classifier.fc.weight", (cfg["n_class"], head_width(cfg)), "w"),
        ("classifier.fc.bias", (cfg["n_class"],), "b")]


def _normals(spec: Spec) -> int:
    n = 0
    for _, shape, kind in spec:
        n += math.prod(shape) * (2 if kind in ("bn", "bn_residual", "ln") else 1) \
            if kind != "scale" else 0
    return n


def make_state_dict(spec: Spec, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of `spec` from `seed`, on `device`."""
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(_normals(spec), generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    at = 0

    def take(shape):
        nonlocal at
        n = math.prod(shape)
        out = flat[at:at + n].reshape(shape)
        at += n
        return out

    for name, shape, kind in spec:
        if kind == "w":
            sd[name] = (take(shape) / math.sqrt(math.prod(shape[1:]))).to(dtype)
        elif kind == "b":
            sd[name] = (0.02 * take(shape)).to(dtype)
        elif kind == "emb":
            sd[name] = (take(shape) / math.sqrt(shape[1])).to(dtype)
        elif kind == "ln":
            sd[name + ".weight"] = 1.0 + 0.02 * take(shape)
            sd[name + ".bias"] = 0.02 * take(shape)
        elif kind in ("bn", "bn_residual"):
            g = cfg.get("residual_bn_scale", 1.0) if kind == "bn_residual" else 1.0
            sd[name + ".weight"] = g * (1.0 + 0.1 * take(shape))
            sd[name + ".bias"] = g * 0.1 * take(shape)
            sd[name + ".running_mean"] = torch.zeros(shape, device=device)
            sd[name + ".running_var"] = torch.ones(shape, device=device)
            sd[name + ".num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
        elif kind == "scale":
            sd[name] = torch.tensor(math.log(1.0 / cfg["temperature"]), device=device)
    return sd


@torch.no_grad()
def calibrate(sd: Dict[str, torch.Tensor], cfg: dict, images_u8: torch.Tensor,
              prefix: str = "image_encoder.") -> None:
    """Set the image tower's BatchNorm statistics in `sd` to the moments that a
    float32 reference forward over `images_u8` [B, H, W, C] meets at each one."""
    x = normalize_u8(images_u8, cfg["norm_mean"], cfg["norm_std"])
    tower(sd, cfg, x, prefix=prefix, calibrate=True)
