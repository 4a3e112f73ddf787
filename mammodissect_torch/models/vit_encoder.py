"""The HF-style ViT image encoder in PyTorch (counterpart of
`mammodissect/models/vit_encoder.py`), for two reference surfaces:

- BreastClip's ViT image-tower option (`HuggingfaceImageEncoder`,
  `model/modules/image_encoder.py:14-52`: the last hidden state, CLS-pooled by
  BreastClip, `model/clip.py:49-52`; `interpolate_pos_encoding=True` for non-square
  mammograms);
- the HF dissection targets `vit`, `dino`, `mae` and their `-cub` / `-bloodmnist`
  fine-tunes (`concept_vit/data_utils.py:21-36`), hooked at
  `vision_model.encoder.layers[i]`: "layers.i", pooled to the CLS token.

- Parameter names are HF `ViTModel`'s: `embeddings.{cls_token,position_embeddings,
  patch_embeddings.projection}`, `encoder.layer.i.{layernorm_before,
  attention.attention.{query,key,value},attention.output.dense,layernorm_after,
  intermediate.dense,output.dense}`, `layernorm`. A `ViTForImageClassification`
  checkpoint's `vit.` prefix is stripped on load.
- Pre-LN blocks with LayerNorm eps 1e-12 (float32), exact GELU; the scores are
  scaled by 1/sqrt(d_head) after q.k^T and the softmax runs in float32.
- Input NHWC, as the JAX module and BreastClip's EfficientNet tower take it; a
  grayscale input is repeated to `in_channels`. The patch conv pads as flax's SAME
  at stride = kernel.
- The position table is resized to the input's patch grid by `jax.image.resize`'s
  bilinear rule: half-pixel centres, and a triangle kernel widened by the scale when
  it shrinks (antialiased), which is `F.interpolate(..., antialias=True)`. At the
  native grid the table is used as is.
- `dtype` is the compute dtype of the dense layers and the patch conv, with flax's
  promotion (LayerNorm returns float32).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mammodissect_torch.convert import _load_non_strict, hf_state_dict
from mammodissect_torch.device import resolve_device
from mammodissect_torch.dissect.capture import canonical_layer_name, layer_index
from mammodissect_torch.models.layers import (
    Conv2d,
    HFDense,
    LayerNorm,
    Linear,
    attend,
    init_weights,
    same_pad_patches,
)


class ViTSelfAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.query = Linear(width, width)
        self.key = Linear(width, width)
        self.value = Linear(width, width)


class ViTAttention(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.attention = ViTSelfAttention(width)
        self.output = HFDense(width, width)


class ViTLayer(nn.Module):
    """HF ViTLayer: x + attn(ln_before(x)); x + mlp(ln_after(x)), exact GELU."""

    def __init__(self, width: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.layernorm_before = LayerNorm(width, eps=1e-12)
        self.attention = ViTAttention(width)
        self.layernorm_after = LayerNorm(width, eps=1e-12)
        self.intermediate = HFDense(width, width * mlp_ratio)
        self.output = HFDense(width * mlp_ratio, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.layernorm_before(x)
        sa = self.attention.attention
        q, k, v = (m(h).reshape(b, t, self.heads, d // self.heads).transpose(1, 2)
                   for m in (sa.query, sa.key, sa.value))
        ctx = attend(q, k, v, x.dtype).transpose(1, 2).reshape(b, t, d)
        x = x + self.attention.output.dense(ctx)
        h = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(h)


class ViTPatchEmbeddings(nn.Module):
    def __init__(self, in_channels: int, width: int, patch_size: int, dtype: torch.dtype):
        super().__init__()
        self.projection = Conv2d(in_channels, width, patch_size, stride=patch_size, dtype=dtype)


class ViTEmbeddings(nn.Module):
    def __init__(self, image_size: int, patch_size: int, width: int, in_channels: int,
                 dtype: torch.dtype):
        super().__init__()
        self.native = image_size // patch_size
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.position_embeddings = nn.Parameter(torch.zeros(1, 1 + self.native ** 2, width))
        self.patch_embeddings = ViTPatchEmbeddings(in_channels, width, patch_size, dtype)


def interp_pos(pos: torch.Tensor, native: int, gh: int, gw: int) -> torch.Tensor:
    """The [1, 1 + native^2, D] position table on a gh x gw patch grid: the CLS entry
    kept, the grid resized as `jax.image.resize(..., "bilinear")` does (half-pixel
    centres, antialiased when it shrinks); the table itself at the native grid."""
    if gh == native and gw == native:
        return pos
    grid = pos[:, 1:].reshape(1, native, native, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid.float(), size=(gh, gw), mode="bilinear", align_corners=False,
                         antialias=True)
    return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1).to(pos.dtype)],
                     dim=1)


class ViTImageEncoder(nn.Module):
    """Patch embedding, CLS token, position table, `layers` ViTLayers, final
    LayerNorm (the ViT-B/16 geometry by default)."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, in_channels: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size, self.width, self.in_channels = patch_size, width, in_channels
        self.embeddings = ViTEmbeddings(image_size, patch_size, width, in_channels, dtype)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(ViTLayer(width, heads) for _ in range(layers))
        for m in self.encoder.modules():
            if isinstance(m, nn.Linear):
                m.to(dtype)
        self.layernorm = LayerNorm(width, eps=1e-12)

    @property
    def out_dim(self) -> int:
        return self.width

    def forward(self, x: torch.Tensor, capture: Sequence[int] = ()):
        """x [B, H, W, C] (NHWC, as the JAX module and BreastClip's other towers take
        it) -> (last hidden state [B, 1 + T, D] float32, {"layers.i": CLS [B, D]
        float32})."""
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1 and self.in_channels > 1:
            x = x.repeat(1, self.in_channels, 1, 1)
        x = same_pad_patches(x, self.patch_size)
        emb = self.embeddings
        x = emb.patch_embeddings.projection(x)
        b, d, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)  # [B, gh*gw, D], row-major as NHWC
        x = torch.cat([emb.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
        x = x + interp_pos(emb.position_embeddings, emb.native, gh, gw).to(x.dtype)
        captured: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.encoder.layer):
            x = layer(x)
            if i in capture:
                captured[f"layers.{i}"] = x[:, 0].float()  # the 3-D rule: CLS
        return self.layernorm(x), captured


@torch.no_grad()
def init_vit_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`: `init_weights` for the dense layers, the patch
    conv and the LayerNorms; N(0, 0.02) CLS token and position table (the JAX
    module's initializers)."""
    init_weights(module, generator)
    for m in module.modules():
        if isinstance(m, ViTEmbeddings):
            for p in (m.cls_token, m.position_embeddings):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)


class ViTTarget:
    """Dissect an HF-style ViT's blocks ("layers.i", each pooled to CLS whatever the
    pool mode). Random weights from `seed`, or an HF ViT checkpoint at `ckpt_path`
    (a state dict or a pickled module; `vit.` stripped), loaded non-strict and
    logged. `overrides` set the geometry (`image_size`, `patch_size`, `width`,
    `layers`, `heads`, `in_channels`); `input_size` is accepted for the JAX
    factory's signature."""

    def __init__(self, ckpt_path: Optional[str] = None, input_size: int = 224, seed: int = 0,
                 device=None, log=print, **overrides):
        dev = resolve_device(device)
        model = ViTImageEncoder(**overrides)
        init_vit_weights(model, torch.Generator().manual_seed(seed))
        if ckpt_path:
            _load_non_strict(model, hf_state_dict(ckpt_path, "vit."), log)
        self.model = model.to(dev).eval()
        self.device = dev

    @torch.inference_mode()
    def harvest(self, images, layers: Sequence[str], pool_mode: str = "avg"):
        capture = tuple(sorted({layer_index(canonical_layer_name(l)) for l in layers}))
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        _, captured = self.model(x, capture=capture)
        names = list(captured)  # every layer has the same width: one copy to the host
        pooled = torch.cat([captured[n] for n in names], dim=1).cpu().numpy()
        return dict(zip(names, np.split(pooled, len(names), axis=1)))


def _register():
    from mammodissect_torch.dissect.targets import TARGETS, VIT_ENCODER_TARGETS, take_kwargs

    allowed = ("ckpt_path", "input_size", "seed", "image_size", "patch_size", "width",
               "layers", "heads", "in_channels", "device")
    for name in VIT_ENCODER_TARGETS:
        if name not in TARGETS:
            TARGETS.register(name, lambda name=name, **kw: ViTTarget(
                **take_kwargs(kw, allowed, name)))


_register()
