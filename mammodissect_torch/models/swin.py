"""The Swin Transformer image encoder in PyTorch (counterpart of
`mammodissect/models/swin.py`): the reference's Swin option for the BreastClip image
tower (`model/modules/image_encoder.py:14-52`, HF 'swin' branch) and the
`breastclip_swin` dissection target.

- Parameter names are HF `SwinModel`'s: `embeddings.patch_embeddings.projection`,
  `embeddings.norm`, `encoder.layers.i.blocks.j.{layernorm_before,
  attention.self.{query,key,value,relative_position_bias_table},
  attention.output.dense,layernorm_after,intermediate.dense,output.dense}`,
  `encoder.layers.i.downsample.{reduction,norm}`, `layernorm`. HF's
  `relative_position_index` is a buffer computed here and kept out of the state
  dict; the loaders drop it.
- The JAX module is the reference where it differs from HF: the input is padded
  to a window multiple before attention and cropped after it; the shift is dropped
  when the padded grid fits in one window; the shifted-window mask adds -1e9 (not
  -inf); `PatchMerging` crops an odd row or column (HF pads) and gathers in the
  order (0,0), (1,0), (0,1), (1,1); the patch conv pads as flax's SAME.
- LayerNorm eps 1e-5 (float32), exact GELU; scores are scaled after q.k^T, the
  relative-position bias and the mask added, the softmax taken in float32.
- Input NHWC, as the JAX module and BreastClip's other towers take it; the stages
  run NHWC. `capture` pools stage i's output as "layers.i" by the 4-D rule
  (spatial mean or max). `dtype` is the compute dtype of the dense layers and the
  patch conv, with flax's promotion.

The window bookkeeping (relative-position index, masks) is numpy, built once per
grid."""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mammodissect_torch.models.layers import (
    Conv2d,
    HFDense,
    LayerNorm,
    Linear,
    init_weights,
    same_pad_patches,
)
from mammodissect_torch.ops.pooling import pool_activation


def _rel_pos_index(m: int) -> np.ndarray:
    """[M^2, M^2] index into the (2M-1)^2-row bias table of each pair of window
    positions."""
    coords = np.stack(np.meshgrid(np.arange(m), np.arange(m), indexing="ij"))  # [2, M, M]
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0) + (m - 1)  # [M2, M2, 2]
    return (rel[..., 0] * (2 * m - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(hp: int, wp: int, m: int, shift: int) -> np.ndarray:
    """[nW, M^2, M^2] attention mask of the shifted windows: 0 within a region, -1e9
    across regions."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    slices = (slice(0, -m), slice(-m, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // m, m, wp // m, m).transpose(0, 2, 1, 3).reshape(-1, m * m)
    return (win[:, :, None] != win[:, None, :]).astype(np.float32) * -1e9


class SwinSelfAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads = heads
        self.query = Linear(dim, dim)
        self.key = Linear(dim, dim)
        self.value = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rel_pos_index(window)), persistent=False)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, HF's `attention.{self,output}`."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.self = SwinSelfAttention(dim, heads, window)
        self.output = HFDense(dim, dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B*nW, M2, C]; mask [nW, M2, M2] or None."""
        bnw, m2, c = x.shape
        sa = self.self
        heads = sa.heads
        q, k, v = (lin(x).reshape(bnw, m2, heads, c // heads).transpose(1, 2)
                   for lin in (sa.query, sa.key, sa.value))
        scores = (q @ k.transpose(-1, -2)).to(torch.promote_types(q.dtype, x.dtype))
        scores = scores / math.sqrt(c // heads)
        bias = sa.relative_position_bias_table[sa.relative_position_index.reshape(-1)]
        scores = scores + bias.reshape(m2, m2, heads).permute(2, 0, 1)[None].to(scores.dtype)
        if mask is not None:
            n_w = mask.shape[0]
            scores = scores.reshape(bnw // n_w, n_w, heads, m2, m2) + mask[None, :, None].to(
                scores.dtype)
            scores = scores.reshape(bnw, heads, m2, m2)
        probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        ctx_dtype = torch.promote_types(probs.dtype, v.dtype)
        ctx = (probs.to(ctx_dtype) @ v.to(ctx_dtype)).transpose(1, 2).reshape(bnw, m2, c)
        return self.output.dense(ctx)


class SwinBlock(nn.Module):
    """HF SwinLayer on NHWC: x + attn(ln_before(x)) over (shifted) windows; x +
    mlp(ln_after(x))."""

    def __init__(self, dim: int, heads: int, window: int = 7, shift: int = 0,
                 mlp_ratio: int = 4):
        super().__init__()
        self.window, self.shift = window, shift
        self.layernorm_before = LayerNorm(dim, eps=1e-5)
        self.attention = WindowAttention(dim, heads, window)
        self.layernorm_after = LayerNorm(dim, eps=1e-5)
        self.intermediate = HFDense(dim, dim * mlp_ratio)
        self.output = HFDense(dim * mlp_ratio, dim)
        self._masks: Dict[tuple, torch.Tensor] = {}  # (hp, wp, shift, device) -> mask

    def _mask(self, hp: int, wp: int, shift: int, device) -> torch.Tensor:
        key = (hp, wp, shift, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_mask(hp, wp, self.window, shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        m = self.window
        hp, wp = -(-h // m) * m, -(-w // m) * m
        y = F.pad(self.layernorm_before(x), (0, 0, 0, wp - w, 0, hp - h))
        shift = self.shift if min(hp, wp) > m else 0
        mask = None
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
            mask = self._mask(hp, wp, shift, y.device)
        y = y.reshape(b, hp // m, m, wp // m, m, c).permute(0, 1, 3, 2, 4, 5)
        y = self.attention(y.reshape(-1, m * m, c), mask)
        c_out = y.shape[-1]
        y = y.reshape(b, hp // m, wp // m, m, m, c_out).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, hp, wp, c_out)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        x = x + y[:, :h, :w]
        z = F.gelu(self.intermediate.dense(self.layernorm_after(x)))
        return x + self.output.dense(z)


class PatchMerging(nn.Module):
    """2x2 patches -> one (an odd row or column cropped), LayerNorm, 4C -> 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        x = x[:, :h - h % 2, :w - w % 2]
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      dim=-1)
        return self.reduction(self.norm(x))


class SwinStage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, heads, window, shift=window // 2 if bi % 2 else 0)
            for bi in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


SWIN_SPECS = {
    "swin-tiny": dict(embed=96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24)),
    "swin-small": dict(embed=96, depths=(2, 2, 18, 2), heads=(3, 6, 12, 24)),
    "swin-base": dict(embed=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32)),
}


class _PatchEmbeddings(nn.Module):
    def __init__(self, in_channels: int, embed: int, patch_size: int, dtype: torch.dtype):
        super().__init__()
        self.projection = Conv2d(in_channels, embed, patch_size, stride=patch_size, dtype=dtype)


class _Embeddings(nn.Module):
    def __init__(self, in_channels: int, embed: int, patch_size: int, dtype: torch.dtype):
        super().__init__()
        self.patch_embeddings = _PatchEmbeddings(in_channels, embed, patch_size, dtype)
        self.norm = LayerNorm(embed, eps=1e-5)


class SwinEncoder(nn.Module):
    """Patch embedding, the stages with patch merging between them, final LayerNorm
    and the spatial mean. `spec` ({"embed", "depths", "heads"}) replaces the named
    variant's geometry (small test towers)."""

    def __init__(self, variant: str = "swin-tiny", patch_size: int = 4, window: int = 7,
                 in_channels: int = 1, dtype: torch.dtype = torch.float32,
                 spec: Optional[dict] = None):
        super().__init__()
        spec = dict(spec or SWIN_SPECS[variant])
        self.patch_size, self.in_channels = patch_size, in_channels
        self.embeddings = _Embeddings(in_channels, spec["embed"], patch_size, dtype)
        n = len(spec["depths"])
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            SwinStage(spec["embed"] * 2 ** si, depth, heads, window, downsample=si < n - 1)
            for si, (depth, heads) in enumerate(zip(spec["depths"], spec["heads"])))
        for m in self.encoder.modules():
            if isinstance(m, nn.Linear):
                m.to(dtype)
        self.out_dim = spec["embed"] * 2 ** (n - 1)
        self.layernorm = LayerNorm(self.out_dim, eps=1e-5)

    def forward(self, x: torch.Tensor, capture: Sequence[int] = (), pool_mode: str = "avg"):
        """x [B, H, W, C] -> (pooled [B, out_dim] float32, {"layers.i": [B, C_i] f32})."""
        x = x.permute(0, 3, 1, 2)
        if x.shape[1] == 1 and self.in_channels > 1:
            x = x.repeat(1, self.in_channels, 1, 1)
        x = same_pad_patches(x, self.patch_size)
        x = self.embeddings.patch_embeddings.projection(x).permute(0, 2, 3, 1)
        x = self.embeddings.norm(x)
        captured: Dict[str, torch.Tensor] = {}
        for si, stage in enumerate(self.encoder.layers):
            for block in stage.blocks:
                x = block(x)
            if si in capture:
                captured[f"layers.{si}"] = pool_activation(x.float(), pool_mode, "NHWC")
            if stage.downsample is not None:
                x = stage.downsample(x)
        return self.layernorm(x).mean(dim=(1, 2)), captured


@torch.no_grad()
def init_swin_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`: `init_weights` for the dense layers, the patch
    conv and the LayerNorms; N(0, 0.02) relative-position bias tables (the JAX
    module's initializer)."""
    init_weights(module, generator)
    for m in module.modules():
        if isinstance(m, SwinSelfAttention):
            t = m.relative_position_bias_table
            t.copy_(torch.randn(t.shape, generator=generator) * 0.02)


def drop_rel_pos_index(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF Swin state dict without its `relative_position_index` buffers, which
    the port computes and does not store."""
    return {k: v for k, v in sd.items() if not k.endswith("relative_position_index")}
