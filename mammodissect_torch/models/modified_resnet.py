"""CLIP's ModifiedResNet image tower (RN50 / RN101 / RN50x4) in PyTorch (counterpart of
`mammodissect/models/modified_resnet.py`, the OpenAI-CLIP tower
`concept_vit/clip/model.py:56-151`).

- Parameter names are OpenAI's, without the checkpoint's `visual.` prefix: the
  3-conv stem `conv1..3`/`bn1..3`, `layerN.M.conv1..3`/`bn1..3`, the shortcut
  `layerN.M.downsample.0` (conv) / `.1` (BatchNorm), `attnpool.positional_embedding`
  and `attnpool.{q,k,v,c}_proj`.
- Every downsampling is an average pool, then a 1x1 conv, in the main path and in
  the shortcut; the stem ends in a 2x2 average pool (no max pool).
- BatchNorm in eval, eps 1e-5 (flax momentum 0.9 = torch 0.1), in float32.
- A grayscale input is repeated to 3 channels (CLIP's preprocess converts to RGB).
- `AttentionPool2d`: the mean token attends over all spatial tokens; it raises on
  a grid other than the one its positional table was built for.
- `capture` pools `conv1` (the stem's output) and `layer1..4` as the forward passes
  them. The towers run NCHW; `ModifiedResNetTarget` takes NHWC numpy.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mammodissect_torch.convert import _load_non_strict, torch_state_dict
from mammodissect_torch.device import resolve_device
from mammodissect_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    Linear,
    attend,
    init_weights,
    l2_normalized,
    nchw_from_nhwc,
)
from mammodissect_torch.ops.pooling import pool_activation


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ClipBottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", Conv2d(inplanes, out, 1, bias=False)),
                ("1", _bn(out))]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(self.avgpool(out)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """QKV attention pooling with a learned positional table; the mean token attends
    over all spatial tokens (`clip/model.py:56-81` semantics; the scores are scaled
    after q.k^T, as in the JAX module)."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.spacial_dim = spacial_dim
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = Linear(embed_dim, embed_dim)
        self.q_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = x.flatten(2).transpose(1, 2)  # [B, HW, C], row-major as NHWC
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        pos = self.positional_embedding
        if tokens.shape[1] != pos.shape[0]:
            # the torch reference errors on a grid mismatch; slicing the row-major
            # table onto a smaller grid would misalign every row after the first
            raise ValueError(
                f"AttentionPool2d: input grid {h}x{w} (+CLS = {tokens.shape[1]} "
                f"tokens) does not match spacial_dim {self.spacial_dim} "
                f"({pos.shape[0]} positions); resize inputs to the tower's "
                "native resolution")
        tokens = tokens + pos[None].to(tokens.dtype)
        dh = c // self.num_heads

        def heads(a):  # [B, T, C] -> [B, heads, T, dh]
            return a.reshape(b, -1, self.num_heads, dh).transpose(1, 2)

        q = heads(self.q_proj(tokens[:, :1]))
        k, v = heads(self.k_proj(tokens)), heads(self.v_proj(tokens))
        return self.c_proj(attend(q, k, v, x.dtype).transpose(1, 2).reshape(b, c))


MODIFIED_RESNET_SPECS: Dict[str, Tuple[Tuple[int, ...], int, int]] = {
    # name: (stage block counts, width, embed output dim)
    "RN50": ((3, 4, 6, 3), 64, 1024),
    "RN101": ((3, 4, 23, 3), 64, 512),
    "RN50x4": ((4, 6, 10, 6), 80, 640),
}


class ModifiedResNet(nn.Module):
    def __init__(self, variant: str = "RN50", input_size: int = 224):
        super().__init__()
        stages, width, out_dim = MODIFIED_RESNET_SPECS[variant]
        self.variant, self.input_size = variant, input_size
        # 3-conv stem (`clip/model.py:90-104`)
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = _bn(width // 2)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = _bn(width // 2)
        self.conv3 = Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = _bn(width)
        self.avgpool = nn.AvgPool2d(2)
        inplanes, planes = width, width
        for si, n_blocks in enumerate(stages):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(ClipBottleneck(inplanes, planes, 2 if (si > 0 and bi == 0) else 1))
                inplanes = planes * ClipBottleneck.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.n_stages = len(stages)
        self.attnpool = AttentionPool2d(input_size // 32, width * 32, width * 32 // 64, out_dim)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = (), pool_mode: str = "avg"):
        """x [B, C, H, W] -> (embedding [B, out_dim], {name: pooled [B, C_l] f32})."""
        captured: Dict[str, torch.Tensor] = {}
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)  # grayscale -> RGB (CLIP preprocess converts)
        for i in (1, 2, 3):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        x = self.avgpool(x)
        if "conv1" in capture:
            captured["conv1"] = pool_activation(x.float(), pool_mode)
        for si in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{si}")(x)
            if f"layer{si}" in capture:
                captured[f"layer{si}"] = pool_activation(x.float(), pool_mode)
        return self.attnpool(x), captured


@torch.no_grad()
def init_modified_resnet_weights(module: ModifiedResNet, generator: torch.Generator) -> None:
    """Random weights from `generator`: `init_weights` for the convs, dense layers
    and BatchNorms, N(0, 1/embed_dim) for the attention pool's positional table
    (OpenAI's initializer)."""
    init_weights(module, generator)
    pos = module.attnpool.positional_embedding
    pos.copy_(torch.randn(pos.shape, generator=generator) * pos.shape[1] ** -0.5)


class ModifiedResNetTarget:
    """Dissect a CLIP ModifiedResNet's stem (`conv1`) and stages (`layer1..4`).
    `ckpt_path` is an OpenAI CLIP RN state dict (its `visual.*` entries, or a bare
    tower state dict), loaded non-strict and logged."""

    def __init__(self, variant: str = "RN50", input_size: int = 224, seed: int = 0,
                 ckpt_path: Optional[str] = None, device=None, log=print):
        dev = resolve_device(device)
        model = ModifiedResNet(variant=variant, input_size=input_size)
        init_modified_resnet_weights(model, torch.Generator().manual_seed(seed))
        if ckpt_path:
            sd = torch_state_dict(ckpt_path)
            if any(k.startswith("visual.") for k in sd):
                sd = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
            _load_non_strict(model, sd, log)
        self.model = model.to(dev).eval()
        self.device = dev

    @torch.inference_mode()
    def harvest(self, images, layers: Sequence[str], pool_mode: str = "avg"):
        _, captured = self.model(nchw_from_nhwc(images, self.device), capture=tuple(layers),
                                 pool_mode=pool_mode)
        return {k: v.cpu().numpy() for k, v in captured.items()}

    @torch.inference_mode()
    def embed_images(self, images) -> np.ndarray:
        return l2_normalized(self.model(nchw_from_nhwc(images, self.device))[0])


def _register():
    from mammodissect_torch.dissect.targets import TARGETS, take_kwargs

    for name in MODIFIED_RESNET_SPECS:
        key = f"clip_{name.lower()}"
        if key not in TARGETS:
            TARGETS.register(key, lambda name=name, key=key, **kw: ModifiedResNetTarget(
                variant=name, **take_kwargs(kw, ("input_size", "seed", "ckpt_path", "device"),
                                            key)))


_register()
