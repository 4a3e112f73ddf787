"""The torchvision ResNet family in PyTorch (counterpart of
`mammodissect/models/resnet.py`): the CLIP-Dissect targets resnet18/34/50/101/152 and
resnet18_places, hooked at conv1 and layer1..layer4 (`describe_clip_neurons.py`
defaults; `concept_vit/data_utils.py:80-89`).

- Parameter names are torchvision's: `conv1`, `bn1`, `layerN.M.convK` / `bnK`, the
  shortcut `layerN.M.downsample.0` (conv) / `.1` (BatchNorm), `fc`, so a torchvision
  or Places365 state dict loads with `load_state_dict`.
- BatchNorm in eval, eps 1e-5 (flax momentum 0.9 = torch 0.1), in float32.
- The stem's max pool pads with -inf (torch's `max_pool2d` padding, the JAX module's
  explicit -inf pad): after the ReLU it is the same as zero padding.
- A grayscale input is repeated to 3 channels (the reference's preprocess converts
  to RGB).
- `capture` pools `conv1` as the reference hooks it, the conv module's output before
  BatchNorm and ReLU (`utils.py:80`), and `layer1..4` after each stage. The towers
  run NCHW; `ResNetTarget` takes NHWC numpy.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple, Type

import torch
import torch.nn.functional as F
from torch import nn

from mammodissect_torch.convert import _load_non_strict
from mammodissect_torch.device import resolve_device
from mammodissect_torch.models.layers import (
    BatchNorm2d,
    Conv2d,
    Linear,
    init_weights,
    nchw_from_nhwc,
)
from mammodissect_torch.ops.pooling import pool_activation


def _bn(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


def _downsample(inplanes: int, out: int, stride: int) -> Optional[nn.Sequential]:
    if stride == 1 and inplanes == out:
        return None
    return nn.Sequential(OrderedDict([("0", Conv2d(inplanes, out, 1, stride=stride, bias=False)),
                                      ("1", _bn(out))]))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.downsample = _downsample(inplanes, planes, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = _bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(planes)
        self.conv3 = Conv2d(planes, out, 1, bias=False)
        self.bn3 = _bn(out)
        self.downsample = _downsample(inplanes, out, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


RESNET_SPECS: Dict[str, Tuple[Type[nn.Module], Tuple[int, ...]]] = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}


class ResNet(nn.Module):
    def __init__(self, variant: str = "resnet50", num_classes: int = 1000):
        super().__init__()
        block, stages = RESNET_SPECS[variant]
        self.variant, self.num_classes = variant, num_classes
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        inplanes, planes = 64, 64
        for si, n_blocks in enumerate(stages):
            blocks = []
            for bi in range(n_blocks):
                blocks.append(block(inplanes, planes, 2 if (si > 0 and bi == 0) else 1))
                inplanes = planes * block.expansion
            setattr(self, f"layer{si + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.n_stages = len(stages)
        self.fc = Linear(inplanes, num_classes)

    def forward(self, x: torch.Tensor, capture: Sequence[str] = (), pool_mode: str = "avg"):
        """x [B, C, H, W] -> (logits [B, num_classes], {name: pooled [B, C_l] f32})."""
        captured: Dict[str, torch.Tensor] = {}
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        x = self.conv1(x)
        if "conv1" in capture:
            captured["conv1"] = pool_activation(x.float(), pool_mode)
        x = F.max_pool2d(F.relu(self.bn1(x)), 3, stride=2, padding=1)  # pads with -inf
        for si in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{si}")(x)
            if f"layer{si}" in capture:
                captured[f"layer{si}"] = pool_activation(x.float(), pool_mode)
        return self.fc(x.mean(dim=(2, 3))), captured


def resnet_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torchvision or Places365 ResNet checkpoint's state dict: unwrapped from
    {"state_dict": ...} (the Places365 layout), "module." removed from every name."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items() if isinstance(v, torch.Tensor)}


class ResNetTarget:
    """Dissect a ResNet's `conv1` and `layer1..4`. Random weights from `seed`, or a
    torchvision / Places365 checkpoint at `ckpt_path`, loaded non-strict and logged.
    `input_size` is accepted for the JAX factory's signature; the eager model needs
    no example input."""

    def __init__(self, variant: str = "resnet50", num_classes: int = 1000,
                 ckpt_path: Optional[str] = None, seed: int = 0, input_size: int = 224,
                 device=None, log=print):
        dev = resolve_device(device)
        model = ResNet(variant=variant, num_classes=num_classes)
        init_weights(model, torch.Generator().manual_seed(seed))
        if ckpt_path:
            _load_non_strict(model, resnet_state_dict(ckpt_path), log)
        self.model = model.to(dev).eval()
        self.device = dev

    @torch.inference_mode()
    def harvest(self, images, layers: Sequence[str], pool_mode: str = "avg"):
        _, captured = self.model(nchw_from_nhwc(images, self.device), capture=tuple(layers),
                                 pool_mode=pool_mode)
        return {k: v.cpu().numpy() for k, v in captured.items()}


def _register():
    from mammodissect_torch.dissect.targets import TARGETS, take_kwargs

    allowed = ("num_classes", "ckpt_path", "seed", "input_size", "device")
    alias = {"num_class": "num_classes"}  # the engine's spelling
    # torchvision names, and the reference's MODELS spellings of microsoft/resnet-50
    # and its fine-tunes (`data_utils.py:25,30,34`): the resnet50 stage layout
    names = {**{n: n for n in RESNET_SPECS},
             **{a: "resnet50" for a in ("resnet", "resnet-cub", "resnet-bloodmnist")}}
    for name, variant in names.items():
        if name not in TARGETS:
            TARGETS.register(name, lambda name=name, variant=variant, **kw: ResNetTarget(
                variant=variant, **take_kwargs(kw, allowed, name, alias)))
    if "resnet18_places" not in TARGETS:
        # 365 Places classes whatever the engine's num_class says
        TARGETS.register("resnet18_places", lambda **kw: ResNetTarget(
            variant="resnet18", num_classes=365,
            **take_kwargs({k: v for k, v in kw.items() if k != "num_class"},
                          allowed[1:], "resnet18_places")))


_register()
