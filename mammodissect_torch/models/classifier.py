"""The fine-tuned Mammo-CLIP classifier, the target of C-Mammo-CLIP Dissect
(counterpart of `mammodissect/models/classifier.py`).

`BreastClipClassifierModule` is the reference's `BreastClipClassifier`
(`Classifiers/models/breast_clip_classifier.py:6-81`): the Mammo-CLIP EfficientNet
image encoder ('-detect' tower, average-pooled) and a linear head. Its submodules
carry the reference's names, `image_encoder.*` and `classifier.fc.*`, so a
fine-tuned `.pth` loads with `load_state_dict` (`convert.load_classifier_checkpoint`).
Compute dtype float32 by default, as in the JAX package (the C-dissect target).
Fine-tuning builds it with float32 master weights and bf16 compute
(`param_dtype=torch.float32, dtype=torch.bfloat16`), trains it in training mode
(batch-statistics BatchNorm, drop-connect from a generator, optional remat), and
freezes the encoder of '*_lp' archs with `frozen_param_labels`. The EfficientNetV2
archs (`*efficientnetv2*`, `*_v2*`) build the V2-S encoder.

`MammoEfficientNetModule` is the reference's timm-style `MammoEfficientNet`
(`model/mamo_efficient_net.py:16-91`): the backbone, GeM pooling and a single-logit
`fc`, named `encoder.*` and `fc.*`.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from mammodissect_torch.models.efficientnet import EfficientNetMammo
from mammodissect_torch.models.layers import Linear, LinearClassifier


class BreastClipClassifierModule(nn.Module):
    """EfficientNet(-Mammo) encoder + linear head.

    forward(images [B, H, W, C] NHWC, capture=(i, ...), pool_mode) -> logits
    [B, n_class], or (logits, {"blocks.i": pooled [B, C_i] float32}) with a capture.
    `freeze_encoder` ('*_lp' linear-probe archs) keeps the encoder in eval mode
    when the module is put in training mode, as the reference's
    `MammoClassification.train()` does (`model/image_classification.py:50-61`).
    `dtype` is the compute dtype, `param_dtype` the storage dtype (default:
    `dtype`); `bn_momentum`, `pad_mode` and `remat` go to the encoder."""

    def __init__(self, variant: str = "efficientnet-b5", in_channels: int = 3,
                 n_class: int = 1, freeze_encoder: bool = False,
                 dtype: torch.dtype = torch.float32, param_dtype: Optional[torch.dtype] = None,
                 bn_momentum: float = 0.99, pad_mode: str = "static", remat: bool = False):
        super().__init__()
        self.freeze_encoder = freeze_encoder
        # the reference rebuilds the '-detect' encoder from the CLIP checkpoint's
        # config and feeds it RGB copies of the grayscale mammograms: 3 channels
        self.image_encoder = EfficientNetMammo(
            variant=variant, in_channels=in_channels, pooling="avg", dtype=dtype,
            param_dtype=param_dtype, bn_momentum=bn_momentum, pad_mode=pad_mode, remat=remat)
        self.classifier = LinearClassifier(self.image_encoder.out_dim, n_class)
        param_dtype = dtype if param_dtype is None else param_dtype
        self.classifier.to(param_dtype)
        if param_dtype != dtype:
            self.classifier.fc.compute_dtype = dtype

    def train(self, mode: bool = True):
        super().train(mode)
        if self.freeze_encoder:
            self.image_encoder.eval()
        return self

    def encode_image(self, images: torch.Tensor, capture: Sequence[int] = (),
                     pool_mode: str = "avg", generator: Optional[torch.Generator] = None):
        return self.image_encoder(images, capture=capture, pool_mode=pool_mode,
                                  generator=generator)

    def forward(self, images: torch.Tensor, capture: Sequence[int] = (),
                pool_mode: str = "avg", generator: Optional[torch.Generator] = None):
        """`generator` draws the drop-connect masks of a training forward."""
        pooled, captured = self.encode_image(images, capture=capture, pool_mode=pool_mode,
                                             generator=generator)
        logits = self.classifier(pooled)
        return (logits, captured) if capture else logits


class MammoEfficientNetModule(nn.Module):
    """Backbone + GeM + single-logit fc (`mammodissect/models/classifier.py:100-118`).

    forward(x [B, H, W, C] NHWC) -> logits [B, n_class], or (pooled [B, D] float32,
    logits) with `return_features`. `dtype` computes and stores, as in the encoder;
    the encoder keeps its static padding and flax's momentum, as in JAX."""

    def __init__(self, variant: str = "efficientnet-b5", in_channels: int = 1,
                 n_class: int = 1, return_features: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_features = return_features
        self.encoder = EfficientNetMammo(variant=variant, in_channels=in_channels,
                                         pooling="gem", dtype=dtype)
        self.fc = Linear(self.encoder.out_dim, n_class).to(dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """`generator` draws the drop-connect masks of a training forward."""
        pooled, _ = self.encoder(x, generator=generator)
        logits = self.fc(pooled)
        return (pooled, logits) if self.return_features else logits


def frozen_param_labels(module: nn.Module, freeze_encoder: bool) -> Dict[str, str]:
    """{parameter name: "frozen" | "train"}: the encoder's parameters are frozen when
    linear-probing, everything else trains (the JAX package's optax label tree;
    `train.trainer.make_optimizer` gives frozen parameters no update, no weight
    decay and no Adam state, as the reference's requires_grad=False at
    `breast_clip_classifier.py:41-49`)."""
    return {name: "frozen" if freeze_encoder and name.startswith("image_encoder.") else "train"
            for name, _ in module.named_parameters()}


def arch_is_linear_probe(arch: str) -> bool:
    """'*_lp' archs are linear probes (`breast_clip_classifier.py:41`)."""
    return arch.endswith("_lp")


def arch_variant(arch: str) -> str:
    """The EfficientNet variant of a reference arch string
    (upmc_breast_clip_det_b5_period_n_ft, ..._b2_..., any bN tag; default b5)."""
    if "efficientnetv2" in arch or "_v2" in arch:
        return "efficientnetv2-s"
    if "_test_" in arch or arch.endswith("_test"):
        return "efficientnet-test"  # the 7-block test variant
    m = re.search(r"_b([0-7])(_|$)", arch)
    if m:
        return f"efficientnet-b{m.group(1)}"
    return "efficientnet-b5"
