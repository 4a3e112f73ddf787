"""Target models: things that can be dissected (counterpart of
`mammodissect/dissect/targets.py`; a registry instead of the reference's eval()'d
torchvision lookups, `concept_vit/data_utils.py:38-93`).

A target exposes
  harvest(images [B, H, W, C] float32, layers, pool_mode) -> {layer: [B, C_l] float32}
and the EfficientNet targets also
  harvest_u8_dispatch(u8 [B, H, W, C], layers, pool_mode, mean, std)
      -> (activations [B, U_total] on the device, names, widths)
where `layers` are canonical names ("blocks.i", see capture.py). Every requested
layer comes from one forward. Targets:
- the EfficientNets `tiny_cnn`, `breastclip` (the Mammo-CLIP image encoder) and
  `breastclip_classifier` (the fine-tuned classifier of C-Mammo-CLIP Dissect: the
  B family, or EfficientNetV2-S with its 40 blocks for an `*efficientnetv2*` /
  `*_v2*` arch), layers "blocks.i";
- `breastclip_swin`, the Swin image tower of a Swin-towered Mammo-CLIP, layers
  "layers.i" (its stages);
- registered when their module is imported (`get_target_model` imports it): the
  OpenAI CLIP ViTs `ViT-B/32`, `ViT-B/16`, `ViT-L/14`, `clip`, `clip-cub`,
  `clip-bloodmnist` (`models/clip_vit.py`, "layers.i") and ModifiedResNets
  `clip_rn50`, `clip_rn101`, `clip_rn50x4` (`models/modified_resnet.py`, "conv1",
  "layer1".."layer4"); the torchvision ResNets `resnet18`..`resnet152`, `resnet`,
  `resnet-cub`, `resnet-bloodmnist`, `resnet18_places` (`models/resnet.py`, "conv1",
  "layer1".."layer4"); the HF ViTs `vit`, `dino`, `mae` and their `-cub` /
  `-bloodmnist` variants (`models/vit_encoder.py`, "layers.i").
All but the EfficientNets take the float32 batch path and compute in float32
(TF32 off on the card). Random weights come from an explicit torch.Generator."""
from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from mammodissect_torch.convert import (
    _load_non_strict,
    hf_state_dict,
    load_classifier_checkpoint,
    load_image_encoder_checkpoint,
)
from mammodissect_torch.device import resolve_device, resolve_dtype
from mammodissect_torch.dissect.capture import canonical_layer_name, layer_index
from mammodissect_torch.models.classifier import (
    BreastClipClassifierModule,
    arch_is_linear_probe,
    arch_variant,
)
from mammodissect_torch.models.efficientnet import EfficientNet, EfficientNetMammo
from mammodissect_torch.models.layers import init_weights
from mammodissect_torch.models.swin import SwinEncoder, drop_rel_pos_index, init_swin_weights
from mammodissect_torch.ops.normalize import u8_minmax_meanstd
from mammodissect_torch.utils.registry import Registry

TARGETS: Registry = Registry("target_model")


def take_kwargs(kw: dict, allowed: Sequence[str], target_name: str,
                aliases: Optional[dict] = None) -> dict:
    """The entries of `kw` a factory consumes (`allowed`), warning about dropped
    non-empty values. The engine forwards `finetuned_ckpt` and `num_class` to every
    target; silently ignoring a user's --finetuned_img_classifier_chkpt would
    dissect other weights than they asked for, so the drop is loud. `aliases` maps
    other spellings onto factory arguments (num_class -> num_classes)."""
    kw = dict(kw)
    for alt, canon in (aliases or {}).items():
        if alt in kw and canon not in kw:
            kw[canon] = kw.pop(alt)
    dropped = sorted(k for k, v in kw.items() if k not in allowed and v not in (None, {}, ()))
    if dropped:
        warnings.warn(
            f"target {target_name!r} ignores {dropped}: it takes its weights only from "
            "ckpt_path; the model dissected will NOT reflect these arguments", stacklevel=3)
    return {k: v for k, v in kw.items() if k in allowed}


class EfficientNetTarget:
    """Dissect an EfficientNet's MBConv blocks ('blocks.i').

    `model` is an EfficientNet, an EfficientNetMammo or a classifier whose
    `image_encoder` is one; called with a capture it returns
    (features or logits, {"blocks.i": pooled [B, C_i] float32})."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model.to(device).eval()
        self.device = torch.device(device)
        self.tower = getattr(model, "image_encoder", model)

    def capture_plan(self, layers: Sequence[str]):
        """(captured block indices, sorted names, widths) of `layers`."""
        capture = tuple(sorted({layer_index(canonical_layer_name(l)) for l in layers}))
        names = [f"blocks.{i}" for i in capture]
        widths = tuple(self.tower.block_args[i].output_filters for i in capture)
        return capture, names, widths

    def _forward(self, x: torch.Tensor, layers, pool_mode: str):
        capture, names, widths = self.capture_plan(layers)
        _, captured = self.model(x, capture=capture, pool_mode=pool_mode)
        return torch.cat([captured[n] for n in names], dim=-1), names, widths

    @torch.inference_mode()
    def harvest(self, images: np.ndarray, layers: Sequence[str], pool_mode: str = "avg"):
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        packed, names, widths = self._forward(x, layers, pool_mode)
        packed = packed.cpu().numpy()
        out, off = {}, 0
        for name, w in zip(names, widths):
            out[name] = packed[:, off:off + w]
            off += w
        return out

    @torch.inference_mode()
    def harvest_u8_dispatch(self, images_u8, layers: Sequence[str], pool_mode: str,
                            mean: float, std: float):
        """Queue the harvest of one uint8 batch (numpy or a CPU tensor, pinned for an
        asynchronous copy) on the device, normalized there (min-max + mean/std,
        `Datasets/dataset_concepts.py:212-215`). Returns (activations [B, U_total]
        float32 on the device, names, widths); the caller reads the activations
        later, so the next batch can be queued first."""
        u8 = torch.as_tensor(images_u8).to(self.device, non_blocking=True)
        return self._forward(u8_minmax_meanstd(u8, mean, std), layers, pool_mode)


def _random(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    init_weights(module, torch.Generator().manual_seed(seed))
    return module


@TARGETS.register("tiny_cnn")
def _tiny_cnn(seed: int = 0, in_channels: int = 1, device=None, **kw):
    """Small EfficientNet-B0 target for tests (64x64 inputs)."""
    take_kwargs(kw, ("num_class",), "tiny_cnn")
    dev = resolve_device(device)
    return EfficientNetTarget(_random(EfficientNet("efficientnet-b0", in_channels=in_channels),
                                      seed), dev)


@TARGETS.register("breastclip")
def _breastclip_encoder(ckpt_path: Optional[str] = None, variant: str = "efficientnet-b5",
                        seed: int = 0, dtype="bfloat16", in_channels: int = 3, device=None,
                        **kw):
    """The Mammo-CLIP EfficientNet-B5 image encoder (`utils.py:434-446`: the 3-channel
    '-detect' tower; grayscale probes broadcast on the device), from the Mammo-CLIP
    checkpoint when given. Compute dtype bf16 by default (BatchNorm and the captured
    activations stay float32)."""
    take_kwargs(kw, ("num_class", "image_shape"), "breastclip")
    dev = resolve_device(device)
    model = _random(EfficientNetMammo(variant, in_channels=in_channels,
                                      dtype=resolve_dtype(dtype)), seed)
    if ckpt_path:
        load_image_encoder_checkpoint(ckpt_path, model)
    return EfficientNetTarget(model, dev)


@TARGETS.register("breastclip_classifier")
def _breastclip_classifier(ckpt_path: Optional[str] = None,
                           finetuned_ckpt: Optional[str] = None, num_class: int = 1,
                           arch: str = "upmc_breast_clip_det_b5_period_n_ft", seed: int = 0,
                           device=None, **kw):
    """The fine-tuned classifier of C-Mammo-CLIP Dissect
    (`Classifiers/models/breast_clip_classifier.py:6-81`; the hooks still target the
    encoder's `_blocks`, `run_clipdissect.sh:12-36`), float32 as in the JAX package.
    Loads the Mammo-CLIP encoder from `ckpt_path`, then the fine-tuned `.pth` over
    it when given (the reference's, or one `train.checkpoints` wrote)."""
    take_kwargs(kw, ("image_shape",), "breastclip_classifier")
    variant = arch_variant(arch)  # the B family, or V2-S for *efficientnetv2* / *_v2*
    if finetuned_ckpt and os.path.isdir(finetuned_ckpt):
        raise NotImplementedError(
            f"finetuned_ckpt {finetuned_ckpt!r} is an orbax directory, a checkpoint of the "
            "JAX package's trainer, which cannot be read without jax; the port loads torch "
            ".pth files, such as those its own fine-tuning writes "
            "(python -m mammodissect_torch.cli.finetune)")
    dev = resolve_device(device)
    module = _random(BreastClipClassifierModule(variant=variant, n_class=num_class,
                                                freeze_encoder=arch_is_linear_probe(arch)), seed)
    for path in (ckpt_path, finetuned_ckpt):
        if path:
            load_classifier_checkpoint(path, module)
    return EfficientNetTarget(module, dev)


class SwinTarget:
    """Dissect the stages ("layers.i") of a Swin-towered Mammo-CLIP image encoder,
    the reference's `load_image_encoder` swin option (`model/modules/__init__.py:14-33`);
    each stage's [B, H, W, C] output pools by the 4-D rule. Random weights from
    `seed`, or an HF Swin checkpoint at `hf_ckpt` / `ckpt_path` (`swin.` stripped,
    loaded non-strict and logged). `spec` ({"embed", "depths", "heads"}) gives a
    custom geometry for this target only; `input_size` is accepted for the JAX
    factory's signature."""

    def __init__(self, variant: str = "swin-tiny", in_channels: int = 3, patch_size: int = 4,
                 window: int = 7, input_size: int = 224, seed: int = 0,
                 hf_ckpt: Optional[str] = None, spec: Optional[dict] = None,
                 ckpt_path: Optional[str] = None, device=None, log=print, **kw):
        take_kwargs(kw, ("num_class",), "breastclip_swin")
        dev = resolve_device(device)
        model = SwinEncoder(variant=variant, patch_size=patch_size, window=window,
                            in_channels=in_channels, spec=spec)
        init_swin_weights(model, torch.Generator().manual_seed(seed))
        path = hf_ckpt or ckpt_path
        if path:
            _load_non_strict(model, drop_rel_pos_index(hf_state_dict(path, "swin.")), log)
        self.model = model.to(dev).eval()
        self.device = dev

    @torch.inference_mode()
    def harvest(self, images, layers: Sequence[str], pool_mode: str = "avg"):
        capture = tuple(sorted({layer_index(canonical_layer_name(l)) for l in layers}))
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        _, captured = self.model(x, capture=capture, pool_mode=pool_mode)
        return {k: v.cpu().numpy() for k, v in captured.items()}


TARGETS.register("breastclip_swin", SwinTarget)


# the HF ViT names (`concept_vit/data_utils.py:21-36`), registered by models/vit_encoder.py
VIT_ENCODER_TARGETS = ("vit", "dino", "mae", "vit-cub", "vit-bloodmnist", "dino-cub",
                       "dino-bloodmnist", "mae-cub", "mae-bloodmnist")


def get_target_model(name: str, **kw):
    if name not in TARGETS:
        # model-backed targets register on import. Exact names come before the
        # prefix rules: the JAX dispatch sends "vit-bloodmnist" (prefix "vit-b") to
        # the CLIP module, which does not register it, and resolves `clip_rn*` only
        # after an explicit import
        low = name.lower()
        if name in VIT_ENCODER_TARGETS:
            import mammodissect_torch.models.vit_encoder  # noqa: F401
        elif low.startswith("resnet"):
            import mammodissect_torch.models.resnet  # noqa: F401
        elif low.startswith("clip_rn"):
            import mammodissect_torch.models.modified_resnet  # noqa: F401
        elif low.startswith(("vit-b", "vit-l", "rn", "clip")):
            import mammodissect_torch.models.clip_vit  # noqa: F401
        elif low.startswith(("vit", "dino", "mae")):
            import mammodissect_torch.models.vit_encoder  # noqa: F401
    return TARGETS.get(name)(**kw)
