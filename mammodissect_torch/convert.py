"""Weight conversion into the port's state-dict layout.

- `breastclip_from_jax(variables)`: the JAX package's BreastClipModule variables
  (Flax params + batch_stats, as numpy) -> the port's state dict. The inverse of
  `mammodissect/utils/torch_convert.py`: HWIO -> OIHW for convolutions (the
  depthwise [k, k, 1, C] -> [C, 1, k, k] by the same transpose), Dense [in, out] ->
  Linear [out, in], BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
  running_var, LayerNorm scale/bias -> weight/bias. It lets a test run the same
  weights through both packages.
- `classifier_from_jax(variables)`: the JAX package's BreastClipClassifierModule
  variables -> the port's classifier state dict (`image_encoder.*`, `classifier.fc.*`),
  B family or V2.
- `mammo_efficientnet_from_jax(variables)`: the JAX package's
  MammoEfficientNetModule variables -> the port's (`encoder.*`, `fc.*`).
- `clip_from_jax(variables)`: the JAX package's ClipModule params -> the port's
  ClipModule state dict in OpenAI's names (the inverse of `clip_torch_to_flax`);
  vision-only and text-only trees give the entries of their tower.
- `modified_resnet_from_jax(variables)`: the JAX package's ModifiedResNet
  {"params", "batch_stats"} -> the port's ModifiedResNet state dict (OpenAI's
  names without `visual.`).
- `resnet_from_jax(variables)`, `vit_encoder_from_jax(params)`,
  `swin_from_jax(params)`: the target zoo's towers -> torchvision / HF `ViTModel` /
  HF `SwinModel` names (the inverses of `resnet_torch_to_flax`,
  `vit_torch_to_flax` and `swin_torch_to_flax`; the Swin one splits the fused
  `qkv` Dense back into query, key and value).
- `load_breastclip_checkpoint(path, module)`: a reference Mammo-CLIP `.tar`
  ({"model": state_dict, "config": ...}) into a BreastClipModule. The names already
  match; the loader strips DDP's `module.` prefix and maps the text tower's
  `text_encoder.bert.` / `text_encoder.model.` prefix to `text_encoder.`.
- `load_classifier_checkpoint(path, module)`: the image encoder (and the linear
  head, when the file has one) of a Mammo-CLIP `.tar` or a fine-tuned classifier
  `.pth` into a BreastClipClassifierModule, non-strict as the reference loads it.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(kernel) -> torch.Tensor:  # HWIO -> OIHW
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel), (3, 2, 0, 1))))


def _dense(kernel) -> torch.Tensor:  # [in, out] -> [out, in]
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel).T))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _bn(sd, dst, params, stats):
    sd[f"{dst}.weight"] = _t(params["scale"])
    sd[f"{dst}.bias"] = _t(params["bias"])
    sd[f"{dst}.running_mean"] = _t(stats["mean"])
    sd[f"{dst}.running_var"] = _t(stats["var"])


def _linear(sd, dst, params):
    sd[f"{dst}.weight"] = _dense(params["kernel"])
    if "bias" in params:
        sd[f"{dst}.bias"] = _t(params["bias"])


def _layer_norm(sd, dst, params):
    sd[f"{dst}.weight"] = _t(params["scale"])
    sd[f"{dst}.bias"] = _t(params["bias"])


def efficientnet_from_jax(params: Mapping, stats: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """One EfficientNet backbone's Flax params/batch_stats -> lukemelas names (the
    B family's MBConv blocks and V2's FusedMBConv blocks)."""
    sd: Dict[str, torch.Tensor] = {}
    sd[f"{prefix}_conv_stem.weight"] = _conv(params["stem_conv"]["kernel"])
    _bn(sd, f"{prefix}_bn0", params["stem_bn"], stats["stem_bn"])
    i = 0
    while f"blocks_{i}" in params:
        p, s, dst = params[f"blocks_{i}"], stats[f"blocks_{i}"], f"{prefix}_blocks.{i}"
        if "expand_conv" in p:
            sd[f"{dst}._expand_conv.weight"] = _conv(p["expand_conv"]["kernel"])
            _bn(sd, f"{dst}._bn0", p["bn0"], s["bn0"])
        if "depthwise_conv" in p:  # MBConv; a FusedMBConv block (V2) has none
            sd[f"{dst}._depthwise_conv.weight"] = _conv(p["depthwise_conv"]["kernel"])
            _bn(sd, f"{dst}._bn1", p["bn1"], s["bn1"])
        if "se" in p:
            for name in ("se_reduce", "se_expand"):
                sd[f"{dst}._{name}.weight"] = _conv(p["se"][name]["kernel"])
                sd[f"{dst}._{name}.bias"] = _t(p["se"][name]["bias"])
        sd[f"{dst}._project_conv.weight"] = _conv(p["project_conv"]["kernel"])
        _bn(sd, f"{dst}._bn2", p["bn2"], s["bn2"])
        i += 1
    sd[f"{prefix}_conv_head.weight"] = _conv(params["head_conv"]["kernel"])
    _bn(sd, f"{prefix}_bn1", params["head_bn"], stats["head_bn"])
    return sd


def bert_from_jax(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The Flax BertEncoder's params -> HuggingFace BertModel names."""
    sd: Dict[str, torch.Tensor] = {}
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"{prefix}embeddings.{name}.weight"] = _t(params[name]["embedding"])
    _layer_norm(sd, f"{prefix}embeddings.LayerNorm", params["embeddings_norm"])
    i = 0
    while f"layers_{i}" in params:
        p, dst = params[f"layers_{i}"], f"{prefix}encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _linear(sd, f"{dst}.attention.self.{name}", p["attention"][name])
        _linear(sd, f"{dst}.attention.output.dense", p["attention_output"])
        _layer_norm(sd, f"{dst}.attention.output.LayerNorm", p["attention_norm"])
        _linear(sd, f"{dst}.intermediate.dense", p["intermediate"])
        _linear(sd, f"{dst}.output.dense", p["output"])
        _layer_norm(sd, f"{dst}.output.LayerNorm", p["output_norm"])
        i += 1
    return sd


def breastclip_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX BreastClipModule variables {"params", "batch_stats"} (numpy leaves) ->
    state dict of the port's BreastClipModule (a CNN, Swin or ViT image tower)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    image = params["image_encoder"]
    if "backbone" in image:
        sd = efficientnet_from_jax(image["backbone"], stats["image_encoder"]["backbone"],
                                   prefix="image_encoder.")
        if "pool" in image:  # GeM
            sd["image_encoder.pool.p"] = _t(image["pool"]["p"])
    else:
        tower = swin_from_jax(image) if "patch_norm" in image else vit_encoder_from_jax(image)
        sd = {f"image_encoder.{k}": v for k, v in tower.items()}
    sd.update(bert_from_jax(params["text_encoder"], prefix="text_encoder."))
    for side in ("image_projection", "text_projection"):
        head = params[side]
        _linear(sd, f"{side}.projection", head["projection"])
        if "fc" in head:  # MLP head
            _linear(sd, f"{side}.fc", head["fc"])
            _layer_norm(sd, f"{side}.layer_norm", head["layer_norm"])
    sd["logit_scale"] = _t(params["logit_scale"])
    return sd


def classifier_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX BreastClipClassifierModule variables {"params", "batch_stats"} (numpy
    leaves) -> state dict of the port's BreastClipClassifierModule."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = efficientnet_from_jax(params["image_encoder"]["backbone"],
                               stats["image_encoder"]["backbone"], prefix="image_encoder.")
    _linear(sd, "classifier.fc", params["classifier"]["fc"])
    return sd


def mammo_efficientnet_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX MammoEfficientNetModule variables {"params", "batch_stats"} (numpy
    leaves) -> state dict of the port's MammoEfficientNetModule (`encoder.*` with
    the GeM exponent `encoder.pool.p`, `fc.*`)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = efficientnet_from_jax(params["encoder"]["backbone"], stats["encoder"]["backbone"],
                               prefix="encoder.")
    sd["encoder.pool.p"] = _t(params["encoder"]["pool"]["p"])
    _linear(sd, "fc", params["fc"])
    return sd


def _clip_blocks(sd, tower: Mapping, dst: str) -> None:
    i = 0
    while f"resblocks_{i}" in tower:
        p, d = tower[f"resblocks_{i}"], f"{dst}.resblocks.{i}"
        sd[f"{d}.attn.in_proj_weight"] = _dense(p["attn_in"]["kernel"])
        sd[f"{d}.attn.in_proj_bias"] = _t(p["attn_in"]["bias"])
        _linear(sd, f"{d}.attn.out_proj", p["attn_out"])
        _linear(sd, f"{d}.mlp.c_fc", p["mlp_fc"])
        _linear(sd, f"{d}.mlp.c_proj", p["mlp_proj"])
        _layer_norm(sd, f"{d}.ln_1", p["ln_1"])
        _layer_norm(sd, f"{d}.ln_2", p["ln_2"])
        i += 1


def clip_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ClipModule variables {"params": ...} (numpy leaves) -> state dict of the
    port's ClipModule, OpenAI's names."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    if "visual" in params:
        v = params["visual"]
        sd["visual.conv1.weight"] = _conv(v["conv1"]["kernel"])
        for name in ("class_embedding", "positional_embedding", "proj"):
            if name in v:
                sd[f"visual.{name}"] = _t(v[name])
        _layer_norm(sd, "visual.ln_pre", v["ln_pre"])
        _layer_norm(sd, "visual.ln_post", v["ln_post"])
        _clip_blocks(sd, v, "visual.transformer")
    if "text" in params:
        t = params["text"]
        sd["token_embedding.weight"] = _t(t["token_embedding"]["embedding"])
        sd["positional_embedding"] = _t(t["positional_embedding"])
        sd["text_projection"] = _t(t["text_projection"])
        _layer_norm(sd, "ln_final", t["ln_final"])
        _clip_blocks(sd, t, "transformer")
    if "logit_scale" in params:
        sd["logit_scale"] = _t(params["logit_scale"])
    return sd


def modified_resnet_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ModifiedResNet variables {"params", "batch_stats"} (numpy leaves) -> state
    dict of the port's ModifiedResNet."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        sd[f"conv{i}.weight"] = _conv(params[f"conv{i}"]["kernel"])
        _bn(sd, f"bn{i}", params[f"bn{i}"], stats[f"bn{i}"])
    si = 1
    while f"layer{si}_0" in params:
        bi = 0
        while f"layer{si}_{bi}" in params:
            p, s, dst = params[f"layer{si}_{bi}"], stats[f"layer{si}_{bi}"], f"layer{si}.{bi}"
            for ci in (1, 2, 3):
                sd[f"{dst}.conv{ci}.weight"] = _conv(p[f"conv{ci}"]["kernel"])
                _bn(sd, f"{dst}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
            if "downsample_conv" in p:
                sd[f"{dst}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
                _bn(sd, f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])
            bi += 1
        si += 1
    pool = params["attnpool"]
    sd["attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for side in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(sd, f"attnpool.{side}", pool[side])
    return sd


def resnet_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ResNet variables {"params", "batch_stats"} (numpy leaves) -> state dict
    of the port's ResNet, torchvision's names."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {"conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    for name in params:
        if not name.startswith("layer"):
            continue
        p, s, dst = params[name], stats[name], name.replace("_", ".")  # layer2_0 -> layer2.0
        for ci in (1, 2, 3):
            if f"conv{ci}" in p:
                sd[f"{dst}.conv{ci}.weight"] = _conv(p[f"conv{ci}"]["kernel"])
                _bn(sd, f"{dst}.bn{ci}", p[f"bn{ci}"], s[f"bn{ci}"])
        if "downsample_conv" in p:
            sd[f"{dst}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
            _bn(sd, f"{dst}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    _linear(sd, "fc", params["fc"])
    return sd


def _patch_embed(sd, dst: str, params) -> None:
    sd[f"{dst}.weight"] = _conv(params["kernel"])
    sd[f"{dst}.bias"] = _t(params["bias"])


def vit_encoder_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ViTImageEncoder params (numpy leaves) -> state dict of the port's
    ViTImageEncoder, HF `ViTModel`'s names."""
    sd: Dict[str, torch.Tensor] = {}
    _patch_embed(sd, "embeddings.patch_embeddings.projection", params["patch_embed"])
    sd["embeddings.cls_token"] = _t(params["cls_token"])
    sd["embeddings.position_embeddings"] = _t(params["pos_embed"])
    i = 0
    while f"layers_{i}" in params:
        p, dst = params[f"layers_{i}"], f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _linear(sd, f"{dst}.attention.attention.{name}", p[name])
        _linear(sd, f"{dst}.attention.output.dense", p["attn_out"])
        _linear(sd, f"{dst}.intermediate.dense", p["mlp_in"])
        _linear(sd, f"{dst}.output.dense", p["mlp_out"])
        _layer_norm(sd, f"{dst}.layernorm_before", p["ln_before"])
        _layer_norm(sd, f"{dst}.layernorm_after", p["ln_after"])
        i += 1
    _layer_norm(sd, "layernorm", params["ln_final"])
    return sd


def swin_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX SwinEncoder params (numpy leaves) -> state dict of the port's SwinEncoder,
    HF `SwinModel`'s names; the fused `qkv` Dense is split into query, key, value."""
    sd: Dict[str, torch.Tensor] = {}
    _patch_embed(sd, "embeddings.patch_embeddings.projection", params["patch_embed"])
    _layer_norm(sd, "embeddings.norm", params["patch_norm"])
    si = 0
    while f"stage{si}_block0" in params:
        bi = 0
        while f"stage{si}_block{bi}" in params:
            p, dst = params[f"stage{si}_block{bi}"], f"encoder.layers.{si}.blocks.{bi}"
            _layer_norm(sd, f"{dst}.layernorm_before", p["ln1"])
            _layer_norm(sd, f"{dst}.layernorm_after", p["ln2"])
            attn = p["attn"]
            kernels = np.split(np.asarray(attn["qkv"]["kernel"]), 3, axis=1)
            biases = np.split(np.asarray(attn["qkv"]["bias"]), 3)
            for name, kernel, bias in zip(("query", "key", "value"), kernels, biases):
                _linear(sd, f"{dst}.attention.self.{name}", {"kernel": kernel, "bias": bias})
            sd[f"{dst}.attention.self.relative_position_bias_table"] = _t(attn["rel_pos_bias"])
            _linear(sd, f"{dst}.attention.output.dense", attn["proj"])
            _linear(sd, f"{dst}.intermediate.dense", p["mlp_in"])
            _linear(sd, f"{dst}.output.dense", p["mlp_out"])
            bi += 1
        if f"merge{si}" in params:
            merge = params[f"merge{si}"]
            _linear(sd, f"encoder.layers.{si}.downsample.reduction", merge["reduction"])
            _layer_norm(sd, f"encoder.layers.{si}.downsample.norm", merge["ln"])
        si += 1
    _layer_norm(sd, "layernorm", params["ln_final"])
    return sd


def torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint file: `{"model": sd, ...}` or a bare
    state dict, without DDP's `module.` prefix."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    sd = {k: v for k, v in sd.items() if isinstance(v, torch.Tensor)}
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def hf_state_dict(path: str, prefix: str) -> Dict[str, torch.Tensor]:
    """The tensors of a checkpoint file holding a state dict or a pickled module
    (the HF ViT / Swin checkpoints), without `prefix` (`vit.`, `swin.`) on their
    names when any name carries it."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(raw, "state_dict"):
        raw = raw.state_dict()
    sd = {k: v for k, v in raw.items() if isinstance(v, torch.Tensor)}
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def _load_non_strict(module: torch.nn.Module, sd: Mapping, log) -> None:
    result = module.load_state_dict(sd, strict=False)
    if result.missing_keys or result.unexpected_keys:
        log(f"[convert] {len(result.missing_keys)} missing, {len(result.unexpected_keys)} "
            f"unexpected entries (strict=False): "
            f"{(result.missing_keys + result.unexpected_keys)[:5]}...")


_TEXT_PREFIXES = ("text_encoder.bert.", "text_encoder.model.")
_KEPT_PREFIXES = ("image_encoder.", "text_encoder.", "image_projection.", "text_projection.",
                  "logit_scale")


def load_breastclip_checkpoint(path: str, module: torch.nn.Module, log=print) -> None:
    """Load a reference Mammo-CLIP checkpoint into `module` (strict=False, as the
    reference loads it: matching names load, the rest is reported)."""
    mapped = {}
    for k, v in torch_state_dict(path).items():
        for pre in _TEXT_PREFIXES:
            if k.startswith(pre):
                k = "text_encoder." + k[len(pre):]
                break
        if k.startswith(_KEPT_PREFIXES):
            mapped[k] = v
    _load_non_strict(module, mapped, log)


def load_image_encoder_checkpoint(path: str, encoder: torch.nn.Module, log=print) -> None:
    """Load the `image_encoder.*` entries of a Mammo-CLIP checkpoint into an
    EfficientNetMammo (the `breastclip` target), strict=False."""
    sd = {k[len("image_encoder."):]: v for k, v in torch_state_dict(path).items()
          if k.startswith("image_encoder.")}
    _load_non_strict(encoder, sd, log)


def load_classifier_checkpoint(path: str, module: torch.nn.Module, log=print) -> None:
    """Load the `image_encoder.*` and `classifier.fc.*` entries of a torch checkpoint
    (a Mammo-CLIP `.tar`: the encoder; a fine-tuned classifier `.pth`: both) into a
    BreastClipClassifierModule, strict=False (`Classifiers/` fine-tuned checkpoints,
    `targets.py:316-338` of the JAX package)."""
    sd = {k: v for k, v in torch_state_dict(path).items()
          if k.startswith(("image_encoder.", "classifier.fc."))}
    _load_non_strict(module, sd, log)
