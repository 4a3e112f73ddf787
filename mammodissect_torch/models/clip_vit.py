"""OpenAI CLIP (ViT image tower + causal text transformer) in PyTorch (counterpart of
`mammodissect/models/clip_vit.py`), for G-dissect: the reference's
`describe_og_neurons.py` / `describe_clip_neurons.py`, where the dissector is
`clip.load("ViT-B/16")` and CLIP's 12 ViT layers are themselves dissection targets
(`run_og_clip.sh:8`).

- Parameter names are OpenAI's (`visual.conv1.weight`,
  `visual.transformer.resblocks.i.attn.in_proj_weight`, `ln_1`, `mlp.c_fc`,
  `mlp.c_proj`, `visual.proj`; the text tower at the top level: `token_embedding`,
  `positional_embedding`, `transformer.resblocks.i.*`, `ln_final`,
  `text_projection`; `logit_scale`), so an OpenAI checkpoint, or an HF one after
  `hf_clip_to_openai_layout`, loads with `load_state_dict`.
- Attention is plain matmuls and a softmax, as in the JAX module: the scores are
  scaled after q.k^T by 1/sqrt(d_head), the causal mask is added as -inf in
  float32, the softmax is taken in float32 and cast back.
- The towers run NCHW inside; the dissector and target interface takes NHWC numpy.
- `dtype` (default float32, as in JAX) is the compute dtype of the dense layers,
  the patch conv and the token embedding, with flax's promotion: LayerNorm returns
  float32, and a residual add of float32 and bf16 is float32.
- `OpenAIClip` wraps the module with the BPE tokenizer and the device: the
  dissector (`embed_images`, `embed_texts`) and target (`harvest`) interfaces;
  its `harvest` pools each captured layer's tokens to the CLS token (the 3-D rule
  of `ops/pooling.py`), whatever the pool mode.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mammodissect_torch.convert import _load_non_strict, torch_state_dict
from mammodissect_torch.device import resolve_device, resolve_dtype
from mammodissect_torch.dissect.capture import canonical_layer_name, layer_index
from mammodissect_torch.models.layers import (
    Conv2d,
    LayerNorm,
    Linear,
    attend,
    init_weights,
    l2_normalized,
    nchw_from_nhwc,
    same_pad_patches,
)
from mammodissect_torch.ops.pooling import pool_activation


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class SelfAttention(nn.Module):
    """The parameters of torch's MultiheadAttention as OpenAI CLIP stores them: the
    fused input projection [q; k; v] and `out_proj`. The computation is the
    block's."""

    def __init__(self, d_model: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = Linear(d_model, d_model)


class Mlp(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.c_fc = Linear(d_model, 4 * d_model)
        self.c_proj = Linear(4 * d_model, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)); x + mlp(ln_2(x)) with quick-GELU."""

    def __init__(self, d_model: int, n_head: int, causal: bool = False):
        super().__init__()
        self.n_head = n_head
        self.causal = causal
        self.ln_1 = LayerNorm(d_model, eps=1e-5)
        self.attn = SelfAttention(d_model)
        self.ln_2 = LayerNorm(d_model, eps=1e-5)
        self.mlp = Mlp(d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // self.n_head
        w = self.attn.in_proj_weight
        qkv = F.linear(self.ln_1(x).to(w.dtype), w, self.attn.in_proj_bias)
        q, k, v = (a.reshape(b, t, self.n_head, dh).transpose(1, 2)
                   for a in qkv.split(d, dim=-1))
        mask = (torch.full((t, t), float("-inf"), device=x.device).triu(1)
                if self.causal else None)
        ctx = attend(q, k, v, x.dtype, mask).transpose(1, 2).reshape(b, t, d)
        x = x + self.attn.out_proj(ctx)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    """`layers` blocks; their dense layers in `dtype`, their LayerNorms in float32."""

    def __init__(self, width: int, layers: int, heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal) for _ in range(layers))
        for m in self.modules():
            if isinstance(m, (nn.Linear, SelfAttention)):
                m.to(dtype)


class ClipVisionTransformer(nn.Module):
    """Patch conv (flax SAME, stride = kernel) + CLS + positional table + ln_pre,
    `layers` blocks, ln_post on the CLS token, projection."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.image_size = image_size
        grid = -(-image_size // patch_size)
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(torch.zeros(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width, eps=1e-5)
        self.transformer = Transformer(width, layers, heads, dtype=dtype)
        self.ln_post = LayerNorm(width, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, x: torch.Tensor, capture: Sequence[int] = ()):
        """x [B, 3, H, W] -> (embedding [B, output_dim], {"layers.i": [B, T, D] f32})."""
        hw = tuple(x.shape[2:])
        x = self.conv1(same_pad_patches(x, self.patch_size))
        b, width = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # [B, grid*grid, width], row-major as NHWC
        x = torch.cat([self.class_embedding.to(x.dtype).expand(b, 1, width), x], dim=1)
        if x.shape[1] != self.positional_embedding.shape[0]:
            raise ValueError(
                f"ClipVisionTransformer: a {hw[0]}x{hw[1]} input gives {x.shape[1]} "
                f"tokens (+CLS), but the positional table of image_size {self.image_size} "
                f"has {self.positional_embedding.shape[0]}; resize the probe to "
                f"{self.image_size}x{self.image_size}")
        x = self.ln_pre(x + self.positional_embedding.to(x.dtype))
        captured: Dict[str, torch.Tensor] = {}
        for i, block in enumerate(self.transformer.resblocks):
            x = block(x)
            if i in capture:
                captured[f"layers.{i}"] = x.float()
        x = self.ln_post(x[:, 0])
        return x @ self.proj.to(x.dtype), captured


class ClipTextTransformer(nn.Module):
    """Token embedding + positional table (sliced to the sequence), `layers` causal
    blocks, ln_final, the features at argmax(tokens) (EOT = 49407 is the largest
    id, `clip/model.py:354-364`), projection."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, heads: int = 8, output_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.token_embedding = nn.Embedding(vocab_size, width, dtype=dtype)
        self.positional_embedding = nn.Parameter(torch.zeros(context_length, width))
        self.transformer = Transformer(width, layers, heads, causal=True, dtype=dtype)
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens int [B, T] -> [B, output_dim]."""
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding[: tokens.shape[1]].to(x.dtype)
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_final(x)
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return x @ self.text_projection.to(x.dtype)


class ClipModule(ClipTextTransformer):
    """Both towers + logit_scale (OpenAI CLIP `clip/model.py:239-384`). OpenAI's
    layout keeps the text tower's parameters at the top level of the model, so this
    module is the text transformer plus `visual` and `logit_scale`."""

    def __init__(self, image_size: int = 224, patch_size: int = 16, vision_width: int = 768,
                 vision_layers: int = 12, vision_heads: int = 12, text_width: int = 512,
                 text_layers: int = 12, text_heads: int = 8, vocab_size: int = 49408,
                 context_length: int = 77, embed_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__(vocab_size, context_length, text_width, text_layers, text_heads,
                         embed_dim, dtype)
        self.visual = ClipVisionTransformer(image_size, patch_size, vision_width,
                                           vision_layers, vision_heads, embed_dim, dtype)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.image_size, self.patch_size, self.vision_layers = image_size, patch_size, vision_layers
        self.vocab_size, self.embed_dim = vocab_size, embed_dim

    def encode_image(self, images: torch.Tensor, capture: Sequence[int] = ()):
        emb, captured = self.visual(images, capture=capture)
        return (emb, captured) if capture else emb

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return super().forward(tokens)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        ie = self.encode_image(images)
        te = self.encode_text(tokens)
        ie = ie / torch.linalg.vector_norm(ie, dim=1, keepdim=True)
        te = te / torch.linalg.vector_norm(te, dim=1, keepdim=True)
        scale = self.logit_scale.exp()
        return scale * ie @ te.T, scale * te @ ie.T


VIT_CONFIGS = {
    "ViT-B/32": dict(patch_size=32, vision_width=768, vision_layers=12, vision_heads=12),
    "ViT-B/16": dict(patch_size=16, vision_width=768, vision_layers=12, vision_heads=12),
    "ViT-L/14": dict(patch_size=14, vision_width=1024, vision_layers=24, vision_heads=16,
                     embed_dim=768, text_width=768, text_layers=12, text_heads=12),
}


@torch.no_grad()
def init_clip_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Random weights from `generator`: `init_weights` for the dense layers, convs,
    embeddings and LayerNorms; LeCun-normal fused input projections; N(0, 0.02)
    class embedding and projections, N(0, 0.01) positional tables (the JAX
    package's initializers). logit_scale keeps log(1 / 0.07)."""
    init_weights(module, generator)

    def normal(p: torch.Tensor, std: float):
        p.copy_(torch.randn(p.shape, generator=generator) * std)

    for m in module.modules():
        if isinstance(m, SelfAttention):
            normal(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
            m.in_proj_bias.zero_()
        if isinstance(m, ClipVisionTransformer):
            normal(m.class_embedding, 0.02)
            normal(m.positional_embedding, 0.01)
            normal(m.proj, 0.02)
        if isinstance(m, ClipTextTransformer):
            normal(m.positional_embedding, 0.01)
            normal(m.text_projection, 0.02)


def clip_config_from_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """Infer ClipModule geometry from an OpenAI CLIP state dict — the capability of
    the reference's `build_model(state_dict)` (`concept_vit/clip/model.py:410-447`)."""
    cfg: Dict = {}
    if "visual.conv1.weight" in sd:
        w = sd["visual.conv1.weight"]  # [width, 3, patch, patch]
        cfg["vision_width"] = int(w.shape[0])
        cfg["patch_size"] = int(w.shape[-1])
        cfg["vision_layers"] = len({k.split(".")[3] for k in sd
                                    if k.startswith("visual.transformer.resblocks.")})
        cfg["vision_heads"] = cfg["vision_width"] // 64
        grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
        cfg["image_size"] = grid * cfg["patch_size"]
        if "visual.proj" in sd:
            cfg["embed_dim"] = int(sd["visual.proj"].shape[1])
    # vision-only checkpoints (HF CLIPVisionModel / CLIPForImageClassification
    # fine-tunes) carry no text tower: keep the named arch's text defaults
    if "ln_final.weight" in sd:
        cfg["text_width"] = int(sd["ln_final.weight"].shape[0])
        cfg["text_layers"] = len({k.split(".")[2] for k in sd
                                  if k.startswith("transformer.resblocks.")})
        cfg["text_heads"] = cfg["text_width"] // 64
        cfg["vocab_size"] = int(sd["token_embedding.weight"].shape[0])
        cfg["context_length"] = int(sd["positional_embedding"].shape[0])
    return cfg


def hf_clip_to_openai_layout(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Rewrite an HF-transformers CLIP state dict (CLIPModel / CLIPVisionModel /
    CLIPForImageClassification — `vision_model.*`/`text_model.*` keys) into the
    OpenAI `visual.*`/`transformer.*` naming of `ClipModule`.

    The reference's clip-cub / clip-bloodmnist MODELS entries are HF-hub
    fine-tunes loaded with AutoModelForImageClassification
    (`concept_vit/data_utils.py:29,33,63-70`); a locally saved copy of one of
    those arrives in this layout. q/k/v projections concatenate into torch
    MultiheadAttention's fused in_proj [q;k;v] order; HF's separate
    visual_projection/text_projection Linear weights transpose into the OpenAI
    matmul-parameter convention. Classifier heads and buffer keys are dropped."""
    # strip an optional wrapper prefix ("clip.", "model.", ...) in front of the
    # tower names
    prefix = ""
    for k in sd:
        i = k.find("vision_model.")
        if i < 0:
            i = k.find("text_model.")
        if i > 0:
            prefix = k[:i]
            break
    out: Dict[str, np.ndarray] = {}

    def tower(src, dst_blocks, emb_map, ln_final_map):
        n = len({k.split(f"{src}.encoder.layers.")[1].split(".")[0]
                 for k in sd if f"{src}.encoder.layers." in k})
        for hf_key, oa_key in emb_map.items():
            k = prefix + f"{src}." + hf_key
            if k in sd:
                out[oa_key] = sd[k]
        for i in range(n):
            s = prefix + f"{src}.encoder.layers.{i}."
            d = dst_blocks.format(i)
            qw, kw, vw = (sd[s + f"self_attn.{t}_proj.weight"] for t in "qkv")
            qb, kb, vb = (sd[s + f"self_attn.{t}_proj.bias"] for t in "qkv")
            out[d + "attn.in_proj_weight"] = np.concatenate([qw, kw, vw], axis=0)
            out[d + "attn.in_proj_bias"] = np.concatenate([qb, kb, vb], axis=0)
            out[d + "attn.out_proj.weight"] = sd[s + "self_attn.out_proj.weight"]
            out[d + "attn.out_proj.bias"] = sd[s + "self_attn.out_proj.bias"]
            out[d + "mlp.c_fc.weight"] = sd[s + "mlp.fc1.weight"]
            out[d + "mlp.c_fc.bias"] = sd[s + "mlp.fc1.bias"]
            out[d + "mlp.c_proj.weight"] = sd[s + "mlp.fc2.weight"]
            out[d + "mlp.c_proj.bias"] = sd[s + "mlp.fc2.bias"]
            for hf_ln, oa_ln in (("layer_norm1", "ln_1"), ("layer_norm2", "ln_2")):
                out[d + oa_ln + ".weight"] = sd[s + hf_ln + ".weight"]
                out[d + oa_ln + ".bias"] = sd[s + hf_ln + ".bias"]
        for hf_key, oa_key in ln_final_map.items():
            k = prefix + f"{src}." + hf_key
            if k in sd:
                out[oa_key] = sd[k]

    if any("vision_model." in k for k in sd):
        tower(
            "vision_model", "visual.transformer.resblocks.{}.",
            {"embeddings.class_embedding": "visual.class_embedding",
             "embeddings.patch_embedding.weight": "visual.conv1.weight",
             "embeddings.position_embedding.weight": "visual.positional_embedding",
             # HF ships the misspelled attribute name
             "pre_layrnorm.weight": "visual.ln_pre.weight",
             "pre_layrnorm.bias": "visual.ln_pre.bias",
             "pre_layernorm.weight": "visual.ln_pre.weight",
             "pre_layernorm.bias": "visual.ln_pre.bias"},
            {"post_layernorm.weight": "visual.ln_post.weight",
             "post_layernorm.bias": "visual.ln_post.bias"},
        )
        vp = prefix + "visual_projection.weight"
        if vp in sd:
            out["visual.proj"] = sd[vp].T
    if any("text_model." in k for k in sd):
        tower(
            "text_model", "transformer.resblocks.{}.",
            {"embeddings.token_embedding.weight": "token_embedding.weight",
             "embeddings.position_embedding.weight": "positional_embedding"},
            {"final_layer_norm.weight": "ln_final.weight",
             "final_layer_norm.bias": "ln_final.bias"},
        )
        tp = prefix + "text_projection.weight"
        if tp in sd:
            out["text_projection"] = sd[tp].T
    ls = prefix + "logit_scale"
    if ls in sd:
        out["logit_scale"] = sd[ls]
    return out


class OpenAIClip:
    """The `clip.load` surface (`embed_images` / `embed_texts` / `tokenize`) and the
    dissection-target interface (`harvest`) of one ClipModule on `device`.

    Random weights come from `seed`. `ckpt_path` reads an OpenAI state dict (an HF
    layout is rewritten first) and takes the geometry from it; the load is
    non-strict and logged. `overrides` replace entries of the named arch's config
    (tiny towers in tests)."""

    def __init__(self, name: str = "ViT-B/16", tokenizer=None, seed: int = 0,
                 ckpt_path: Optional[str] = None, dtype=None, device=None,
                 log=print, **overrides):
        dev = resolve_device(device)  # before building: no GPU fails fast
        cfg = dict(VIT_CONFIGS.get(name, VIT_CONFIGS["ViT-B/16"]))
        sd = None
        if ckpt_path:
            sd = {k: v.detach().cpu().numpy() for k, v in torch_state_dict(ckpt_path).items()}
            if any("vision_model." in k or "text_model." in k for k in sd):
                # HF-transformers layout (the clip-cub / clip-bloodmnist hub
                # fine-tunes saved locally) -> OpenAI naming
                sd = hf_clip_to_openai_layout(sd)
            cfg.update(clip_config_from_state_dict(sd))
        cfg.update(overrides)
        module = ClipModule(dtype=resolve_dtype(dtype), **cfg)
        init_clip_weights(module, torch.Generator().manual_seed(seed))
        if sd is not None:
            _load_non_strict(module, {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                             log)
        self.module = module.to(dev).eval()
        self.device = dev
        self.tokenizer = tokenizer

    def tokenize(self, texts) -> np.ndarray:
        if self.tokenizer is None:
            # canonical CLIP BPE from the vendored merges file — token for token the
            # reference's `clip.tokenize` (`clip/clip.py:196-232`)
            from mammodissect_torch.models.tokenizers import ClipBPETokenizer

            self.tokenizer = ClipBPETokenizer.default()
        return self.tokenizer(texts)

    @torch.inference_mode()
    def embed_images(self, images) -> np.ndarray:
        """[B, H, W, 3] -> projected, L2-normalized [B, embed_dim] float32."""
        return l2_normalized(self.module.encode_image(nchw_from_nhwc(images, self.device)))

    @torch.inference_mode()
    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """BPE-tokenized, EOT-pooled, projected, L2-normalized [C, embed_dim] float32,
        all texts in one forward."""
        toks = torch.as_tensor(self.tokenize(list(texts)), dtype=torch.long)
        return l2_normalized(self.module.encode_text(toks.to(self.device)).float())

    @torch.inference_mode()
    def harvest(self, images, layers: Sequence[str], pool_mode: str = "avg"):
        """{"layers.i": [B, width] float32}: each captured block's CLS token (the 3-D
        rule, `concept_vit/utils.py:40-44`), all from one forward."""
        capture = tuple(sorted({layer_index(canonical_layer_name(l)) for l in layers}))
        _, captured = self.module.visual(nchw_from_nhwc(images, self.device), capture=capture)
        names = list(captured)  # every block has the same width: one copy to the host
        pooled = torch.cat([pool_activation(captured[n], pool_mode) for n in names], dim=1)
        return dict(zip(names, np.split(pooled.cpu().numpy(), len(names), axis=1)))


def _clip_target(arch: str, name: str, **kw) -> OpenAIClip:
    """A CLIP ViT target. The engine passes `finetuned_ckpt` and `num_class` to every
    target; these take their weights only from `ckpt_path`, so both are dropped,
    loudly when set (a user's --finetuned_img_classifier_chkpt would otherwise
    silently dissect other weights)."""
    from mammodissect_torch.dissect.targets import take_kwargs

    take_kwargs({k: kw.pop(k) for k in ("finetuned_ckpt", "num_class") if k in kw}, (), name)
    return OpenAIClip(arch, **kw)


def _register():
    from mammodissect_torch.dissect.dissectors import DISSECTORS
    from mammodissect_torch.dissect.targets import TARGETS

    # "clip"/"clip-cub"/"clip-bloodmnist" are the reference MODELS spellings for the
    # openai/clip-vit-base-patch16 tower and its fine-tunes (`data_utils.py:24,29,32`)
    # — the ViT-B/16 architecture; pass ckpt_path for fine-tuned weights
    for name in ("ViT-B/32", "ViT-B/16", "ViT-L/14", "clip", "clip-cub", "clip-bloodmnist"):
        arch = "ViT-B/16" if name.startswith("clip") else name
        if name not in DISSECTORS:
            DISSECTORS.register(name, partial(OpenAIClip, arch))
        if name not in TARGETS:
            TARGETS.register(name, partial(_clip_target, arch, name))


_register()

