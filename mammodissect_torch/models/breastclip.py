"""BreastClip (Mammo-CLIP) dual encoder in PyTorch (counterpart of
`mammodissect/models/breastclip.py`).

The canonical dissector config: EfficientNet-B5 '-detect' image tower (3-channel
copies of the grayscale mammograms, average-pooled, 2048-d) + Bio_ClinicalBERT text
tower (768-d, eos pooling) + linear projections to 512 + temperature 0.07
(`logit_scale` = log(1/T)). The config's `image_encoder.model_type` may instead name
a `swin` tower (`models/swin.py`, its pooled output) or a `vit` tower
(`models/vit_encoder.py`, its CLS token), as `model/clip.py:44-52` pools them; their
geometry keys (`spec`, `patch_size`, `window`; `image_size`, `width`, `layers`,
`heads`) default to swin-tiny and ViT-B/16.

State-dict names follow the reference: `image_encoder._blocks.i...` (HF names for
the swin and vit towers), `text_encoder.encoder.layer.i...`,
`image_projection.projection`, `text_projection.projection`, `logit_scale`.

`BreastClipModule.forward(batch, generator)` is the training forward of contrastive
pretraining (`mammodissect/models/breastclip.py:147-167`): the normalized image and
text embeddings, `labels` = arange(B) (in a data-parallel step arange over the
global batch, offset by the rank: `parallel.mesh.data_parallel`) and exp(logit_scale), plus
`text_embeddings2` and `image_view_embeddings` when the batch has `input_ids2` and
`image_views`. In training mode the image tower normalizes by batch statistics and
draws its drop-connect masks, and the MLP projection heads their dropout masks,
from `generator`. `param_dtype` stores the weights (float32 master weights under
bf16 compute, as JAX's `dtype=bfloat16` module over flax's float32 parameters);
`grad_checkpoint` is the config's `text_encoder.gradient_checkpointing`. A config's
`image_encoder.s2d_stem` runs the plain stem: JAX's space-to-depth stem computes
the same function (`models/efficientnet.py`).

`BreastClip` wraps the module with its tokenizer and device and provides the
dissector interface (`embed_images`, `embed_images_u8`, `embed_texts`,
`embed_tokens`), the fused harvest of the staged path
(`harvest_and_embed_u8_dispatch`) and the device-resident fused M-dissect steps
of both wires (`fused_resident_step`, `fused_resident_step_packed`).
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mammodissect_torch.convert import load_breastclip_checkpoint
from mammodissect_torch.device import resolve_device, resolve_dtype
from mammodissect_torch.dissect.capture import canonical_layer_name, layer_index
from mammodissect_torch.dissect.dissectors import DISSECTORS
from mammodissect_torch.dissect.packing import unpack_canvas_groups
from mammodissect_torch.models.bert import BertModel
from mammodissect_torch.models.efficientnet import EfficientNetMammo
from mammodissect_torch.models.layers import (
    LinearProjectionHead,
    MLPProjectionHead,
    init_weights,
)
from mammodissect_torch.models.swin import SwinEncoder, init_swin_weights
from mammodissect_torch.models.vit_encoder import ViTImageEncoder, init_vit_weights
from mammodissect_torch.models.tokenizers import WordPieceTokenizer
from mammodissect_torch.ops.normalize import u8_minmax_meanstd
from mammodissect_torch.parallel.mesh import active_data_group, group_rank_and_size


def default_model_config() -> Dict:
    """The hardcoded Mammo-CLIP dissector config (`concept_vit/utils.py:434-443`)."""
    return {
        "name": "clip_custom",
        "temperature": 0.07,
        "image_encoder": {
            "source": "cnn",
            "name": "tf_efficientnet_b5_ns-detect",
            "model_type": "cnn",
            "variant": "efficientnet-b5",
            "in_channels": 3,
        },
        "text_encoder": {
            "source": "huggingface",
            "name": "emilyalsentzer/Bio_ClinicalBERT",
            "pooling": "eos",
            "gradient_checkpointing": False,
        },
        "projection_head": {"name": "linear", "dropout": 0.1, "proj_dim": 512},
    }


# the geometry keys of a config's image_encoder that each non-CNN tower takes
_TOWER_GEOMETRY = {"swin": ("spec", "patch_size", "window"),
                   "vit": ("image_size", "patch_size", "width", "layers", "heads")}


class BreastClipModule(nn.Module):
    """Both towers + projections + logit_scale."""

    def __init__(self, image_variant: str = "efficientnet-b5", in_channels: int = 3,
                 image_pooling: str = "avg", image_tower: str = "cnn",
                 image_kwargs: Optional[Dict] = None,
                 text_pooling: str = "eos", proj_dim: int = 512,
                 proj_head: str = "linear", proj_dropout: float = 0.1,
                 temperature: float = 0.07, vocab_size: int = 28996, bert_layers: int = 12,
                 bert_hidden: int = 768, bert_heads: int = 12, bert_intermediate: int = 3072,
                 grad_checkpoint: bool = False, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if text_pooling not in ("eos", "bos", "mean"):
            raise NotImplementedError(f"pooling {text_pooling!r}")
        self.text_pooling = text_pooling
        self.proj_dim = proj_dim
        param_dtype = dtype if param_dtype is None else param_dtype
        image_kwargs = dict(image_kwargs or {})
        if image_tower == "cnn":
            image_kwargs.update(param_dtype=param_dtype)
        self.image_encoder = _image_tower(image_tower, image_variant, in_channels, image_pooling,
                                          image_kwargs, dtype)
        self.text_encoder = BertModel(vocab_size=vocab_size, hidden_size=bert_hidden,
                                      num_layers=bert_layers, num_heads=bert_heads,
                                      intermediate_size=bert_intermediate, dtype=dtype,
                                      param_dtype=param_dtype, grad_checkpoint=grad_checkpoint)
        if proj_head == "mlp":
            self.image_projection = MLPProjectionHead(self.image_encoder.out_dim, proj_dim,
                                                      proj_dropout)
            self.text_projection = MLPProjectionHead(bert_hidden, proj_dim, proj_dropout)
        else:
            self.image_projection = LinearProjectionHead(self.image_encoder.out_dim, proj_dim)
            self.text_projection = LinearProjectionHead(bert_hidden, proj_dim)
        for m in (*self.image_projection.modules(), *self.text_projection.modules()):
            if isinstance(m, nn.Linear):
                m.to(param_dtype)
                if param_dtype != dtype:
                    m.compute_dtype = dtype
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / temperature)))

    def encode_image(self, images: torch.Tensor, capture: Sequence[int] = (),
                     pool_mode: str = "avg", generator: Optional[torch.Generator] = None):
        """images [B, H, W, C] -> pooled [B, D] float32 (and the captured blocks); a
        ViT tower's token sequence pools to its CLS token (`model/clip.py:49-52`).
        `generator` draws the EfficientNet's drop-connect masks in training."""
        if isinstance(self.image_encoder, ViTImageEncoder):
            feats, captured = self.image_encoder(images, capture=capture)
            pooled = feats[:, 0]
        elif isinstance(self.image_encoder, EfficientNetMammo):
            pooled, captured = self.image_encoder(images, capture=capture, pool_mode=pool_mode,
                                                  generator=generator)
        else:
            pooled, captured = self.image_encoder(images, capture=capture, pool_mode=pool_mode)
        return (pooled, captured) if capture else pooled

    def encode_text(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        hidden = self.text_encoder(input_ids, attention_mask)
        if self.text_pooling == "eos":
            eos_idx = attention_mask.sum(dim=-1) - 1
            return hidden[torch.arange(hidden.shape[0], device=hidden.device), eos_idx]
        if self.text_pooling == "bos":
            return hidden[:, 0]
        mask = attention_mask[..., None].to(hidden.dtype)
        return (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1e-9)

    @staticmethod
    def _l2n(emb: torch.Tensor) -> torch.Tensor:
        return emb / torch.linalg.vector_norm(emb.float(), dim=1, keepdim=True)

    def project_image(self, feats: torch.Tensor,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._l2n(self.image_projection(feats, generator))

    def project_text(self, feats: torch.Tensor,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._l2n(self.text_projection(feats, generator))

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The `BreastClip.forward` contract (`model/clip.py:103-137`) over a batch of
        tensors on the module's device: "images" [B, H, W, C] float, "input_ids" and
        "attention_mask" [B, T]; with "input_ids2"/"attention_mask2" and
        "image_views", the second text view and the image view too. Random draws
        (drop-connect in training, the MLP heads' dropout) come from `generator`, in
        the order image, text, text 2, image view."""
        def image(x):
            return self.project_image(self.encode_image(x, generator=generator), generator)

        def text(ids, mask):
            return self.project_text(self.encode_text(ids, mask), generator)

        image_emb = image(batch["images"])
        # in a data-parallel step: arange over the global batch, offset by the rank
        rank, _ = group_rank_and_size(active_data_group())
        b = image_emb.shape[0]
        out = {"image_embeddings": image_emb,
               "text_embeddings": text(batch["input_ids"], batch["attention_mask"]),
               "labels": torch.arange(b, device=image_emb.device) + rank * b,
               "logit_scale": self.logit_scale.exp()}
        if "input_ids2" in batch and "image_views" in batch:
            out["text_embeddings2"] = text(batch["input_ids2"], batch["attention_mask2"])
            out["image_view_embeddings"] = image(batch["image_views"])
        return out


def _image_tower(kind: str, variant: str, in_channels: int, pooling: str, kw: Dict,
                 dtype: torch.dtype) -> nn.Module:
    """The image encoder a config's `image_encoder.model_type` names (`kw`: the
    Swin/ViT geometry, or the EfficientNet's `param_dtype`)."""
    if kind == "swin":
        return SwinEncoder(variant=variant if variant.startswith("swin") else "swin-tiny",
                           in_channels=in_channels, dtype=dtype, **kw)
    if kind == "vit":
        return ViTImageEncoder(in_channels=in_channels, dtype=dtype, **kw)
    if kind == "cnn":
        return EfficientNetMammo(variant=variant, in_channels=in_channels, pooling=pooling,
                                 dtype=dtype, **kw)
    raise ValueError(f"image_encoder.model_type must be cnn, swin or vit, got {kind!r}")


ResidentStep = Callable[..., None]


class BreastClip:
    """Module + tokenizer + device: the dissector the engine drives."""

    def __init__(self, module: BreastClipModule, tokenizer=None, max_length: int = 256,
                 device: torch.device | str = "cpu", text_batch: int = 128):
        self.module = module
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.device = torch.device(device)
        self.text_batch = text_batch  # texts per text-tower forward (bounds memory)

    @classmethod
    def create(cls, model_config: Optional[Dict] = None, tokenizer=None, seed: int = 0,
               ckpt_path: Optional[str] = None, dtype: torch.dtype = torch.float32,
               bert_layers: int = 12, vocab_size: int = 28996, device=None,
               param_dtype: Optional[torch.dtype] = None):
        """The module from `model_config` (default: the canonical dissector's) with
        random weights from `seed`, then the checkpoint's when given, on `device` in
        eval mode. `dtype` computes, `param_dtype` (default: `dtype`) stores."""
        dev = resolve_device(device)  # before building: no GPU fails fast
        cfg = model_config or default_model_config()
        ie, te, ph = cfg["image_encoder"], cfg["text_encoder"], cfg.get("projection_head", {})
        name = ie.get("name", "tf_efficientnet_b5_ns-detect")
        tower = ie.get("model_type", "cnn")
        geometry = _TOWER_GEOMETRY.get(tower, ())
        module = BreastClipModule(
            image_variant=ie.get("variant", "efficientnet-b5"),
            in_channels=ie.get("in_channels", 3),
            image_pooling=ie.get("pooling", "avg" if name.endswith("-detect") else "gem"),
            image_tower=tower,
            image_kwargs={k: v for k, v in ie.items() if k in geometry},
            text_pooling=te.get("pooling", "eos"),
            proj_dim=ph.get("proj_dim", 512),
            proj_head=ph.get("name", "linear"),
            proj_dropout=ph.get("dropout", 0.1),
            temperature=cfg.get("temperature", 0.07),
            vocab_size=vocab_size,
            bert_layers=bert_layers,
            grad_checkpoint=bool(te.get("gradient_checkpointing", False)),
            dtype=dtype,
            param_dtype=param_dtype,
        )
        init = {"swin": init_swin_weights, "vit": init_vit_weights}.get(tower, init_weights)
        init(module, torch.Generator().manual_seed(seed))
        if ckpt_path:
            load_breastclip_checkpoint(ckpt_path, module)
        return cls(module.to(dev).eval(), tokenizer=tokenizer, device=dev)

    def tokenize(self, texts, max_length: Optional[int] = None):
        if self.tokenizer is None:
            raise ValueError("BreastClip was created without a tokenizer")
        return self.tokenizer(texts, max_length=max_length or self.max_length)

    @torch.inference_mode()
    def embed_tokens(self, input_ids, attention_mask) -> np.ndarray:
        """Projected + L2-normalized text embeddings [C, D] float32 from token ids."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long)
        mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.long)
        out = []
        for i in range(0, ids.shape[0], self.text_batch):
            i_dev = ids[i:i + self.text_batch].to(self.device)
            m_dev = mask[i:i + self.text_batch].to(self.device)
            emb = self.module.project_text(self.module.encode_text(i_dev, m_dev))
            out.append(emb.float().cpu())
        return torch.cat(out).numpy()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Dissector interface: tokenized, eos-pooled, projected, normalized."""
        toks = self.tokenize(list(texts))
        return self.embed_tokens(toks["input_ids"], toks["attention_mask"])

    def capture_plan(self, layers: Sequence[str]) -> Tuple[Tuple[int, ...], List[str], Tuple[int, ...]]:
        """(captured block indices, sorted names, widths) of `layers` on the image tower."""
        capture = tuple(sorted({layer_index(canonical_layer_name(l)) for l in layers}))
        blocks = self.module.image_encoder.block_args
        names = [f"blocks.{i}" for i in capture]
        widths = tuple(blocks[i].output_filters for i in capture)
        return capture, names, widths

    def _encode_u8(self, u8: torch.Tensor, capture: Sequence[int], pool_mode: str,
                   mean: float, std: float):
        """uint8 batch on the device -> ({"blocks.i": pooled}, projected embedding):
        min-max + mean/std on the device, one tower forward."""
        x = u8_minmax_meanstd(u8, mean, std)
        if not capture:
            return {}, self.module.project_image(self.module.encode_image(x))
        pooled, captured = self.module.encode_image(x, capture=capture, pool_mode=pool_mode)
        return captured, self.module.project_image(pooled)

    @torch.inference_mode()
    def encode_image(self, images) -> np.ndarray:
        """Pooled image features [B, 2048] float32 of a float [B, H, W, C] batch."""
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        return self.module.encode_image(x).float().cpu().numpy()

    @torch.inference_mode()
    def encode_text(self, input_ids, attention_mask) -> np.ndarray:
        """Pooled text features [C, 768] float32 (the tower's eos/bos/mean pooling)."""
        ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long).to(self.device)
        mask = torch.as_tensor(np.asarray(attention_mask), dtype=torch.long).to(self.device)
        return self.module.encode_text(ids, mask).float().cpu().numpy()

    @torch.inference_mode()
    def embed_images(self, images) -> np.ndarray:
        """Dissector interface: projected + L2-normalized embeddings [B, D] float32 of a
        float [B, H, W, C] batch (`utils.py:19-26` encode_image + projection + norm)."""
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        return self.module.project_image(self.module.encode_image(x)).float().cpu().numpy()

    @torch.inference_mode()
    def embed_images_u8(self, images_u8, mean: float, std: float) -> np.ndarray:
        """`embed_images` of a uint8 batch (numpy or a CPU tensor, pinned for an
        asynchronous copy), normalized on the device."""
        u8 = torch.as_tensor(images_u8).to(self.device, non_blocking=True)
        _, emb = self._encode_u8(u8, (), "avg", mean, std)
        return emb.float().cpu().numpy()

    @torch.inference_mode()
    def harvest_and_embed_u8_dispatch(self, images_u8, layers: Sequence[str], pool_mode: str,
                                      mean: float, std: float):
        """Fused M-dissect of one uint8 batch, when the dissection target is this
        model's own image tower: one forward gives the pooled activations of the
        named blocks and the probe embedding. The work is queued on the device and
        the results stay there, so the caller can queue the next batch before it
        reads these.

        Returns (activations [B, U_total] float32, embeddings [B, D] float32, names,
        widths), both tensors on the device."""
        capture, names, widths = self.capture_plan(layers)
        u8 = torch.as_tensor(images_u8).to(self.device, non_blocking=True)
        captured, emb = self._encode_u8(u8, capture, pool_mode, mean, std)
        return torch.cat([captured[n] for n in names], dim=-1), emb.float(), names, widths

    def _resident_step(self, shape: Tuple[int, ...], layers: Sequence[str], pool_mode: str,
                       mean: float, std: float, decode: Callable[..., torch.Tensor]):
        """The resident step of one wire format; `decode(*wire)` gives the
        [B, H, W, C] uint8 canvas. Both wires share everything after the decode."""
        capture, names, widths = self.capture_plan(layers)

        @torch.inference_mode()
        def step(acc_acts: torch.Tensor, acc_emb: torch.Tensor, *wire_and_offset) -> None:
            *wire, offset = wire_and_offset
            u8 = decode(*wire)
            if tuple(u8.shape) != shape:
                raise ValueError(f"resident step built for {shape}, got {tuple(u8.shape)}")
            captured, emb = self._encode_u8(u8, capture, pool_mode, mean, std)
            rows = slice(offset, offset + shape[0])
            col = 0
            for name, w in zip(names, widths):
                acc_acts[rows, col:col + w] = captured[name]
                col += w
            acc_emb[rows] = emb.float()

        return step, names, widths

    def fused_resident_step(self, sample_shape, layers: Sequence[str], pool_mode: str,
                            mean: float, std: float) -> Tuple[ResidentStep, List[str], Tuple[int, ...]]:
        """Device-resident fused M-dissect step.

        Returns (step, names, widths) where
          step(acc_acts [cap, U_total] f32, acc_emb [cap, D] f32, u8 [B, H, W, C], offset)
        normalizes one uint8 batch on the device, runs the image tower once with the
        named blocks captured, projects the pooled features, and writes the batch's
        concatenated pooled activations and embeddings into the accumulators at row
        `offset`, in place."""
        return self._resident_step(tuple(sample_shape), layers, pool_mode, mean, std,
                                   decode=lambda u8: u8)

    def fused_resident_step_packed(self, sample_shape, layers: Sequence[str], pool_mode: str,
                                   mean: float, std: float):
        """`fused_resident_step` for the packed uint8 wire (`dissect/packing.py`), one
        shard group: step(acc_acts, acc_emb, flat2d [1, L] uint8, meta [B, H, 2] int32,
        offset) rebuilds the bit-identical canvas on the device
        (`unpack_canvas_groups`), then runs the same normalize, forward and
        accumulate. Any bucket length L: the eager step needs no static shape."""
        shape = tuple(sample_shape)
        return self._resident_step(
            shape, layers, pool_mode, mean, std,
            decode=lambda flat2d, meta: unpack_canvas_groups(flat2d, meta, shape))


@DISSECTORS.register("breastclip")
def _breastclip_dissector(ckpt_path=None, vocab_file=None, image_shape=None, max_length: int = 256,
                          device=None, dtype=None, **kw) -> BreastClip:
    """The BreastClip dissector on `device` (default CUDA). `image_shape` is accepted
    for kwargs compatibility with the JAX factory; the eager model needs no example
    input. `dtype` may be a torch dtype or its name ("bfloat16")."""
    if vocab_file:
        tok = WordPieceTokenizer(vocab_file=vocab_file)
    else:
        # without the Bio_ClinicalBERT vocab.txt the tokenizer is a chars-only toy
        # vocab: concept tokenization then does not match the reference, loudly
        warnings.warn(
            "breastclip dissector built WITHOUT vocab_file: falling back to a "
            "chars-only toy WordPiece vocab — concept tokenization will NOT match "
            "Bio_ClinicalBERT. Pass vocab_file=<path to vocab.txt> for "
            "reference-faithful text embeddings.",
            stacklevel=2,
        )
        tok = WordPieceTokenizer.toy()
    clip = BreastClip.create(tokenizer=tok, ckpt_path=ckpt_path, vocab_size=len(tok.vocab),
                             device=device, dtype=resolve_dtype(dtype), **kw)
    clip.max_length = max_length
    return clip
