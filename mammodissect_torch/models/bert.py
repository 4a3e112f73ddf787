"""BERT text encoder in PyTorch, Bio_ClinicalBERT geometry (counterpart of
`mammodissect/models/bert.py`).

Parameter names are HuggingFace BertModel's (`embeddings.*`, `encoder.layer.i.*`),
so the reference's text-tower state dict loads with `load_state_dict`. Attention
is a plain matmul + softmax with the JAX module's promotion (`layers.attend`):
the scores in the dense dtype, divided and masked (additive -1e9) in the layer
input's float32, the softmax and its product with the values in float32. Post-LN,
exact GELU, LayerNorm eps 1e-12 computed in float32; the dense layers run in
`dtype`.

Geometry: 12 layers, hidden 768, 12 heads, intermediate 3072, vocab 28996,
512 positions. No dropout, as in the JAX module. `param_dtype` (default: `dtype`)
stores the dense layers and embeddings, which compute in `dtype` (pretraining:
float32 master weights, bf16 compute). `grad_checkpoint` recomputes each layer in
the backward (`torch.utils.checkpoint`, the counterpart of the JAX module's
`nn.remat` and of the reference's `gradient_checkpointing`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mammodissect_torch.models.layers import Embedding, LayerNorm, Linear, attend


class BertEmbeddings(nn.Module):
    """Word + position + token-type embeddings, each looked up in the compute dtype
    (`layers.Embedding`, flax's `nn.Embed(dtype=...)`) and summed in it, then
    LayerNorm."""

    def __init__(self, vocab_size, hidden_size, max_position_embeddings, type_vocab_size,
                 layer_norm_eps):
        super().__init__()
        self.word_embeddings = Embedding(vocab_size, hidden_size)
        self.position_embeddings = Embedding(max_position_embeddings, hidden_size)
        self.token_type_embeddings = Embedding(type_vocab_size, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, hidden_size, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.local_heads = num_heads  # this rank's heads (tensor parallelism splits them)
        self.query = Linear(hidden_size, hidden_size)
        self.key = Linear(hidden_size, hidden_size)
        self.value = Linear(hidden_size, hidden_size)

    def forward(self, x, attn_bias):
        b, t, _ = x.shape

        def split(a):  # [B, T, D] -> [B, heads, T, d_head]
            return a.reshape(b, t, self.local_heads, -1).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        return attend(q, k, v, x.dtype, attn_bias).transpose(1, 2).reshape(b, t, -1)


class BertSelfOutput(nn.Module):
    def __init__(self, hidden_size, layer_norm_eps):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class BertAttention(nn.Module):
    def __init__(self, hidden_size, num_heads, layer_norm_eps):
        super().__init__()
        self.self = BertSelfAttention(hidden_size, num_heads)
        self.output = BertSelfOutput(hidden_size, layer_norm_eps)

    def forward(self, x, attn_bias):
        return self.output(self.self(x, attn_bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, hidden_size, intermediate_size):
        super().__init__()
        self.dense = Linear(hidden_size, intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertOutput(nn.Module):
    def __init__(self, intermediate_size, hidden_size, layer_norm_eps):
        super().__init__()
        self.dense = Linear(intermediate_size, hidden_size)
        self.LayerNorm = LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(residual + self.dense(h))


class BertLayer(nn.Module):
    def __init__(self, hidden_size, num_heads, intermediate_size, layer_norm_eps):
        super().__init__()
        self.attention = BertAttention(hidden_size, num_heads, layer_norm_eps)
        self.intermediate = BertIntermediate(hidden_size, intermediate_size)
        self.output = BertOutput(intermediate_size, hidden_size, layer_norm_eps)

    def forward(self, x, attn_bias):
        x = self.attention(x, attn_bias)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    """The layer stack; with `grad_checkpoint`, each layer of a forward that records
    gradients is recomputed in the backward. The layers draw no random numbers, so
    no RNG state is saved for the recompute: saving the CUDA generator's state reads
    it back to the host, a device synchronization in every layer's forward."""

    def __init__(self, num_layers, hidden_size, num_heads, intermediate_size, layer_norm_eps,
                 grad_checkpoint: bool = False):
        super().__init__()
        self.grad_checkpoint = grad_checkpoint
        self.layer = nn.ModuleList(
            BertLayer(hidden_size, num_heads, intermediate_size, layer_norm_eps)
            for _ in range(num_layers))

    def forward(self, x, attn_bias):
        remat = self.grad_checkpoint and torch.is_grad_enabled()
        for layer in self.layer:
            if remat:
                x = checkpoint(layer, x, attn_bias, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, attn_bias)
        return x


class BertModel(nn.Module):
    """Embeddings + N transformer layers; forward returns the last hidden state [B, T, D]
    (float32: the final LayerNorm computes in float32)."""

    def __init__(self, vocab_size: int = 28996, hidden_size: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_size: int = 3072,
                 max_position_embeddings: int = 512, type_vocab_size: int = 2,
                 layer_norm_eps: float = 1e-12, dtype: torch.dtype = torch.float32,
                 param_dtype: torch.dtype | None = None, grad_checkpoint: bool = False):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, hidden_size, max_position_embeddings,
                                         type_vocab_size, layer_norm_eps)
        self.encoder = BertEncoder(num_layers, hidden_size, num_heads, intermediate_size,
                                   layer_norm_eps, grad_checkpoint=grad_checkpoint)
        param_dtype = dtype if param_dtype is None else param_dtype
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.to(param_dtype)
            if param_dtype != dtype and isinstance(m, (Linear, Embedding)):
                m.compute_dtype = dtype

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        attn_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        return self.encoder(x, attn_bias)
