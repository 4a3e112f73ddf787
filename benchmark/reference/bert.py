"""Plain BERT text tower (Devlin et al., arXiv:1810.04805; Bio_ClinicalBERT's
geometry) and the WordPiece tokenizer it reads, the benchmark's reference.

Post-LN BERT: word + position + token-type embeddings and a LayerNorm, then layers
of self-attention (scores scaled by 1/sqrt(head size), padding masked) and an exact
GELU feed-forward, each added to its input and layer-normalized (eps 1e-12). The
concept embedding is the hidden state at the last real token (eos pooling), then
Mammo-CLIP's linear text projection, L2-normalized. Weights in HuggingFace's names
(`embeddings.word_embeddings.weight`, `encoder.layer.i.attention.self.query.weight`,
...). float32; `mode` as in `efficientnet.py`. Imports nothing of the program."""
from __future__ import annotations

import math
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.efficientnet import l2n, linear
from benchmark.reference.precision import lower

def read_vocab(path: str) -> Dict[str, int]:
    """A WordPiece vocabulary file, one piece a line, its row the piece's id."""
    with open(path, encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f)}


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _words(text: str) -> List[str]:
    """BERT's basic tokenization: control characters dropped, whitespace split,
    lower case without accents, each punctuation mark a word of its own."""
    kept = []
    for ch in text:
        cat = unicodedata.category(ch)
        if ord(ch) in (0, 0xFFFD) or (cat.startswith("C") and ch not in "\t\n\r"):
            continue
        kept.append(" " if ch in "\t\n\r" or cat == "Zs" else ch)
    out = []
    for tok in "".join(kept).split():
        tok = "".join(c for c in unicodedata.normalize("NFD", tok.lower())
                      if unicodedata.category(c) != "Mn")
        cur = ""
        for ch in tok:
            if _is_punct(ch):
                if cur:
                    out.append(cur)
                out.append(ch)
                cur = ""
            else:
                cur += ch
        if cur:
            out.append(cur)
    return out


def _pieces(word: str, vocab: Dict[str, int]) -> List[str]:
    """Greedy longest-match-first WordPiece; a word with any piece missing is [UNK]."""
    if len(word) > 100:
        return ["[UNK]"]
    pieces, start = [], 0
    while start < len(word):
        end = len(word)
        while end > start:
            sub = word[start:end] if start == 0 else "##" + word[start:end]
            if sub in vocab:
                break
            end -= 1
        if end == start:
            return ["[UNK]"]
        pieces.append(sub)
        start = end
    return pieces


def tokenize(texts: Sequence[str], vocab: Dict[str, int], max_length: int):
    """(input_ids, attention_mask) [len(texts), max_length] int64: [CLS] pieces
    [SEP], cut to max_length, padded with [PAD]."""
    ids = np.full((len(texts), max_length), vocab["[PAD]"], np.int64)
    mask = np.zeros((len(texts), max_length), np.int64)
    for i, text in enumerate(texts):
        pieces = [p for w in _words(text) for p in _pieces(w, vocab)][:max_length - 2]
        row = [vocab["[CLS]"]] + [vocab.get(p, vocab["[UNK]"]) for p in pieces] + [vocab["[SEP]"]]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return torch.from_numpy(ids), torch.from_numpy(mask)


def _layer_norm(x, sd, name, eps):
    return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"].float(), sd[f"{name}.bias"].float(),
                        eps)


def encode(sd: Dict[str, torch.Tensor], cfg: dict, ids: torch.Tensor, mask: torch.Tensor,
           prefix: str = "", mode: Optional[str] = None) -> torch.Tensor:
    """The last hidden state [B, T, hidden] of token ids [B, T] and their mask."""
    p, eps = prefix, cfg["layer_norm_eps"]
    heads = cfg["num_attention_heads"]
    b, t = ids.shape
    x = (sd[p + "embeddings.word_embeddings.weight"].float()[ids]
         + sd[p + "embeddings.position_embeddings.weight"].float()[:t][None]
         + sd[p + "embeddings.token_type_embeddings.weight"].float()[0])
    x = _layer_norm(x, sd, p + "embeddings.LayerNorm", eps)
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(x.device)
    for i in range(cfg["num_hidden_layers"]):
        q = f"{p}encoder.layer.{i}."

        def dense(h, name):
            return linear(h, sd[q + name + ".weight"], sd[q + name + ".bias"], mode)

        def split(h):
            return h.reshape(b, t, heads, -1).transpose(1, 2)

        qh, kh, vh = (split(dense(x, f"attention.self.{n}")) for n in ("query", "key", "value"))
        scores = lower_matmul(qh, kh.transpose(-1, -2), mode) / math.sqrt(qh.shape[-1]) + bias
        ctx = lower_matmul(torch.softmax(scores, dim=-1), vh, mode)
        ctx = ctx.transpose(1, 2).reshape(b, t, -1)
        x = _layer_norm(x + dense(ctx, "attention.output.dense"), sd,
                        q + "attention.output.LayerNorm", eps)
        h = F.gelu(dense(x, "intermediate.dense"))
        x = _layer_norm(x + dense(h, "output.dense"), sd, q + "output.LayerNorm", eps)
    return x


def lower_matmul(a: torch.Tensor, b: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    return lower(a, mode) @ lower(b, mode)


def embed_concepts(sd: Dict[str, torch.Tensor], cfg: dict, texts: Sequence[str],
                   vocab: Dict[str, int], device, prefix: str = "", mode: Optional[str] = None,
                   rows: int = 64) -> torch.Tensor:
    """L2-normalized concept embeddings [C, proj_dim] float32 of `texts` tokenized by
    `vocab`: eos-pooled, projected by `text_projection.projection`; `rows` texts a
    forward."""
    ids, mask = tokenize(texts, vocab, cfg["max_length"])
    out = []
    for i in range(0, len(texts), rows):
        i_dev, m_dev = ids[i:i + rows].to(device), mask[i:i + rows].to(device)
        hidden = encode(sd, cfg, i_dev, m_dev, prefix + "text_encoder.", mode)
        eos = hidden[torch.arange(hidden.shape[0], device=device), m_dev.sum(dim=1) - 1]
        out.append(linear(eos, sd[prefix + "text_projection.projection.weight"],
                          sd[prefix + "text_projection.projection.bias"], mode))
    return l2n(torch.cat(out))
