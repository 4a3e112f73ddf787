"""CLIP byte-BPE tokenizer (a copy of `mammodissect/models/tokenizers/bpe.py`).

The algorithm behind OpenAI CLIP's `tokenize` (reference vendored
`concept_vit/clip/simple_tokenizer.py:62-132`, used with a 77-token context at
`clip/clip.py:196-232`): bytes->unicode mapping, lowercased word-level regex split,
greedy lowest-rank BPE merges with a '</w>' word-end marker, `<|startoftext|>` /
`<|endoftext|>` specials. Loads the standard gzip merges file
(`bpe_simple_vocab_16e6.txt.gz`); `default()` reads the copy vendored with the JAX
package in place, by path."""
from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

CONTEXT_LENGTH = 77  # `clip/clip.py:196`
# the merges file the reference vendors, read as a data file of the JAX package
VOCAB_PATH = (Path(__file__).resolve().parents[3] / "mammodissect" / "assets" / "clip"
              / "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


# Unicode-aware port of the reference pattern (`simple_tokenizer.py:77`:
# `[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+` via the `regex` module). Python's `re`
# lacks \p classes; with the default Unicode flag `[^\W\d_]` matches exactly the
# letter categories and `\d` the decimal digits, so accented/non-Latin words
# ('naïve', report artifacts) tokenize as words, not punctuation runs.
_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    def __init__(self, merges_file: str | None = None,
                 merges: Sequence[Tuple[str, str]] | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        if merges is None:
            if merges_file is None:
                raise ValueError("provide merges_file or merges")
            merges_file = str(merges_file)
            opener = gzip.open if merges_file.endswith(".gz") else open
            with opener(merges_file, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # standard file: first line is a version header; CLIP uses entries 1..49152-256-2+1
            merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1] if m]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._bpe_cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"
        }

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _basic_clean(text).lower()
        for token in _WORD_RE.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()

    def __call__(self, texts: str | Sequence[str], context_length: int = CONTEXT_LENGTH,
                 truncate: bool = True) -> np.ndarray:
        """`clip.tokenize` contract (`clip/clip.py:196-232`): [SOT] ids [EOT], zero-padded
        int32 [B, 77]; over-length sequences truncated with EOT kept last."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + self.encode(t) + [self.eot]
            if len(ids) > context_length:
                if not truncate:
                    raise ValueError(f"input {i} too long ({len(ids)} > {context_length})")
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out

    @classmethod
    def default(cls) -> "ClipBPETokenizer":
        """The canonical CLIP tokenizer from the vendored merges file (the file the
        reference ships and loads unconditionally, `simple_tokenizer.py:62-75`). Built
        once per process: the 49,408-entry encoder takes a moment."""
        return _default_tokenizer()


@lru_cache(maxsize=1)
def _default_tokenizer() -> ClipBPETokenizer:
    if not VOCAB_PATH.exists():
        raise FileNotFoundError(f"the CLIP BPE merges file is missing: {VOCAB_PATH}")
    return ClipBPETokenizer(merges_file=str(VOCAB_PATH))
