"""Dissector registry (counterpart of `mammodissect/dissect/dissectors.py`).

A dissector is a vision-language model that embeds probe images and concept texts:
  embed_images(images [B, H, W, C]) -> [B, D] L2-normalized float32
  embed_texts(list[str])            -> [C, D] L2-normalized float32
'breastclip' (`models/breastclip.py`, which registers on first use) also embeds
uint8 batches on the device and provides the fused and resident M-dissect steps.
'random' is the deterministic test dissector. The OpenAI CLIP dissectors of
G-dissect (`ViT-B/32`, `ViT-B/16`, `ViT-L/14`, `clip`, `clip-cub`,
`clip-bloodmnist`) register when `models/clip_vit.py` is imported."""
from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

from mammodissect_torch.utils.registry import Registry

DISSECTORS: Registry = Registry("dissector")


def _l2n(x, axis=-1):
    return x / np.clip(np.linalg.norm(x, axis=axis, keepdims=True), 1e-12, None)


@DISSECTORS.register("random")
class RandomDissector:
    """Deterministic random-projection dissector for tests and benchmarks: images are
    average-pooled to a fixed grid and projected by a seeded random matrix; each
    concept text maps to a hash-seeded random unit vector. No semantics, but every
    pipeline stage runs with real shapes. Host numpy, like the projection and text
    vectors of the JAX version, which it equals: the text vectors and projection
    bit for bit; the pooling sums each cell in the order XLA's CPU reduction does
    (bit for bit at the test geometries)."""

    def __init__(self, dim: int = 512, grid: int = 8, seed: int = 0, **_):
        self.dim = dim
        self.grid = grid
        self.seed = seed
        self._proj = None

    def _pool(self, images: np.ndarray) -> np.ndarray:
        """Crop to a multiple of the grid, average each cell: [B, grid*grid*C]."""
        b, h, w, c = images.shape
        g = self.grid
        ch, cw = h // g, w // g
        cells = (np.asarray(images, np.float32)[:, :ch * g, :cw * g]
                 .reshape(b, g, ch, g, cw, c).transpose(2, 4, 0, 1, 3, 5)
                 .reshape(ch * cw, -1))
        # a sum over the outer axis adds the cells one after another
        return (cells.sum(axis=0) * np.float32(1.0 / (ch * cw))).reshape(b, g * g * c)

    def embed_images(self, images: np.ndarray) -> np.ndarray:
        pooled = self._pool(images)
        if self._proj is None or self._proj.shape[0] != pooled.shape[1]:
            rng = np.random.default_rng(self.seed)
            self._proj = rng.normal(size=(pooled.shape[1], self.dim)).astype(np.float32)
        return _l2n(pooled @ self._proj)

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), dtype=np.float32)
        for i, t in enumerate(texts):
            h = int.from_bytes(hashlib.sha256(t.encode()).digest()[:8], "little")
            out[i] = np.random.default_rng(h).normal(size=self.dim)
        return _l2n(out)


def get_dissector(name: str, **kw):
    """Build a registered dissector; model-backed ones register on first use."""
    if name not in DISSECTORS:
        if name.startswith("breastclip"):
            import mammodissect_torch.models.breastclip  # noqa: F401  (registers)
        elif name.lower().startswith(("vit-", "rn", "clip")):
            import mammodissect_torch.models.clip_vit  # noqa: F401  (registers)
    return DISSECTORS.get(name)(**kw)
