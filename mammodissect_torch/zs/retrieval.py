"""Image<->text retrieval evaluation (a copy of `mammodissect/zs/retrieval.py`, the
capability behind the reference's `imagetext_retrieval` dataset,
`data/dataset/imagetext_retrieval.py`)."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def retrieval_metrics(image_embs: np.ndarray, text_embs: np.ndarray,
                      ks: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """Recall@k both directions + median rank for paired, L2-normalized embeddings."""
    sims = image_embs @ text_embs.T  # [N, N]
    n = sims.shape[0]
    out: Dict[str, float] = {}
    for name, s in (("i2t", sims), ("t2i", sims.T)):
        order = np.argsort(-s, axis=1)
        # rank of the true pair = column where order[i] == i, vectorized
        ranks = np.nonzero(order == np.arange(n)[:, None])[1]
        for k in ks:
            out[f"{name}_recall@{k}"] = float((ranks < k).mean())
        out[f"{name}_median_rank"] = float(np.median(ranks) + 1)
    return out


def evaluate_retrieval(dissector, dataset, batch_size: int = 32,
                       ks: Sequence[int] = (1, 5, 10)) -> Dict[str, float]:
    """Embed a dataset's images and texts pairwise and score. `dataset` is any
    sequence of {"image": HWC float32, "text": str} items (`len()` and indexing).

    Images decode lazily per batch: at the canonical 1520x912 float32
    (~5.5 MB/image) a few thousand pairs pre-materialized would be >10 GB of
    host RAM; only `batch_size` images ever live at once."""
    n = len(dataset)
    texts = []
    img_embs = []
    for start in range(0, n, batch_size):
        batch = [dataset[i] for i in range(start, min(start + batch_size, n))]
        texts.extend(item["text"] for item in batch)
        img_embs.append(dissector.embed_images(
            np.stack([item["image"] for item in batch])))
    image_embs = np.concatenate(img_embs) if img_embs else np.zeros((0, 1))
    text_embs = dissector.embed_texts(texts)
    return retrieval_metrics(image_embs, text_embs, ks)
