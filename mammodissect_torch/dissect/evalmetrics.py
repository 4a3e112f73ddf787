"""Description-quality evaluation (a copy of `mammodissect/dissect/evalmetrics.py`,
the reference's `get_cos_similarity`, `concept_vit/utils.py:618-646` and
`CLIP_og_utils.py:178`): score predicted neuron descriptions against ground-truth
names by text-embedding cosine.

The reference scores with the OpenAI-CLIP text tower AND an mpnet sentence encoder.
Here the defaults are the port's towers (`default_text_embedder`): the CLIP text
transformer for the CLIP score and the BreastClip BERT tower in the
sentence-encoder role (mpnet weights are not in the repository; pass
`sentence_embedder=` to use one, e.g. a sentence-transformers `.encode`). Any
`texts -> [N, D]` callable slots into either role."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def description_cos_similarity(
    predicted: Sequence[str],
    ground_truth: Sequence[str],
    text_embedder,
    template: str = "{}",
) -> np.ndarray:
    """Per-neuron cosine between embedded predicted and ground-truth descriptions.

    `text_embedder(texts) -> [N, D] L2-normalized` (a dissector's `embed_texts`)."""
    if len(predicted) != len(ground_truth):
        raise ValueError("predicted and ground_truth must align per neuron")
    pe = np.asarray(text_embedder([template.format(t) for t in predicted]))
    ge = np.asarray(text_embedder([template.format(t) for t in ground_truth]))
    pe = pe / np.clip(np.linalg.norm(pe, axis=1, keepdims=True), 1e-12, None)
    ge = ge / np.clip(np.linalg.norm(ge, axis=1, keepdims=True), 1e-12, None)
    return np.sum(pe * ge, axis=1)


def mean_description_similarity(predicted, ground_truth, text_embedder, **kw) -> float:
    return float(np.mean(description_cos_similarity(predicted, ground_truth,
                                                    text_embedder, **kw)))


def default_text_embedder(kind: str = "clip", ckpt_path: Optional[str] = None, **kw):
    """The port's default embedders, so the evaluation runs with no download.

    kind="clip": the OpenAI-CLIP text transformer (`clip_model.encode_text` role,
    `utils.py:622-638`); kind="bert": the BreastClip Bio_ClinicalBERT tower in the
    mpnet sentence-encoder role (`utils.py:641-644`). Pass `ckpt_path` to embed with
    real weights, `device=` as to every factory (CUDA by default).

    Without a checkpoint the tower has DETERMINISTIC RANDOM weights: identical texts
    still embed identically (so exact-match scoring works), but cosine scores between
    different texts are NOT semantically meaningful — untrained-transformer embeddings
    are anisotropic and near-text-length-driven. Fine as a smoke default; a runtime
    warning fires so real evaluations can't use it unnoticed."""
    if ckpt_path is None:
        import warnings

        warnings.warn(
            f"default_text_embedder({kind!r}) without ckpt_path: embeddings come "
            "from a RANDOM-INIT tower — only exact-match description scores are "
            "meaningful. Pass ckpt_path=<weights> for semantic scores.",
            stacklevel=2,
        )
    if kind == "clip":
        from mammodissect_torch.models.clip_vit import OpenAIClip

        return OpenAIClip(ckpt_path=ckpt_path, **kw).embed_texts
    if kind == "bert":
        from mammodissect_torch.dissect.dissectors import get_dissector

        return get_dissector("breastclip", ckpt_path=ckpt_path, **kw).embed_texts
    raise KeyError(f"unknown default embedder kind {kind!r} (clip | bert)")


def get_cos_similarity(
    preds: Sequence[str],
    gt: Sequence[str],
    clip_embedder=None,
    sentence_embedder=None,
    **embedder_kw,
) -> Tuple[float, float]:
    """Reference-shaped entry (`utils.py:618-646`): returns
    (mean CLIP-text cosine, mean sentence-encoder cosine) between predicted and
    ground-truth descriptions. Both embedders default to the port's towers."""
    clip_embedder = clip_embedder or default_text_embedder("clip", **embedder_kw)
    sentence_embedder = sentence_embedder or default_text_embedder("bert", **embedder_kw)
    if hasattr(sentence_embedder, "encode"):  # sentence-transformers duck type
        sentence_embedder = sentence_embedder.encode
    return (
        mean_description_similarity(preds, gt, clip_embedder),
        mean_description_similarity(preds, gt, sentence_embedder),
    )
