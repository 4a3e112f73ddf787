"""Zero-shot classification evaluation (counterpart of `mammodissect/zs/__init__.py`).

Fills the reference's *missing* `src/zero_shot_eval_clip.py` entry point (referenced by
`scripts/eval.sh:11`, configured by `configs/zs_clip.yaml`): embed each image with the
dissector's image tower, embed positive/negative prompt sets per task, score
p(pos) = softmax over (sim_pos_mean, sim_neg_mean), report AUROC per task. The
dissector runs on its own device; the scores are host numpy."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from mammodissect_torch import metrics as M
from mammodissect_torch.data.loader import iter_batches
from mammodissect_torch.data.prompts import default_zs_prompts


def zero_shot_scores(
    dissector,
    probe,
    prompts: Dict[str, Dict[str, Sequence[str]]] | None = None,
    batch_size: int = 32,
    temperature: float = 0.07,
) -> Dict[str, np.ndarray]:
    """Per-task positive-class probability for every probe image."""
    prompts = prompts or default_zs_prompts()
    feats = []
    for batch in iter_batches(probe, batch_size):
        feats.append(dissector.embed_images(batch.images)[: batch.n_valid])
    image_embs = np.concatenate(feats, axis=0)  # [N, D], normalized

    out: Dict[str, np.ndarray] = {}
    for task, pn in prompts.items():
        # standard CLIP prompt ensembling: re-normalize each mean — its raw norm
        # shrinks with intra-set prompt diversity, which would scale the pos/neg
        # logits asymmetrically and bias the score by phrasing diversity
        def _mean_emb(texts):
            m = dissector.embed_texts(list(texts)).mean(axis=0)
            return m / max(float(np.linalg.norm(m)), 1e-12)

        pos, neg = _mean_emb(pn["pos"]), _mean_emb(pn["neg"])
        logits = np.stack([image_embs @ pos, image_embs @ neg], axis=1) / temperature
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        out[task] = (e[:, 0] / e.sum(axis=1)).astype(np.float32)
    return out


def zero_shot_eval(
    dissector,
    probe,
    labels: Dict[str, np.ndarray],
    prompts=None,
    batch_size: int = 32,
) -> Dict[str, Dict[str, float]]:
    """AUROC / PR-AUC per task given ground-truth binary labels keyed by task name."""
    scores = zero_shot_scores(dissector, probe, prompts, batch_size)
    results = {}
    for task, s in scores.items():
        if task not in labels:
            continue
        gt = np.asarray(labels[task])
        results[task] = {
            "auroc": M.auroc(gt, s),
            "pr_auc": M.pr_auc(gt, s),
            "auprc": M.compute_auprc(gt, s),
        }
    return results
