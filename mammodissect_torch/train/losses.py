"""Losses (counterpart of `mammodissect/train/losses.py`).

- `softmax_cross_entropy`: CE with optional label smoothing (the reference's
  `torch.nn.CrossEntropyLoss` for density/birads/cancer_birads, `experiments.py:164-166`).
- `bce_with_logits`: weighted binary CE (`BCEWithLogitsLoss(pos_weight=...)`,
  `experiments.py:167-172`; per-task pos-weights at
  `lumi_single_gpu_train_classifier.py:156-184`).
- `clip_contrastive_loss`: the Mammo-CLIP pretraining objective
  (`concept_vit/utils.py:443`, `model/clip.py:21`), used by pretraining; data-parallel
  over a process group, its logits span the global batch.

`weights` [B] is a per-row weight: a weighted mean, which takes the wrap-padded tail
rows of a fixed-size batch out of the loss."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mammodissect_torch.parallel.collectives import all_gather_with_grad


def _weighted_mean(loss: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return (loss * weights).sum() / weights.sum().clamp_min(1e-12)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          label_smoothing: float = 0.0,
                          weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over the batch; `labels` are integer class ids [B], logits [B, C]
    (computed in the logits' dtype, as in the JAX package)."""
    n_class = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n_class).to(logits.dtype)
    if label_smoothing > 0.0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / n_class
    loss = -(onehot * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    if weights is not None:
        return _weighted_mean(loss, weights)
    return loss.mean()


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    pos_weight: float | torch.Tensor | None = None,
                    weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean binary CE in float32 with an optional positive-class weight (torch
    BCEWithLogitsLoss semantics: -[w_p y log s(x) + (1 - y) log(1 - s(x))]). With
    `weights`, [B, C] logits are averaged per row first, then weighted."""
    logits = logits.reshape(-1).float()
    labels = labels.reshape(-1).float()
    w = 1.0 if pos_weight is None else pos_weight
    loss = -(w * labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))
    if weights is not None:
        weights = weights.reshape(-1).float()
        return _weighted_mean(loss.reshape(weights.shape[0], -1).mean(dim=1), weights)
    return loss.mean()


def _symmetric_ce(logits: torch.Tensor, labels: torch.Tensor, label_smoothing: float):
    return 0.5 * (softmax_cross_entropy(logits, labels, label_smoothing)
                  + softmax_cross_entropy(logits.t(), labels, label_smoothing))


def clip_contrastive_loss(image_embeddings: torch.Tensor, text_embeddings: torch.Tensor,
                          logit_scale, label_smoothing: float = 0.0,
                          image_view_embeddings: torch.Tensor | None = None,
                          text_embeddings2: torch.Tensor | None = None,
                          i2i_weight: float = 0.0, t2t_weight: float = 0.0,
                          group=None) -> torch.Tensor:
    """Symmetric InfoNCE over the batch, plus the optional image-image and text-text
    views of BreastClip.forward (`model/clip.py:119-136`). Embeddings are
    L2-normalized, `logit_scale` is exp(log 1/T); labels are arange(B). The products
    are taken in float32 (the JAX package's preferred_element_type).

    `group` (data parallelism): each rank passes its rows of the global batch; the
    other side of every product is all-gathered with its gradient
    (`all_gather_with_grad`), so the logits run over the global batch, the labels
    are arange over it offset by the rank, and the i2i and t2t terms see it too.
    Returns this rank's mean over its rows, whose mean over the ranks (equal rows
    each) is the global loss; the gradients' average over the ranks is its
    gradient."""
    b = image_embeddings.shape[0]
    rank = 0 if group is None else torch.distributed.get_rank(group)
    labels = torch.arange(b, device=image_embeddings.device) + rank * b

    def logits(a, b):
        return logit_scale * (a.float() @ b.float().t())

    def symmetric(a, c):
        if group is None:
            return _symmetric_ce(logits(a, c), labels, label_smoothing)
        return 0.5 * (
            softmax_cross_entropy(logits(a, all_gather_with_grad(c, group)), labels,
                                  label_smoothing)
            + softmax_cross_entropy(logits(c, all_gather_with_grad(a, group)), labels,
                                    label_smoothing))

    loss = symmetric(image_embeddings, text_embeddings)
    if image_view_embeddings is not None and i2i_weight > 0.0:
        loss = loss + i2i_weight * symmetric(image_embeddings, image_view_embeddings)
    if text_embeddings2 is not None and t2t_weight > 0.0:
        loss = loss + t2t_weight * symmetric(text_embeddings, text_embeddings2)
    return loss
