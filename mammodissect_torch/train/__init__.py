"""Classifier fine-tuning (counterpart of `mammodissect/train/`): losses, the
learning-rate schedule, the single-device trainer, `.pth` checkpoints, the
CSV-driven dataset and the experiment loop behind `cli.finetune`."""

from mammodissect_torch.train.losses import (
    bce_with_logits,
    clip_contrastive_loss,
    softmax_cross_entropy,
)
from mammodissect_torch.train.schedule import linear_warmup_cosine_annealing

__all__ = [
    "linear_warmup_cosine_annealing",
    "bce_with_logits",
    "softmax_cross_entropy",
    "clip_contrastive_loss",
]
