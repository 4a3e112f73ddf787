"""Fine-tune checkpoints as torch `.pth` files (counterpart of
`mammodissect/train/checkpoints.py`, whose orbax directories need jax to read).

The payload is the reference's (`Classifiers/experiments.py:243-276`: {"model":
state_dict, "predictions", "epoch", "auroc" | "accuracy", "f1"}) plus what a resume
needs: {"model": state_dict (floating tensors float32), "optimizer", "scheduler",
"step", "epoch", "metrics", "predictions"} and the top-level metric keys. The
"model" entries carry the reference's names (`image_encoder.*`, `classifier.fc.*`),
so the `breastclip_classifier` dissection target loads the file as it is
(`convert.load_classifier_checkpoint`)."""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

REFERENCE_METRIC_KEYS = ("auroc", "accuracy", "f1")


def save_checkpoint(path: str, trainer, epoch: int, metrics: Dict[str, float],
                    predictions: Optional[np.ndarray] = None,
                    model_state: Optional[Dict] = None,
                    optimizer_state: Optional[Dict] = None) -> str:
    """Write the trainer's state to `path`: a temporary file first, then `os.replace`
    into place, so a reader never sees half a checkpoint. `model_state` and
    `optimizer_state` replace the trainer's own state dicts (a tensor-parallel
    model's, gathered to whole tensors)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if model_state is None:
        model_state = trainer.model.state_dict()
    model = {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu()
             for k, v in model_state.items()}
    payload = {
        "model": model,
        "optimizer": (trainer.optimizer.state_dict() if optimizer_state is None
                      else optimizer_state),
        "scheduler": None if trainer.scheduler is None else trainer.scheduler.state_dict(),
        "step": int(trainer.step),
        "epoch": int(epoch),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "predictions": None if predictions is None else torch.as_tensor(np.asarray(predictions)),
    }
    payload.update({k: float(metrics[k]) for k in REFERENCE_METRIC_KEYS if k in metrics})
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload, every tensor on the CPU (tensors and plain values only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_for_eval(path: str) -> Dict[str, Any]:
    """{"model": state_dict, "predictions": ndarray or None, "epoch", "metrics"}."""
    ckpt = load_checkpoint(path)
    preds = ckpt.get("predictions")
    return {
        "model": ckpt["model"],
        "predictions": None if preds is None else preds.numpy(),
        "epoch": int(ckpt.get("epoch", -1)),
        "metrics": ckpt.get("metrics") or {},
    }
