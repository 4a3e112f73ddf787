"""TensorBoard and wandb logging (counterpart of `mammodissect/train/loggers.py`).

The port runs one process, so it is always the reference's master rank
(`util/dist_summery_writer.py:6-31`). Each logger is a no-op when its package
(`tensorboard`, `wandb`) is missing or fails to start."""
from __future__ import annotations

from typing import Dict, Optional


class MasterOnlyWriter:
    """TensorBoard scalars through torch.utils.tensorboard."""

    def __init__(self, log_dir: str):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:  # tensorboard missing or unusable: log nothing
            self._writer = None

    def add_scalar(self, tag: str, value, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), int(step))

    def close(self):
        if self._writer is not None:
            self._writer.close()


class WandbLogger:
    """An offline wandb run (the reference's project 'MammoCLIP_classifier_finetune');
    disabled when wandb is missing or its offline init fails."""

    def __init__(self, project: str, config: Optional[dict] = None, enabled: bool = False):
        self._run = None
        if not enabled:
            return
        try:
            import wandb

            self._run = wandb.init(project=project, config=config or {}, mode="offline")
        except Exception:  # wandb missing or its offline init failed: log nothing
            self._run = None

    def log(self, data: Dict):
        if self._run is not None:
            self._run.log(data)

    def finish(self):
        if self._run is not None:
            self._run.finish()
