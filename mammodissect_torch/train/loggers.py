"""TensorBoard and wandb logging (counterpart of `mammodissect/train/loggers.py`).

Both write from the first rank only, as the reference's `DistSummaryWriter`
(`util/dist_summery_writer.py:6-31`) and its rank-0 wandb runs; every other rank,
and a logger whose package (`tensorboard`, `wandb`) is missing or fails to start,
is a no-op."""
from __future__ import annotations

from typing import Dict, Optional

from mammodissect_torch.parallel.mesh import is_master


class MasterOnlyWriter:
    """TensorBoard scalars through torch.utils.tensorboard."""

    def __init__(self, log_dir: str):
        self._writer = None
        if not is_master():
            return
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
    """An offline wandb run (the reference's projects 'MammoCLIP_classifier_finetune'
    and 'broader_clip-dissect'); disabled when wandb is missing or its offline init
    fails."""

    def __init__(self, project: str, config: Optional[dict] = None, enabled: bool = False,
                 name: Optional[str] = None):
        self._run = None
        if not enabled or not is_master():
            return
        try:
            import wandb

            self._run = wandb.init(project=project, name=name, config=config or {},
                                   mode="offline")
        except Exception:  # wandb missing or its offline init failed: log nothing
            self._run = None

    def log(self, data: Dict):
        if self._run is not None:
            self._run.log(data)

    def finish(self):
        if self._run is not None:
            self._run.finish()
