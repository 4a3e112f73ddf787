"""Fine-tune trainer (counterpart of `mammodissect/train/trainer.py`): train and eval
steps of a classifier on one device.

Against the reference's DDP engine (`Classifiers/experiments.py:97-465`) and the JAX
trainer:
- AMP GradScaler fp16 (`:157,376-447`) -> bf16 compute with float32 master weights
  and optimizer state (the model's `dtype`/`param_dtype`); bf16 keeps fp32's exponent
  range, so no loss scaling.
- the per-step scheduler of the breast_clip archs (`:438`) -> `LambdaLR` over
  `schedule.linear_warmup_cosine_annealing`, stepped after each update.
- linear-probe freezing (requires_grad=False) -> `make_optimizer` with the labels of
  `models.classifier.frozen_param_labels`.
- the uint8 input wire: post-transform uint8 batches cross to the device pinned and
  `non_blocking`, and `ops.normalize.u8_minmax_meanstd` normalizes them there.
- drop-connect masks come from the trainer's own torch.Generator on the device,
  seeded from `seed`.
- data parallelism (a process group, one process per GPU): the model is wrapped in
  DistributedDataParallel over the data group, whose gradient all-reduce is the one
  XLA inserts for JAX's mesh, with `broadcast_buffers` off (the synced training
  BatchNorm keeps the running statistics equal). Each rank holds its slice of the
  global batch; the step runs inside `parallel.mesh.data_parallel`, so BatchNorm
  takes the global batch's moments and the drop-connect masks are drawn for the
  global batch and sliced by rank, and the padded tail's row weights count over
  the global batch: a step equals the single-process step on the global batch."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mammodissect_torch.device import resolve_device
from mammodissect_torch.ops.normalize import u8_minmax_meanstd
from mammodissect_torch.parallel.collectives import psum
from mammodissect_torch.parallel.mesh import data_group, data_parallel
from mammodissect_torch.train.losses import bce_with_logits, softmax_cross_entropy
from mammodissect_torch.train.schedule import (
    linear_warmup_cosine_annealing,
    lr_scheduler,
    set_scheduler_step,
)


def make_optimizer(model: torch.nn.Module, lr: float, weight_decay: float, warmup_steps: int,
                   total_steps: int, param_labels: Optional[Dict[str, str]] = None):
    """(AdamW, LambdaLR) with linear warmup and cosine decay (`experiments.py:144-156`).

    AdamW with betas (0.9, 0.999), eps 1e-8 and decoupled weight decay p(1 - lr wd) is
    optax's adamw (scale_by_adam -> add_decayed_weights -> -lr); torch's default decay
    of 1e-2 is never used. Parameters labelled "frozen" get requires_grad False and
    stay out of the optimizer: no update, no weight decay, no Adam state."""
    params = []
    for name, p in model.named_parameters():
        if param_labels is not None and param_labels[name] == "frozen":
            p.requires_grad_(False)
        else:
            params.append(p)
    optimizer = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    scheduler = lr_scheduler(optimizer, linear_warmup_cosine_annealing(lr, warmup_steps,
                                                                       total_steps))
    return optimizer, scheduler


def row_weights(batch_len: int, n_valid: Optional[int]) -> np.ndarray:
    """1 for the batch's real rows, 0 for the wrap-padded tail beyond `n_valid`."""
    if n_valid is None:
        return np.ones((batch_len,), np.float32)
    return (np.arange(batch_len) < int(n_valid)).astype(np.float32)


class Trainer:
    """Train and eval steps of `model` (moved to `device` in place: its parameters
    keep their identity, so an optimizer built over them stays valid).

    loss_kind "bce" (pos_weight optional) or "ce"; input_wire "f32" (batches arrive
    normalized) or "u8" (normalized on the device with norm_mean/norm_std). `device`
    None is CUDA, which raises without a GPU. Under a process group the trainer is
    data-parallel over `mesh`'s data axis (None: every rank); each rank passes its
    slice of the global batch."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 scheduler=None, loss_kind: str = "bce", pos_weight: Optional[float] = None,
                 seed: int = 0, input_wire: str = "f32", norm_mean: float = 0.0,
                 norm_std: float = 1.0, device=None, mesh=None):
        if input_wire not in ("f32", "u8"):
            raise ValueError(f"input_wire must be 'f32' or 'u8', got {input_wire!r}")
        if loss_kind not in ("bce", "ce"):
            raise ValueError(f"loss_kind must be 'bce' or 'ce', got {loss_kind!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.loss_kind = loss_kind
        self.pos_weight = pos_weight
        self.input_wire = input_wire
        self.norm_mean, self.norm_std = float(norm_mean), float(norm_std)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.step = 0
        self.group = data_group(mesh)
        self.net = self.model
        if self.group is not None:
            from torch.nn.parallel import DistributedDataParallel

            self.net = DistributedDataParallel(self.model, process_group=self.group,
                                               broadcast_buffers=False)

    def _loss(self, logits, labels, weights):
        if self.loss_kind == "ce":
            return softmax_cross_entropy(logits, labels, weights=weights)
        return bce_with_logits(logits, labels, pos_weight=self.pos_weight, weights=weights)

    def _to_device(self, images: np.ndarray, labels: np.ndarray, n_valid: Optional[int]):
        """The batch on the device: images through a pinned buffer with a
        non-blocking copy (on CUDA), normalized there on the u8 wire."""
        host = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type == "cuda":
            host = host.pin_memory()
        x = host.to(self.device, non_blocking=True)
        x = u8_minmax_meanstd(x, self.norm_mean, self.norm_std) if self.input_wire == "u8" \
            else x.float()
        y = torch.as_tensor(np.asarray(labels)).to(self.device)
        if self.loss_kind == "ce":
            y = y.long()
        w = torch.from_numpy(row_weights(len(labels), n_valid)).to(self.device)
        return x, y, w

    def train_batch(self, images: np.ndarray, labels: np.ndarray,
                    n_valid: Optional[int] = None) -> float:
        """One update on a batch; `n_valid` real rows, the wrap-padded tail beyond it
        weighted 0 in the loss. Returns the loss."""
        self.model.train()
        x, y, w = self._to_device(images, labels, n_valid)
        self.optimizer.zero_grad(set_to_none=True)
        # the backward inside too: a rematerialized block's recompute is part of the step
        with data_parallel(self.group):
            loss = self._loss(self.net(x, generator=self.generator), y, w)
            if self.group is not None:
                # this rank's share of the global weighted mean, times the ranks:
                # DDP averages the gradients over them
                w_global = psum(w.sum(), self.group)
                loss = loss * (w.sum() / w_global.clamp_min(1e-12))
                size = torch.distributed.get_world_size(self.group)
                (loss * size).backward()
                loss = psum(loss.detach(), self.group)
            else:
                loss.backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1
        return float(loss.detach())

    @torch.no_grad()
    def eval_batch(self, images: np.ndarray, labels: np.ndarray,
                   n_valid: Optional[int] = None) -> Tuple[float, np.ndarray]:
        """(loss, predictions [B]) in eval mode: the sigmoid of the first logit (BCE)
        or the argmax class (CE); under a process group, this rank's rows and loss
        (the caller gathers the predictions, `parallel.multihost.gather_predictions`)."""
        self.model.eval()
        x, y, w = self._to_device(images, labels, n_valid)
        logits = self.model(x)
        loss = self._loss(logits, y, w)
        if self.loss_kind == "ce":
            preds = logits.argmax(dim=-1).float()
        else:
            preds = torch.sigmoid(logits.reshape(logits.shape[0], -1)[:, 0].float())
        return float(loss), preds.cpu().numpy()

    def restore(self, ckpt: Dict) -> None:
        """Resume from a `train.checkpoints` payload: the model's weights and
        statistics, the optimizer's Adam moments and counts, the step. The
        optimizer keeps this run's hyperparameters (lr, weight decay, betas) and
        the scheduler this run's schedule at the restored step, as the JAX trainer
        keeps its optax chain and restores only the state."""
        self.model.load_state_dict(ckpt["model"])
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(ckpt["optimizer"])
        for group, h in zip(self.optimizer.param_groups, hyper):
            group.update(h)
        self.step = int(ckpt["step"])
        if self.scheduler is not None:
            set_scheduler_step(self.scheduler, self.step)
