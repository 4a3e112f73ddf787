"""Learning-rate schedule (counterpart of `mammodissect/train/schedule.py`): the
reference's `LinearWarmupCosineAnnealingLR` (`Classifiers/experiments.py:150-156`):
linear warmup from 0 to `base_lr` over `warmup_steps`, then cosine annealing to 0
over the remaining steps (the reference's warmup_start_lr and eta_min, both 0).

`linear_warmup_cosine_annealing` returns the function step -> lr; `lr_scheduler`
drives an optimizer with it through `LambdaLR`, stepped once after each
`optimizer.step()`. Update i (0-based) then runs at lr(i), optax's schedule(i): with
warmup, the first update has lr 0."""
from __future__ import annotations

import math
from typing import Callable

import torch


def linear_warmup_cosine_annealing(base_lr: float, warmup_steps: int,
                                   total_steps: int) -> Callable[[int], float]:
    """optax's join_schedules([linear_schedule, cosine_decay_schedule]) as the JAX
    package builds it, in float64."""
    warmup_steps = max(int(warmup_steps), 0)
    decay_steps = max(int(total_steps) - warmup_steps, 1)

    # optax's own expressions, so the float64 values agree to the last bit
    def lr_at(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return -base_lr * frac + base_lr
        count = min(step - warmup_steps, decay_steps)
        return base_lr * (0.5 * (1.0 + math.cos(math.pi * count / decay_steps)))

    return lr_at


def lr_scheduler(optimizer: torch.optim.Optimizer,
                 lr_at: Callable[[int], float]) -> torch.optim.lr_scheduler.LambdaLR:
    """LambdaLR whose lr after k scheduler steps is lr_at(k) in every parameter group
    (LambdaLR scales each group's initial lr; the groups share one base lr)."""
    def factor(step: int) -> float:
        base = optimizer.defaults["lr"]
        return lr_at(step) / base if base else 0.0

    return torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def set_scheduler_step(scheduler: torch.optim.lr_scheduler.LambdaLR, step: int) -> None:
    """Put the scheduler at `step` (resume): its count and the groups' lr."""
    scheduler.last_epoch = int(step)
    for group, base, fn in zip(scheduler.optimizer.param_groups, scheduler.base_lrs,
                               scheduler.lr_lambdas):
        group["lr"] = base * fn(int(step))
    scheduler._last_lr = [g["lr"] for g in scheduler.optimizer.param_groups]
