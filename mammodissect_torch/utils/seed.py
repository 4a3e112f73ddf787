"""Deterministic seeding (counterpart of `mammodissect/utils/seed.py`): the reference's
external `seed_all` (`Classifiers/experiments.py:46`, `util/utils.py:seed_everything`).

Seeds the host RNGs (python, numpy) and torch's default generators. The port's own
randomness does not depend on them: weights come from explicit torch.Generators and
the drop-connect masks from the trainer's generator."""
from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_all(seed: int = 10) -> None:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
