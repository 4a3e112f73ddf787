"""Deterministic seeding (counterpart of `mammodissect/utils/seed.py`): the reference's
external `seed_all` (`Classifiers/experiments.py:46`, `util/utils.py:seed_everything`),
and `convert_dictconfig_to_dict` (`util/utils.py`).

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


# alias matching `util/utils.py` in the reference
seed_everything = seed_all


def convert_dictconfig_to_dict(cfg):
    """An omegaconf DictConfig (or any mapping, list or tuple of them) as plain
    dicts, recursively (`util/utils.py`); works without omegaconf installed."""
    try:
        from omegaconf import OmegaConf

        if OmegaConf.is_config(cfg):
            return OmegaConf.to_container(cfg, resolve=True)
    except ImportError:
        pass
    if isinstance(cfg, dict):
        return {k: convert_dictconfig_to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(convert_dictconfig_to_dict(v) for v in cfg)
    return cfg
