"""Dataclass configs: files, overrides and presets (`configs/config.py`)."""

from mammodissect_torch.configs.config import (
    ZeroShotConfig,
    apply_overrides,
    load_config,
    load_preset,
    save_config,
)

__all__ = ["load_config", "load_preset", "save_config", "apply_overrides", "ZeroShotConfig"]
