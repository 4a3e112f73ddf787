"""Config files (the part of `mammodissect/configs/config.py` fine-tuning uses, copied)."""
from __future__ import annotations

import dataclasses
import json


def save_config(cfg, path: str) -> None:
    """A dataclass config as JSON."""
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
