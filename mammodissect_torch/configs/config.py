"""Dataclass configs from JSON (or YAML) files with dotted CLI overrides (counterpart
of `mammodissect/configs/config.py`, copied):

    cfg = load_config(DissectConfig, "runs/dissect_vindr.json",
                      overrides=["similarity_fn=wpmi", "top_k=50"])

`presets/` holds the JAX package's three presets, each for one of the port's
dataclasses (`load_preset`): `dissect_mammoclip` (dissect.engine.DissectConfig),
`finetune_vindr_mass` (train.experiments.FinetuneConfig) and `zs_clip`
(`ZeroShotConfig`, the flags of `cli.zseval`). JSON has no comments, so a key that
starts with "_" (a preset's "_comment") is a note, not a field."""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Type, TypeVar

T = TypeVar("T")

PRESETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "presets")


@dataclass
class ZeroShotConfig:
    """The zero-shot preset (the reference's hydra root `configs/zs_clip.yaml`)."""

    d_probe: str = "vindr"
    clip_model: str = "breastclip"
    batch_size: int = 4
    image_size: tuple = (1520, 912)
    mean: float = 0.3089279
    std: float = 0.25053555
    text_max_length: int = 256
    tasks: List[str] = field(default_factory=lambda: ["Mass", "Suspicious_Calcification"])
    prompts: Optional[Dict[str, Dict[str, List[str]]]] = None


def _load_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError:
            raise RuntimeError("pyyaml not available; use JSON config files")
        return yaml.safe_load(text) or {}
    return json.loads(text)


def _coerce(value: str, field_type) -> Any:
    """A CLI override string parsed to the field's type. The type may be a string
    annotation ('bool', 'Optional[float]'): the config dataclasses' modules use
    `from __future__ import annotations`."""
    if isinstance(field_type, str):
        t = field_type.replace("Optional[", "").rstrip("]").strip()
        field_type = {"int": int, "float": float, "bool": bool, "str": str}.get(t)
    if field_type is int:
        return int(value)
    if field_type is float:
        return float(value)
    if field_type is bool:
        return value.lower() in ("1", "true", "y", "yes")
    if field_type is str:
        return value
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        return value


def apply_overrides(data: Dict[str, Any], overrides: Sequence[str],
                    cls: Optional[Type] = None) -> Dict[str, Any]:
    """'key=value' / 'nested.key=value' overrides into a config dict."""
    types = {}
    if cls is not None and dataclasses.is_dataclass(cls):
        types = {f.name: f.type for f in dataclasses.fields(cls)}
    out = dict(data)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, value = ov.split("=", 1)
        parts = key.split(".")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        ftype = types.get(parts[0]) if len(parts) == 1 else None
        node[parts[-1]] = _coerce(value, ftype)
    return out


def load_config(cls: Type[T], path: Optional[str] = None, overrides: Sequence[str] = ()) -> T:
    data: Dict[str, Any] = _load_file(path) if path else {}
    data = {k: v for k, v in data.items() if not k.startswith("_")}
    data = apply_overrides(data, overrides, cls)
    field_names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - field_names
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    for f in dataclasses.fields(cls):  # tuples are written as lists
        if f.name in data and isinstance(data[f.name], list) and f.type in (tuple, "tuple"):
            data[f.name] = tuple(data[f.name])
    return cls(**data)


def load_preset(cls: Type[T], name: str, overrides: Sequence[str] = ()) -> T:
    """One of `presets/` (by its name without .json) as `cls`."""
    return load_config(cls, os.path.join(PRESETS, f"{name}.json"), overrides)


def save_config(cfg, path: str) -> None:
    data = dataclasses.asdict(cfg)
    with open(path, "w") as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            yaml.safe_dump(data, f, sort_keys=False)
        else:
            json.dump(data, f, indent=2, default=str)
