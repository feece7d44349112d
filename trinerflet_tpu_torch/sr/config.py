"""YAML config layer and scheduled scalars (port of ``trinerflet_tpu/sr/
config.py``).

Plain YAML files parsed into nested dataclasses by :func:`parse_structured`,
dotlist overrides, and the time-varying scalar ``C(value, step)``: a number
passes through, a list ``[start_step, start_value, end_value, end_step]``
(or ``[start_value, end_value, end_step]``) interpolates linearly in
``step``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import yaml

__all__ = ["C", "load_yaml_config", "parse_structured", "apply_overrides"]

ScheduledFloat = Union[float, int, List[float]]


def C(value: ScheduledFloat, step: int) -> float:
    """Scheduled scalar: numbers pass through; a 4-list
    [start_step, start_value, end_value, end_step] interpolates linearly."""
    if isinstance(value, (int, float)):
        return float(value)
    if not isinstance(value, (list, tuple)) or len(value) not in (3, 4):
        raise ValueError(f"cannot interpret scheduled value {value!r}")
    if len(value) == 3:
        start_step, start_value, end_value, end_step = 0, value[0], value[1], value[2]
    else:
        start_step, start_value, end_value, end_step = value
    if end_step <= start_step:
        return float(end_value)
    t = min(max((step - start_step) / (end_step - start_step), 0.0), 1.0)
    return float(start_value + (end_value - start_value) * t)


def load_yaml_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def apply_overrides(cfg: Dict[str, Any], overrides: List[str]) -> Dict[str, Any]:
    """Dotlist overrides: ["system.sr_start_step=100", "data.root=/x"]; each
    value is parsed as YAML."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(raw)
    return cfg


def parse_structured(cls, cfg: Optional[Dict[str, Any]]) -> Any:
    """A (possibly nested) dataclass from a dict; unknown keys raise."""
    cfg = cfg or {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(cfg) - set(fields)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, field in fields.items():
        if name not in cfg:
            continue
        val = cfg[name]
        if dataclasses.is_dataclass(field.type) and isinstance(val, dict):
            val = parse_structured(field.type, val)
        elif isinstance(val, dict) and dataclasses.is_dataclass(getattr(field, "default_factory", None)):
            val = parse_structured(type(field.default_factory()), val)
        kwargs[name] = val
    return cls(**kwargs)
