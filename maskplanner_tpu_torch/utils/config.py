"""Minimal hierarchical config system (OmegaConf-free).

Provides the same user-facing contract as the reference config layer
(``utils/config.py:5-11`` and ``utils/args.py``): YAML trees with attribute
and item access, deep merging where later sources win, and dotted-key CLI
overrides (``lr_sched.gamma=0.1``).
"""
from __future__ import annotations

import os
from typing import Any, Iterator, Mapping

import yaml


class Config(dict):
    """A dict with attribute access and recursive wrapping of nested dicts.

    ``cfg.model.backbone`` and ``cfg['model']['backbone']`` are equivalent.
    Missing attribute access raises AttributeError (like OmegaConf in strict
    mode); use ``.get`` for optional keys.
    """

    def __init__(self, data: Mapping | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    # -- wrapping ----------------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any):
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any):
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    # -- dotted access -----------------------------------------------------
    def select(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_dotted(self, dotted: str, value: Any):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    # -- merging -----------------------------------------------------------
    def merge(self, other: Mapping) -> "Config":
        """Deep-merge ``other`` into self (other wins); returns self."""
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], Config)
                and isinstance(v, Mapping)
            ):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    # -- conversion --------------------------------------------------------
    def to_dict(self) -> dict:
        out: dict = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, Config) else x for x in v]
            else:
                out[k] = v
        return out

    def copy(self) -> "Config":
        return Config(self.to_dict())

    def __deepcopy__(self, memo) -> "Config":
        return Config(self.to_dict())


# ---------------------------------------------------------------------------
# YAML I/O (reference: utils/config.py:5-11)
# ---------------------------------------------------------------------------

def load_config(filepath: str) -> Config:
    """Load a YAML file into a Config. Accepts a run dir or a yaml path."""
    if os.path.isdir(filepath):
        filepath = os.path.join(filepath, "config.yaml")
    with open(filepath, "r", encoding="utf-8") as f:
        data = yaml.safe_load(f) or {}
    return Config(data)


def save_config(config: Config | Mapping, path: str):
    """Save config as ``config.yaml`` inside directory ``path`` (or to a
    file path ending in .yaml)."""
    if not str(path).endswith((".yaml", ".yml")):
        path = os.path.join(path, "config.yaml")
    data = config.to_dict() if isinstance(config, Config) else dict(config)
    with open(path, "w", encoding="utf-8") as f:
        yaml.safe_dump(data, f, default_flow_style=None, sort_keys=False)


def apply_retrocompat_defaults(config: Config) -> Config:
    """Default keys absent in old run configs
    (reference test_maskplanner.py:86-101)."""
    defaults = {
        "traj_with_equally_spaced_points": False,
        "equal_in_3d_space": False,
        "per_segment_confidence": False,
        "smooth_target_stroke_masks": False,
        "data_scale_factor": None,
        "augmentations": [],
        "overfitting": False,
    }
    for k, v in defaults.items():
        if k not in config:
            config[k] = v
    return config


def parse_value(text: str) -> Any:
    """Parse a CLI value string using YAML semantics.

    ``'1e-3'`` -> 1e-3, ``'[a,b]'`` -> ['a','b'], ``'null'`` -> None,
    ``'true'`` -> True, anything unparseable stays a string.
    """
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    # YAML 1.1 parses `1e-3` as a string; coerce scientific notation floats.
    if isinstance(value, str):
        try:
            return float(value) if any(c in value for c in ".eE") and _floatable(value) else value
        except ValueError:
            return value
    return value


def _floatable(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
