"""CLI argument / config loading.

User contract (identical to the reference, ``utils/args.py:59-134``):

    python train_maskplanner.py config=[maskplanner,cuboids_v2,longx_v2] lr=1e-4

Priority: CLI ``k=v`` > listed config yamls (later files win) > ``default.yaml``.
Aliases expand to lists of config files (``config_aliases``,
reference utils/args.py:123-134). Certain params are coerced to lists
(reference PARAMS_AS_LIST, utils/args.py:17).
"""
from __future__ import annotations

import os
import sys
from typing import Sequence

from .config import Config, load_config, parse_value

DEFAULT_CONFIG = "default.yaml"
PARAMS_AS_LIST = ["exp", "loss", "eval_metrics", "extra_data", "augmentations", "dataset"]

_PKG_CONFIG_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs", "maskplanner"
)


def config_aliases() -> dict[str, list[str]]:
    """Alias -> list of config file stems (reference utils/args.py:123-134)."""
    return {
        "maskplanner": ["asymm_chamfer_v9", "delayMasksLoss", "traj_sampling_v2", "sched_v9"],
        "segmentWise": ["stable_v1", "delayMasksLoss", "traj_sampling_v2", "sched_v9"],
        "pointWise": ["lambda1", "delayMasksLoss", "traj_sampling_v2", "sched_v9"],
    }


def is_alias(name: str) -> bool:
    return name in config_aliases()


def _with_ext(name: str) -> str:
    stem, _ = os.path.splitext(name)
    return stem + ".yaml"


def _parse_cli(argv: Sequence[str]) -> tuple[Config, list[str]]:
    """Parse ``k=v`` tokens (dotted keys allowed) into a Config.

    Also returns the list of explicitly-given (dotted) keys, in order —
    the resume flow needs to distinguish user-typed overrides from
    default.yaml underlays (both end up in the merged config)."""
    cli = Config()
    keys: list[str] = []
    for token in argv:
        if "=" not in token:
            continue
        key, _, raw = token.partition("=")
        cli.set_dotted(key.strip(), parse_value(raw))
        keys.append(key.strip())
    return cli, keys


def _as_list(value):
    if isinstance(value, str):
        return [value]
    if isinstance(value, (list, tuple)):
        return list(value)
    raise ValueError(f"expected str or list, got {type(value)}")


def load_args(root: str | None = None, argv: Sequence[str] | None = None) -> Config:
    """Build the run config from default.yaml + listed configs + CLI overrides.

    Parameters
    ----------
    root : config directory (defaults to the packaged ``configs/maskplanner``).
    argv : override for ``sys.argv[1:]`` (used by tests).
    """
    conf_path = root or _PKG_CONFIG_ROOT
    argv = list(sys.argv[1:]) if argv is None else list(argv)

    cli_args, cli_keys = _parse_cli(argv)

    # CPU-affinity pinning (reference utils/args.py:68-72); best-effort.
    if "cpu" in cli_args:
        try:
            import psutil

            lo, hi = cli_args["cpu"][0], cli_args["cpu"][1]
            psutil.Process().cpu_affinity(list(range(lo, hi + 1)))
        except Exception:
            pass

    conf_args = Config()
    auto_group_parts: list[str] = []

    requested = cli_args.get("config")
    if requested:
        names = [requested] if isinstance(requested, str) else list(requested)
        expanded: list[str] = []
        for name in names:
            expanded.extend(config_aliases()[name] if is_alias(name) else [name])
        for name in expanded:
            auto_group_parts.append(name[:1].upper() + name[1:])
            conf_args.merge(load_config(os.path.join(conf_path, _with_ext(name))))

    conf_args.merge(cli_args)
    conf_args["auto_wandb_group"] = "_".join(auto_group_parts)

    # Underlay defaults unless suppressed (reference utils/args.py:100-104).
    if ("default" not in conf_args or conf_args["default"]) and "render" not in conf_args:
        defaults = load_config(os.path.join(conf_path, DEFAULT_CONFIG))
        defaults.merge(conf_args)
        conf_args = defaults

    for key in PARAMS_AS_LIST:
        if key in conf_args and conf_args[key] is not None:
            try:
                conf_args[key] = _as_list(conf_args[key])
            except ValueError:
                pass
    # non-serialized attribute (bypasses Config.__setattr__, which routes
    # into the dict and would leak the key into saved config.yaml files):
    # which keys the user actually typed on the command line
    object.__setattr__(conf_args, "cli_overrides",
                       [k for k in cli_keys if k != "config"])
    return conf_args
