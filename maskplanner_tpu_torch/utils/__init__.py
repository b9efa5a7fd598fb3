"""Seeding, run naming and directories for the training entry point
(``maskplanner_tpu/utils/__init__.py``: ``set_seed``, ``get_run_name``,
``create_dirs``).
"""
from __future__ import annotations

import datetime
import os
import random
import string

import numpy as np
import torch


def set_seed(seed: int | None) -> int:
    """Seed python, numpy and torch; returns the seed used. ``None`` or 0
    draws a fresh one (as the JAX package does)."""
    if seed is None or seed == 0:
        seed = int.from_bytes(os.urandom(4), "little")
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return int(seed)


def random_run_id(n: int = 6) -> str:
    return "".join(random.choices(string.ascii_uppercase + string.digits, k=n))


def get_run_name(config, default_name: str | None = None) -> str:
    """Run-dir naming: <timestamp>_<name-or-group>_<random-id>."""
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    base = default_name or config.get("name") or config.get("auto_wandb_group") or "run"
    return f"{stamp}_{base}_{random_run_id()}"


def create_dirs(path: str):
    os.makedirs(path, exist_ok=True)
    return path
