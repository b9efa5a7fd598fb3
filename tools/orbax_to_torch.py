"""Convert a JAX run's orbax checkpoint into the PyTorch port's format.

    python tools/orbax_to_torch.py --run RUN_DIR [--name last_checkpoint]

Rebuilds the JAX train state from the run's frozen ``config.yaml`` (the
JAX package's ``models.get_model`` and ``train/trainer.py::
create_train_state``), restores the weights and BatchNorm statistics of
``RUN_DIR/<name>/`` into it (``train/checkpoints.py::load_params_only``),
maps them onto the port's model (``maskplanner_tpu_torch.convert.
state_dict_from_flax``, loaded strictly into the port's model of the same
config) and writes ``RUN_DIR/<name>.torch.pt`` as
``maskplanner_tpu_torch.convert.save_checkpoint`` does. The port's
``model.pretrained_custom=RUN_DIR`` then warm-starts from that file.

This tool imports both packages (and so JAX); the port itself never does.
It runs on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
from collections.abc import Mapping

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _plain(tree):
    """A (frozen) mapping of arrays -> nested dicts of numpy arrays."""
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def flax_variables(run_dir: str, name: str) -> dict:
    """The run's ``{"params", "batch_stats"}`` restored from
    ``run_dir/name/`` into a train state built from its frozen config."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    from maskplanner_tpu.models import get_model
    from maskplanner_tpu.train import checkpoints
    from maskplanner_tpu.train.trainer import create_train_state
    from maskplanner_tpu.utils.config import load_config

    if not checkpoints.checkpoint_exists(run_dir, name):
        raise FileNotFoundError(f"no orbax checkpoint {name}/ in {run_dir}")
    config = load_config(run_dir)
    sample_pc = np.zeros((1, int(config["pc_points"]), 3), np.float32)
    state = create_train_state(get_model(config), config,
                               jax.random.PRNGKey(0), sample_pc)
    state = checkpoints.load_params_only(run_dir, name, state)
    return {"params": _plain(jax.device_get(state.params)),
            "batch_stats": _plain(jax.device_get(state.batch_stats))}


def convert(run_dir: str, name: str = "last_checkpoint") -> str:
    """Write ``run_dir/<name>.torch.pt`` from ``run_dir/<name>/`` -> its
    path."""
    from maskplanner_tpu_torch.convert import (save_checkpoint,
                                               state_dict_from_flax)
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.config import load_config

    state = state_dict_from_flax(flax_variables(run_dir, name))
    model = get_model(load_config(run_dir), device="cpu")
    model.load_state_dict(state, strict=True)
    return save_checkpoint(run_dir, name, model)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--run", required=True, help="the JAX run's directory")
    p.add_argument("--name", default="last_checkpoint",
                   help="the orbax checkpoint's directory in the run")
    args = p.parse_args(argv)
    path = convert(args.run, args.name)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
