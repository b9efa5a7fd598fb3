"""Weights across the two packages, and the port's checkpoint file.

:func:`state_dict_from_flax` maps a Flax variable tree of
``PointNet2StrokeMasks`` (``{"params": ..., "batch_stats": ...}`` as nested
dicts of numpy arrays) onto the port's ``state_dict``. Flax module paths map
to the original PyTorch repo's names:

- ``encoder/sa{i}/PointMLP_0/Dense_{j}`` -> ``sa{i}.mlp_convs.{j}``
- ``encoder/sa{i}/PointMLP_0/BatchNorm_{j}`` -> ``sa{i}.mlp_bns.{j}``
- ``encoder/sa{i}/PointMLP_0/LayerNorm_{j}`` -> ``sa{i}.mlp_lns.{j}``
- ``head/Dense_{0,1}``, ``head/BatchNorm_{0,1}`` -> ``fc{1,2}``, ``bn{1,2}``
- ``fc_out`` -> ``fc3``; ``fc_normals`` -> ``fc_normals``
- ``sm_head/Dense_{0,1}``, ``sm_head/BatchNorm_{0,1}`` -> ``sm_fc{1,2}``,
  ``sm_bn{1,2}``; ``sm_out`` -> ``sm_fc3``; ``mask_conf_out`` ->
  ``mask_conf_out``
- ``seg_conf_head/Dense_{0,1}`` -> ``seg_conf_fc{1,2}``; ``seg_conf_out`` ->
  ``seg_conf_out``

Dense kernels (in, out) are transposed to (out, in). BatchNorm ``mean`` /
``var`` are copied as they are (eval reads only them).
:func:`flax_tree_from_state_dict` maps back (numpy out), for a ``state_dict``
or a dict of gradients by parameter name. :func:`load_shapenet_encoder`
warm-starts the encoder from the original repository's ShapeNet
checkpoint.
"""
from __future__ import annotations

import os
import re
import shutil

import numpy as np
import torch
from torch import nn

_HEAD_MODULES = {
    ("head", "Dense_0"): "fc1", ("head", "BatchNorm_0"): "bn1",
    ("head", "Dense_1"): "fc2", ("head", "BatchNorm_1"): "bn2",
    ("fc_out",): "fc3", ("fc_normals",): "fc_normals",
    ("sm_head", "Dense_0"): "sm_fc1", ("sm_head", "BatchNorm_0"): "sm_bn1",
    ("sm_head", "Dense_1"): "sm_fc2", ("sm_head", "BatchNorm_1"): "sm_bn2",
    ("sm_out",): "sm_fc3", ("mask_conf_out",): "mask_conf_out",
    ("seg_conf_head", "Dense_0"): "seg_conf_fc1",
    ("seg_conf_head", "Dense_1"): "seg_conf_fc2",
    ("seg_conf_out",): "seg_conf_out",
}
_ENCODER_MODULE = re.compile(
    r"encoder/(sa\d)/PointMLP_0/(Dense|BatchNorm|LayerNorm)_(\d+)$")
_ENCODER_LISTS = {"Dense": "mlp_convs", "BatchNorm": "mlp_bns",
                  "LayerNorm": "mlp_lns"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _torch_module(path: tuple[str, ...]) -> str:
    m = _ENCODER_MODULE.match("/".join(path))
    if m:
        sa, kind, j = m.groups()
        return f"{sa}.{_ENCODER_LISTS[kind]}.{j}"
    try:
        return _HEAD_MODULES[path]
    except KeyError:
        raise KeyError(f"no port module for Flax path {'/'.join(path)}") \
            from None


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(variables) -> dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` numpy tree -> port ``state_dict``."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            name = f"{_torch_module(path[:-1])}.{_LEAVES[path[-1]]}"
            arr = np.asarray(value, dtype=np.float32)
            if path[-1] == "kernel":
                arr = arr.T
            sd[name] = torch.tensor(arr)
            if path[-1] == "mean":
                sd[name.replace("running_mean", "num_batches_tracked")] = \
                    torch.tensor(0, dtype=torch.long)
    return sd


_FLAX_HEAD_PATHS = {v: k for k, v in _HEAD_MODULES.items()}
_FLAX_ENCODER_LISTS = {v: k for k, v in _ENCODER_LISTS.items()}
_TORCH_MODULE = re.compile(r"(sa\d)\.(mlp_convs|mlp_bns|mlp_lns)\.(\d+)$")


def _flax_path(module: str) -> tuple[str, ...]:
    m = _TORCH_MODULE.match(module)
    if m:
        sa, kind, j = m.groups()
        return ("encoder", sa, "PointMLP_0",
                f"{_FLAX_ENCODER_LISTS[kind]}_{j}")
    try:
        return _FLAX_HEAD_PATHS[module]
    except KeyError:
        raise KeyError(f"no Flax path for port module {module}") from None


def flax_tree_from_state_dict(state) -> dict:
    """Port ``state_dict`` (or gradients by parameter name) -> Flax
    ``{"params": ..., "batch_stats": ...}`` nested dicts of numpy arrays;
    ``num_batches_tracked`` has no counterpart and is dropped."""
    tree: dict = {}
    for name, value in state.items():
        module, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path = _flax_path(module)
        arr = value.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            dense = not path[-1].startswith(("BatchNorm", "LayerNorm"))
            flax_leaf = "kernel" if dense else "scale"
            if dense:
                arr = arr.T
        else:
            flax_leaf = {"bias": "bias", "running_mean": "mean",
                         "running_var": "var"}[leaf]
        collection = ("batch_stats" if leaf.startswith("running_")
                      else "params")
        node = tree.setdefault(collection, {})
        for key in path:
            node = node.setdefault(key, {})
        node[flax_leaf] = arr
    return tree


# The encoder tensors of the ShapeNet classifier checkpoint: everything
# else (its head, fc1-fc3 and bn1-bn2, and num_batches_tracked) is left out
# (``maskplanner_tpu/train/torch_convert.py::SHAPENET_HEAD_KEYS``).
_ENCODER_KEY = re.compile(
    r"sa[123]\.(mlp_convs|mlp_bns)\.\d+\."
    r"(weight|bias|running_mean|running_var)$")


def load_shapenet_encoder(model: nn.Module, path: str) -> list[str]:
    """Warm-start sa1..sa3 of a BatchNorm encoder from the original
    repository's ShapeNet classifier checkpoint (``pointnet2_cls_ssg.pth``,
    ``{"model_state_dict": ...}``), in place -> the loaded keys.

    The classifier head is dropped; the 1x1 Conv2d weights (C_out, C_in, 1,
    1) are squeezed to the Linear layers' (C_out, C_in); BatchNorm weight,
    bias and running statistics are copied (``num_batches_tracked`` is not:
    the Flax-semantics BatchNorm does not read it). A key the model lacks
    is skipped and a shape that differs raises, as
    ``maskplanner_tpu/train/torch_convert.py::load_torch_pretrained`` does
    in its ``mode="encoder"``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("model_state_dict", blob)
    own = model.state_dict()
    loaded = []
    with torch.no_grad():
        for key, value in sd.items():
            if not _ENCODER_KEY.match(key) or key not in own:
                continue
            if value.dim() == 4:
                value = value[:, :, 0, 0]
            if value.shape != own[key].shape:
                raise ValueError(f"shape mismatch at {key}: model "
                                 f"{tuple(own[key].shape)} vs checkpoint "
                                 f"{tuple(value.shape)}")
            own[key].copy_(value)
            loaded.append(key)
    if not loaded:
        raise ValueError(f"no encoder weights found in {path}")
    return loaded


def checkpoint_name(model: str) -> str:
    """CLI checkpoint selector -> on-disk name: best | last |
    intermediate_epochN (as ``maskplanner_tpu.train.checkpoints``)."""
    if model == "best":
        return "best_model"
    if model == "last":
        return "last_checkpoint"
    if model.startswith("intermediate") and "_" in model:
        return f"intermediate_checkpoint_{model.split('_', 1)[1]}"
    return model


def checkpoint_path(run_dir: str, name: str) -> str:
    return os.path.join(run_dir, f"{name}.torch.pt")


def save_checkpoint(run_dir: str, name: str, model: nn.Module,
                    epoch: int = 0) -> str:
    """Write ``<run_dir>/<name>.torch.pt`` with the model's weights."""
    path = checkpoint_path(run_dir, name)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": state, "epoch": int(epoch)}, path)
    return path


def copy_checkpoint(run_dir: str, src: str, dst: str) -> str:
    """Copy ``<run_dir>/<src>.torch.pt`` to ``<run_dir>/<dst>.torch.pt``."""
    path = checkpoint_path(run_dir, dst)
    shutil.copyfile(checkpoint_path(run_dir, src), path)
    return path


def load_checkpoint(run_dir: str, name: str, model: nn.Module) -> int:
    """Load ``<run_dir>/<name>.torch.pt`` into ``model`` (strict); returns
    the stored epoch."""
    path = checkpoint_path(run_dir, name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(blob["model"], strict=True)
    return int(blob["epoch"])
