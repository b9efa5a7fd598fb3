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
or a dict of gradients by parameter name.

Warm starts (``model.pretrained``, ``model.pretrained_custom``):
:func:`load_torch_pretrained` loads a reference ``.pth`` (the original
repository's ShapeNet classifier for the encoder, or a run's
``last_checkpoint.pth`` whole), :func:`load_params_only` the weights and
BatchNorm statistics of a port run's checkpoint. Both copy into the
model's own tensors in place, so that an optimizer or a CUDA graph built
later sees the loaded values in the same storages.
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


# The classifier head of the ShapeNet checkpoint, dropped in an encoder warm
# start (``maskplanner_tpu/train/torch_convert.py::SHAPENET_HEAD_KEYS``)
SHAPENET_HEAD_KEYS = (
    "fc1.weight", "fc1.bias",
    "bn1.weight", "bn1.bias", "bn1.running_mean", "bn1.running_var",
    "bn1.num_batches_tracked",
    "fc2.weight", "fc2.bias",
    "bn2.weight", "bn2.bias", "bn2.running_mean", "bn2.running_var",
    "bn2.num_batches_tracked",
    "fc3.weight", "fc3.bias",
)
# The output layers a non-strict custom warm start leaves at their fresh
# init (``CUSTOM_FILTER_KEYS`` there)
CUSTOM_FILTER_KEYS = ("fc3.weight", "fc3.bias", "fc_normals.weight",
                      "fc_normals.bias")
# The reference's modules in the JAX loader's order: (its name, the port's,
# kind). The encoder's 1x1 convolutions and BatchNorms, then the heads;
# ``out_confidence`` is the retro-compatible twin of ``mask_conf_out``.
_ENCODER_MAP = [(f"sa{i}.{kind}.{j}", f"sa{i}.{kind}.{j}",
                 "conv1x1" if kind == "mlp_convs" else "bn")
                for i in (1, 2, 3) for j in range(3)
                for kind in ("mlp_convs", "mlp_bns")]
_HEAD_MAP = [(name, "mask_conf_out" if name == "out_confidence" else name,
              "bn" if "bn" in name else "linear")
             for name in ("fc1", "bn1", "fc2", "bn2", "fc3", "fc_normals",
                          "sm_fc1", "sm_bn1", "sm_fc2", "sm_bn2", "sm_fc3",
                          "mask_conf_out", "out_confidence", "seg_conf_fc1",
                          "seg_conf_fc2", "seg_conf_out")]


def load_torch_pretrained(model: nn.Module, path: str, mode: str = "full",
                          load_strict: bool = False) -> list[str]:
    """Warm-start ``model`` in place from a reference PyTorch ``.pth`` ->
    the loaded keys, as ``maskplanner_tpu/train/torch_convert.py::
    load_torch_pretrained`` loads them:

    - ``mode="encoder"``: the ShapeNet classifier checkpoint
      (``["model_state_dict"]``), sa1..sa3 only;
    - ``mode="full"``: a reference run's checkpoint (``["model"]``), the
      encoder and the heads; without ``load_strict`` the output layers
      ``fc3`` and ``fc_normals`` keep their fresh init.

    The 1x1 convolution weights (C_out, C_in, 1, 1) are squeezed to the
    Linear layers' (C_out, C_in); a BatchNorm's weight, bias and running
    statistics are copied (``num_batches_tracked`` is not: the Flax-
    semantics BatchNorm does not read it). A module the model lacks (a
    LayerNorm level has no ``mlp_bns``) is skipped; a shape that differs
    raises, and so does a file from which nothing loads."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if mode == "encoder":
        sd = blob.get("model_state_dict", blob)
        mapping, dropped = _ENCODER_MAP, SHAPENET_HEAD_KEYS
    elif mode == "full":
        sd = blob.get("model", blob)
        mapping = _ENCODER_MAP + _HEAD_MAP
        dropped = () if load_strict else CUSTOM_FILTER_KEYS
    else:
        raise ValueError(f"mode must be 'encoder' or 'full', got {mode!r}")
    sd = {k: v for k, v in sd.items() if k not in dropped}
    own = model.state_dict()
    loaded = []

    def put(key: str, target: str, value: torch.Tensor) -> None:
        if value.shape != own[target].shape:
            raise ValueError(f"shape mismatch at {target}: model "
                             f"{tuple(own[target].shape)} vs checkpoint "
                             f"{tuple(value.shape)}")
        own[target].copy_(value.to(own[target].dtype))
        loaded.append(key)

    with torch.no_grad():
        for name, target, kind in mapping:
            if f"{target}.weight" not in own or f"{name}.weight" not in sd:
                continue
            w = sd[f"{name}.weight"]
            if kind == "conv1x1" and w.dim() == 4:
                w = w[:, :, 0, 0]
            put(f"{name}.weight", f"{target}.weight", w)
            if kind != "bn":
                if f"{name}.bias" in sd:
                    put(f"{name}.bias", f"{target}.bias", sd[f"{name}.bias"])
                continue
            put(f"{name}.bias", f"{target}.bias", sd[f"{name}.bias"])
            if f"{name}.running_mean" in sd:
                for stat in ("running_mean", "running_var"):
                    put(f"{name}.{stat}", f"{target}.{stat}",
                        sd[f"{name}.{stat}"])
    if not loaded:
        raise ValueError(f"no convertible weights found in {path}")
    return loaded


def load_shapenet_encoder(model: nn.Module, path: str) -> list[str]:
    """Warm-start sa1..sa3 of a BatchNorm encoder from the original
    repository's ShapeNet classifier checkpoint (``pointnet2_cls_ssg.pth``)
    -> the loaded keys (:func:`load_torch_pretrained` in its encoder
    mode)."""
    return load_torch_pretrained(model, path, mode="encoder")


def load_params_only(run_dir: str, name: str, model: nn.Module,
                     filter_heads: bool = False) -> list[str]:
    """Warm-start ``model`` in place from a port run's
    ``<run_dir>/<name>.torch.pt``: its weights and BatchNorm statistics
    only, not Adam, the step or the epoch -> the loaded keys
    (``maskplanner_tpu/train/checkpoints.py::load_params_only``). With
    ``filter_heads`` the output layers ``fc3`` and ``fc_normals`` keep
    their fresh init. The run's model must be this one: a key that differs
    or a shape that differs raises."""
    state = _read_checkpoint(run_dir, name)["model"]
    own = model.state_dict()
    if set(state) != set(own):
        raise ValueError(f"{checkpoint_path(run_dir, name)} holds another "
                         f"model: keys {sorted(set(state) ^ set(own))} differ")
    heads = ("fc3.", "fc_normals.")
    loaded = []
    with torch.no_grad():
        for key, value in state.items():
            if filter_heads and key.startswith(heads):
                continue
            if value.shape != own[key].shape:
                raise ValueError(f"shape mismatch at {key}: model "
                                 f"{tuple(own[key].shape)} vs checkpoint "
                                 f"{tuple(value.shape)}")
            own[key].copy_(value)
            loaded.append(key)
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
                    epoch: int = 0, *, optimizer=None, lr_sched=None,
                    step: int | None = None,
                    generator: torch.Generator | None = None) -> str:
    """Write ``<run_dir>/<name>.torch.pt`` with the model's weights and,
    where given, what a resumed run needs to continue as the uninterrupted
    one would (the JAX checkpoint's ``opt_state`` and ``step``): the Adam
    and LR scheduler ``state_dict``s, the optimizer step count and the
    training generator's state (the FPS starts and dropout masks)."""
    path = checkpoint_path(run_dir, name)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    blob = {"model": state, "epoch": int(epoch)}
    if optimizer is not None:
        blob["optimizer"] = optimizer_state(optimizer)
    if lr_sched is not None:
        blob["lr_sched"] = {k: _floats(v)
                            for k, v in lr_sched.state_dict().items()}
    if step is not None:
        blob["step"] = int(step)
    if generator is not None:
        blob["generator"] = generator.get_state()
    torch.save(blob, path)
    return path


def _floats(value):
    """A 0-d tensor (a tensor LR) -> its float; lists elementwise."""
    if isinstance(value, torch.Tensor) and value.dim() == 0:
        return float(value)
    if isinstance(value, list):
        return [_floats(v) for v in value]
    return value


def optimizer_state(optimizer) -> dict:
    """``optimizer.state_dict()`` in one form whichever the optimizer's
    (``train.make_optimizer``: a float LR on the CPU, a capturable Adam with
    a tensor LR on the card): LRs as floats, ``capturable`` off, the state's
    tensors on the CPU. A checkpoint of either form resumes in either
    (:func:`load_optimizer_state`)."""
    sd = optimizer.state_dict()
    groups = []
    for group in sd["param_groups"]:
        group = {k: _floats(v) for k, v in group.items()}
        if "capturable" in group:
            group["capturable"] = False
        groups.append(group)
    state = {i: {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
                 for k, v in s.items()} for i, s in sd["state"].items()}
    return {"state": state, "param_groups": groups}


def load_optimizer_state(optimizer, state: dict) -> None:
    """Load a state that :func:`optimizer_state` wrote into ``optimizer``,
    keeping the optimizer's form: its ``capturable`` flag, its LR tensor
    (filled with the state's LR in place, so that a CUDA graph that reads
    it sees the value) and, when capturable, the step counts on the
    parameters' device."""
    forms = [(group["lr"], group.get("capturable", False))
             for group in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (lr, capturable) in zip(optimizer.param_groups, forms):
        if "capturable" in group:
            group["capturable"] = capturable
        if isinstance(lr, torch.Tensor):
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(
                    p.device if capturable else "cpu", torch.float32)


def copy_checkpoint(run_dir: str, src: str, dst: str) -> str:
    """Copy ``<run_dir>/<src>.torch.pt`` to ``<run_dir>/<dst>.torch.pt``."""
    path = checkpoint_path(run_dir, dst)
    shutil.copyfile(checkpoint_path(run_dir, src), path)
    return path


def _read_checkpoint(run_dir: str, name: str) -> dict:
    path = checkpoint_path(run_dir, name)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint {path} not found")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(run_dir: str, name: str, model: nn.Module) -> int:
    """Load ``<run_dir>/<name>.torch.pt`` into ``model`` (strict); returns
    the stored epoch. Any checkpoint loads, with or without a training
    state."""
    blob = _read_checkpoint(run_dir, name)
    model.load_state_dict(blob["model"], strict=True)
    return int(blob["epoch"])


def load_training_state(run_dir: str, name: str, model: nn.Module,
                        optimizer, lr_sched,
                        generator: torch.Generator) -> tuple[int, int]:
    """Restore the model, Adam, the LR scheduler (None: the run has none)
    and the training generator from a checkpoint that
    :func:`save_checkpoint` wrote with them -> (epoch, step)."""
    blob = _read_checkpoint(run_dir, name)
    missing = [k for k in ("optimizer", "step", "generator")
               + (("lr_sched",) if lr_sched is not None else ())
               if k not in blob]
    if missing:
        raise ValueError(f"checkpoint {checkpoint_path(run_dir, name)} holds "
                         f"no training state ({missing}): it cannot resume")
    model.load_state_dict(blob["model"], strict=True)
    load_optimizer_state(optimizer, blob["optimizer"])
    if lr_sched is not None:
        lr_sched.load_state_dict(blob["lr_sched"])
    generator.set_state(blob["generator"])
    return int(blob["epoch"]), int(blob["step"])
