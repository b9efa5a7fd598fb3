"""Weights across the two packages, and the port's checkpoint file.

:func:`state_dict_from_flax` maps a Flax variable tree of
``PointNet2StrokeMasks``, or of a regressor built like it
(``PointNet2Regressor``, ``PointNet2SoPs``, ``PointNet2StrokeWise``: the
flagship's paths or a subset of them, with their own outputs), or of
``MLPRegressor`` or ``PointTransformer`` (``{"params": ...,
"batch_stats": ...}`` as nested dicts of numpy arrays), onto the port's
``state_dict``. Flax module paths
map to the original PyTorch repo's names:

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
- the start-of-path and stroke-wise regressors' own outputs:
  ``sop_conf_out``, ``point_conf_out``, ``stroke_conf_out``, by name

and the other ported models' trees:

- ``MLPRegressor``: ``Dense_{j}``, ``BatchNorm_{j}`` -> ``fcs.{j}``,
  ``bns.{j}``; ``output_trasl``, ``output_normals``, ``out_confidence``
  by name
- ``PointTransformer``: ``{encoder,decoder}_layers_{i}`` ->
  ``{encoder,decoder}_layers.{i}``, inside which
  ``MultiHeadDotProductAttention_{0,1}/{query,key,value,out}`` ->
  ``{self,cross}_attn.{query,key,value,out}``, ``Dense_{k}`` -> ``ff.{k}``,
  ``LayerNorm_{k}`` -> ``norms.{k}``; the embeddings and the two output
  layers by name. The attention's kernels are Flax's ``DenseGeneral``
  ones, (d, heads, head_dim) for query, key and value and (heads,
  head_dim, d) for out, flattened to the Linear layers' (d, d).

and the trees of this slice's models, told apart by their module names
(the original repository's on the port's side):

- PointNet (``feat`` at the root): ``feat/{stn,fstn}/_ConvBNStack_0/
  {Dense,BatchNorm}_{j}`` -> ``feat.{stn,fstn}.conv{j+1}``, ``bn{j+1}``;
  ``_ConvBNStack_1/{Dense,BatchNorm}_{j}`` -> ``fc{j+1}``, ``bn{j+4}``;
  their ``Dense_0`` -> ``fc3``; ``feat/mlp1`` -> ``feat.conv1``,
  ``feat.bn1``; ``feat/mlp2/{Dense,BatchNorm}_{j}`` -> ``feat.conv{j+2}``,
  ``feat.bn{j+2}``; ``feat/conv3``, ``feat/bn3`` -> the last conv
  (``feat.conv3``, or ``feat.conv5`` in the deeper extractor). The
  regressor's ``Dense_{0,1,2}``, ``BatchNorm_{0,1}`` -> ``fc{1,2,3}``,
  ``bn{1,2}``; the segmenter's ``_ConvBNStack_0/{Dense,BatchNorm}_{j}`` ->
  ``conv{j+1}``, ``bn{j+1}`` and ``Dense_0`` -> ``conv4``
- ``PointNetSegmenterConv1d`` (four bare Dense): ``Dense_{j}`` ->
  ``conv{j+1}``
- the PointNet++ segmenters (``sa1`` at the root):
  ``sa{i}/PointMLP_0/...`` -> ``sa{i}.mlp_convs``/``mlp_bns``;
  ``PointMLP_0/{Dense,BatchNorm}_{j}`` -> ``conv{j+1}``, ``bn{j+1}``;
  ``Dense_0`` -> ``conv4``; ``conv4_trasl``, ``conv4_orient`` by name
- DGCNN (``_EdgeConv_0`` at the root): ``_EdgeConv_{i}/{Dense,BatchNorm}_0``
  -> ``conv{i+1}``, ``bn{i+1}``; ``Dense_{0,1,2,3}`` -> ``conv5``,
  ``linear1``, ``linear2``, ``linear3``; ``BatchNorm_{0,1,2}`` -> ``bn5``,
  ``bn6``, ``bn7``
- ``MLP`` as ``MLPRegressor``'s hidden layers (``fcs.{j}``, ``bns.{j}``,
  its output the last of ``fcs``); ``MLPGenerator``'s ``MLP_0/...`` ->
  ``mlp.fcs``, ``mlp.bns``
- ``SetAbstractionMsg`` (no model builds it; its own tree):
  ``mlp_{i}/{Dense,BatchNorm,LayerNorm}_{j}`` -> ``mlps.{i}.mlp_convs.{j}``,
  ``mlp_bns.{j}``, ``mlp_lns.{j}``

Dense kernels (in, out) are transposed to (out, in). BatchNorm ``mean`` /
``var`` are copied as they are (eval reads only them).
:func:`flax_tree_from_state_dict` maps back (numpy out), for a ``state_dict``
or a dict of gradients by parameter name; the attention's kernels go back
to ``models.point_transformer.ATTENTION_HEADS`` heads, the count
``get_model`` builds.

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

from .models.point_transformer import ATTENTION_HEADS

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
# the modules that keep their Flax name
_SAME_NAME = ("sop_conf_out", "point_conf_out", "stroke_conf_out",
              "output_trasl", "output_normals", "out_confidence",
              "segments_embedding", "points_embedding", "output_layer",
              "eos_layer")
_HEAD_MODULES.update({(name,): name for name in _SAME_NAME})
_ENCODER_MODULE = re.compile(
    r"encoder/(sa\d)/PointMLP_0/(Dense|BatchNorm|LayerNorm)_(\d+)$")
_ENCODER_LISTS = {"Dense": "mlp_convs", "BatchNorm": "mlp_bns",
                  "LayerNorm": "mlp_lns"}
_MSG_MODULE = re.compile(r"mlp_(\d+)/(Dense|BatchNorm|LayerNorm)_(\d+)$")
_MLP_MODULE = re.compile(r"(Dense|BatchNorm)_(\d+)$")
_MLP_LISTS = {"Dense": "fcs", "BatchNorm": "bns"}
_LAYER_MODULE = re.compile(
    r"(encoder|decoder)_layers_(\d+)/(?:MultiHeadDotProductAttention_(\d)/"
    r"(query|key|value|out)|(Dense|LayerNorm)_(\d))$")
_ATTENTIONS = ("self_attn", "cross_attn")
_LAYER_LISTS = {"Dense": "ff", "LayerNorm": "norms"}
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}


def _torch_module(path: tuple[str, ...]) -> str:
    flat = "/".join(path)
    m = _ENCODER_MODULE.match(flat)
    if m:
        sa, kind, j = m.groups()
        return f"{sa}.{_ENCODER_LISTS[kind]}.{j}"
    m = _MSG_MODULE.match(flat)
    if m:
        i, kind, j = m.groups()
        return f"mlps.{i}.{_ENCODER_LISTS[kind]}.{j}"
    m = _MLP_MODULE.match(flat)
    if m:
        kind, j = m.groups()
        return f"{_MLP_LISTS[kind]}.{j}"
    m = _LAYER_MODULE.match(flat)
    if m:
        part, i, attn, proj, kind, k = m.groups()
        inner = (f"{_ATTENTIONS[int(attn)]}.{proj}" if proj
                 else f"{_LAYER_LISTS[kind]}.{k}")
        return f"{part}_layers.{i}.{inner}"
    try:
        return _HEAD_MODULES[path]
    except KeyError:
        raise KeyError(f"no port module for Flax path {flat}") from None


def _flat_kernel(arr: np.ndarray, out_projection: bool) -> np.ndarray:
    """A Dense kernel (in, out) -> the Linear weight (out, in); an
    attention's (d, heads, head_dim) or, for its output projection,
    (heads, head_dim, d) is flattened to (d, d) first."""
    if arr.ndim == 3:
        arr = (arr.reshape(-1, arr.shape[-1]) if out_projection
               else arr.reshape(arr.shape[0], -1))
    return arr.T


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _pointnet_table(deeper: bool) -> dict:
    """PointNet's feature extractor: Flax path -> port module."""
    t = {("feat", "mlp1", "Dense_0"): "feat.conv1",
         ("feat", "mlp1", "BatchNorm_0"): "feat.bn1"}
    for stn in ("stn", "fstn"):
        for j in range(3):
            t[("feat", stn, "_ConvBNStack_0", f"Dense_{j}")] = \
                f"feat.{stn}.conv{j + 1}"
            t[("feat", stn, "_ConvBNStack_0", f"BatchNorm_{j}")] = \
                f"feat.{stn}.bn{j + 1}"
        for j in range(2):
            t[("feat", stn, "_ConvBNStack_1", f"Dense_{j}")] = \
                f"feat.{stn}.fc{j + 1}"
            t[("feat", stn, "_ConvBNStack_1", f"BatchNorm_{j}")] = \
                f"feat.{stn}.bn{j + 4}"
        t[("feat", stn, "Dense_0")] = f"feat.{stn}.fc3"
    mid = 3 if deeper else 1
    for j in range(mid):
        t[("feat", "mlp2", f"Dense_{j}")] = f"feat.conv{j + 2}"
        t[("feat", "mlp2", f"BatchNorm_{j}")] = f"feat.bn{j + 2}"
    t[("feat", "conv3")] = f"feat.conv{mid + 2}"
    t[("feat", "bn3")] = f"feat.bn{mid + 2}"
    return t


def _zoo_table(family: str, deeper: bool = False) -> dict:
    """Flax module path -> port module, for one family of the PointNet,
    segmenter and critic models."""
    t = {}
    if family == "pointnet_regressor":
        t.update(_pointnet_table(deeper))
        t.update({("Dense_0",): "fc1", ("BatchNorm_0",): "bn1",
                  ("Dense_1",): "fc2", ("BatchNorm_1",): "bn2",
                  ("Dense_2",): "fc3"})
    elif family == "pointnet_segmenter":
        t.update(_pointnet_table(deeper))
        for j in range(3):
            t[("_ConvBNStack_0", f"Dense_{j}")] = f"conv{j + 1}"
            t[("_ConvBNStack_0", f"BatchNorm_{j}")] = f"bn{j + 1}"
        t[("Dense_0",)] = "conv4"
    elif family == "pointnet_conv1d":
        t.update({(f"Dense_{j}",): f"conv{j + 1}" for j in range(4)})
    elif family == "pointnet2_segmenter":
        for i in (1, 2, 3):
            for j in range(3):
                for kind, torch_list in (("Dense", "mlp_convs"),
                                         ("BatchNorm", "mlp_bns")):
                    t[(f"sa{i}", "PointMLP_0", f"{kind}_{j}")] = \
                        f"sa{i}.{torch_list}.{j}"
        for j in range(3):
            t[("PointMLP_0", f"Dense_{j}")] = f"conv{j + 1}"
            t[("PointMLP_0", f"BatchNorm_{j}")] = f"bn{j + 1}"
        t.update({("Dense_0",): "conv4", ("conv4_trasl",): "conv4_trasl",
                  ("conv4_orient",): "conv4_orient"})
    elif family == "dgcnn":
        for i in range(4):
            t[(f"_EdgeConv_{i}", "Dense_0")] = f"conv{i + 1}"
            t[(f"_EdgeConv_{i}", "BatchNorm_0")] = f"bn{i + 1}"
        t.update({("Dense_0",): "conv5", ("BatchNorm_0",): "bn5",
                  ("Dense_1",): "linear1", ("BatchNorm_1",): "bn6",
                  ("Dense_2",): "linear2", ("BatchNorm_2",): "bn7",
                  ("Dense_3",): "linear3"})
    return t


def _flax_family(params: dict) -> tuple[str | None, bool]:
    """A Flax ``params`` tree -> (its zoo family or None, deeper)."""
    if "feat" in params:
        deeper = "Dense_2" in params["feat"].get("mlp2", {})
        return ("pointnet_regressor" if "Dense_2" in params
                else "pointnet_segmenter"), deeper
    if "_EdgeConv_0" in params:
        return "dgcnn", False
    if "sa1" in params:
        return "pointnet2_segmenter", False
    if "MLP_0" in params:
        return "mlp_generator", False
    if set(params) == {f"Dense_{j}" for j in range(4)}:
        return "pointnet_conv1d", False
    return None, False


def _torch_family(names) -> tuple[str | None, bool]:
    """The names of a port ``state_dict`` -> (its zoo family or None,
    deeper)."""
    modules = {n.rsplit(".", 1)[0] for n in names}
    if any(m.startswith("feat.") for m in modules):
        return ("pointnet_regressor" if "fc1" in modules
                else "pointnet_segmenter"), "feat.conv5" in modules
    if "linear1" in modules:
        return "dgcnn", False
    if "sa1.mlp_convs.0" in modules and ("conv4" in modules
                                         or "conv4_trasl" in modules):
        return "pointnet2_segmenter", False
    if any(m.startswith("mlp.") for m in modules):
        return "mlp_generator", False
    if "conv1" in modules:
        return "pointnet_conv1d", False
    return None, False


def state_dict_from_flax(variables) -> dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` numpy tree -> port ``state_dict``."""
    family, deeper = _flax_family(variables.get("params", {}))
    table = _zoo_table(family, deeper)

    def module_of(path):
        if family == "mlp_generator":
            return "mlp." + _torch_module(path[1:])
        return table[path] if table else _torch_module(path)

    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _leaves(variables.get(collection, {})):
            name = f"{module_of(path[:-1])}.{_LEAVES[path[-1]]}"
            arr = np.asarray(value, dtype=np.float32)
            if path[-1] == "kernel":
                arr = _flat_kernel(arr, path[-2] == "out")
            elif arr.ndim == 2:                 # an attention's bias
                arr = arr.reshape(-1)
            sd[name] = torch.tensor(arr)
            if path[-1] == "mean":
                sd[name.replace("running_mean", "num_batches_tracked")] = \
                    torch.tensor(0, dtype=torch.long)
    return sd


_FLAX_HEAD_PATHS = {v: k for k, v in _HEAD_MODULES.items()}
_FLAX_ENCODER_LISTS = {v: k for k, v in _ENCODER_LISTS.items()}
_TORCH_MODULE = re.compile(r"(sa\d)\.(mlp_convs|mlp_bns|mlp_lns)\.(\d+)$")
_FLAX_MLP_LISTS = {v: k for k, v in _MLP_LISTS.items()}
_TORCH_MSG_MODULE = re.compile(
    r"mlps\.(\d+)\.(mlp_convs|mlp_bns|mlp_lns)\.(\d+)$")
_TORCH_MLP_MODULE = re.compile(r"(fcs|bns)\.(\d+)$")
_FLAX_LAYER_LISTS = {v: k for k, v in _LAYER_LISTS.items()}
_TORCH_LAYER_MODULE = re.compile(
    r"(encoder|decoder)_layers\.(\d+)\.(?:(self_attn|cross_attn)\."
    r"(query|key|value|out)|(ff|norms)\.(\d))$")


def _flax_path(module: str) -> tuple[str, ...]:
    m = _TORCH_MODULE.match(module)
    if m:
        sa, kind, j = m.groups()
        return ("encoder", sa, "PointMLP_0",
                f"{_FLAX_ENCODER_LISTS[kind]}_{j}")
    m = _TORCH_MSG_MODULE.match(module)
    if m:
        i, kind, j = m.groups()
        return (f"mlp_{i}", f"{_FLAX_ENCODER_LISTS[kind]}_{j}")
    m = _TORCH_MLP_MODULE.match(module)
    if m:
        kind, j = m.groups()
        return (f"{_FLAX_MLP_LISTS[kind]}_{j}",)
    m = _TORCH_LAYER_MODULE.match(module)
    if m:
        part, i, attn, proj, kind, k = m.groups()
        inner = ((f"MultiHeadDotProductAttention_{_ATTENTIONS.index(attn)}",
                  proj) if proj else (f"{_FLAX_LAYER_LISTS[kind]}_{k}",))
        return (f"{part}_layers_{i}", *inner)
    try:
        return _FLAX_HEAD_PATHS[module]
    except KeyError:
        raise KeyError(f"no Flax path for port module {module}") from None


def flax_tree_from_state_dict(state) -> dict:
    """Port ``state_dict`` (or gradients by parameter name) -> Flax
    ``{"params": ..., "batch_stats": ...}`` nested dicts of numpy arrays;
    ``num_batches_tracked`` has no counterpart and is dropped."""
    family, deeper = _torch_family(state)
    table = {v: k for k, v in _zoo_table(family, deeper).items()}

    def path_of(module):
        if family == "mlp_generator":
            return ("MLP_0", *_flax_path(module[len("mlp."):]))
        return table[module] if table else _flax_path(module)

    tree: dict = {}
    for name, value in state.items():
        module, leaf = name.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path = path_of(module)
        arr = value.detach().cpu().numpy().astype(np.float32)
        attention = path[-1] in ("query", "key", "value", "out")
        if leaf == "weight":
            # PointNet's feat/bn3 is a BatchNorm too
            dense = not path[-1].startswith(("BatchNorm", "LayerNorm", "bn"))
            flax_leaf = "kernel" if dense else "scale"
            if dense:
                arr = arr.T
            if attention:
                d = arr.shape[0]
                arr = (arr.reshape(ATTENTION_HEADS, -1, d)
                       if path[-1] == "out"
                       else arr.reshape(d, ATTENTION_HEADS, -1))
        elif leaf == "bias" and attention and path[-1] != "out":
            flax_leaf = "bias"
            arr = arr.reshape(ATTENTION_HEADS, -1)
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


def aux_name(name: str) -> str:
    """The file beside checkpoint ``name`` that holds the critic's state."""
    return f"{name}_aux"


def save_aux_state(run_dir: str, name: str, critic) -> str:
    """Write the critic's state (``losses.gan.CriticState``: its weights,
    BatchNorm statistics and Adam) beside checkpoint ``name``, as
    ``<run_dir>/<name>_aux.torch.pt`` (``maskplanner_tpu/train/
    checkpoints.py::save_aux_state``)."""
    path = checkpoint_path(run_dir, aux_name(name))
    torch.save(critic.state_dict(), path)
    return path


def load_aux_state(run_dir: str, name: str, critic) -> bool:
    """Restore the critic's state saved beside checkpoint ``name`` into
    ``critic`` -> whether there was one; without the file the critic stays
    as it is (a fresh critic), as the JAX loader does."""
    path = checkpoint_path(run_dir, aux_name(name))
    if not os.path.isfile(path):
        return False
    critic.load_state_dict(torch.load(path, map_location="cpu",
                                      weights_only=True))
    return True
