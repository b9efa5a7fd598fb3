"""Model factory and IO sizes (``maskplanner_tpu/models/__init__.py``).

Every backbone the JAX factory builds: the MaskPlanner backbone
(``pointnet2_strokemasks``), the baselines' plain regressor
(``pointnet2``), the start-of-path and stroke-wise regressors
(``pointnet2_sops``, ``pointnet2_3dbbox``, ``pointnet2_strokewise``), the
rollout head (``mlp_rollout``), the transformer baseline
(``point_transformer``), PointNet (``pointnet``, ``pointnet_deeper``), the
segmenters (``pointnet_segmenter``, ``pointnet_segmenter_conv1d``,
``pointnet2_segmenter_v1``, ``pointnet2_segmenter_paintnet_v1``), the
random-noise generator (``mlp_generator``) and the DGCNN critic
(``dgcnn``). ``samplenet``, ``gnn`` and ``transformer`` raise
``NotImplementedError`` there and here: the original repository never
released them.

The JAX modules size their first layer from the first input; a port
module is built with its input width. The segmenters take λ-segments
(``io_type="ContrastiveClustering"``: outdim · λ values) or, under any
other ``io_type``, what the training driver feeds every model, the point
cloud (3 values).
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from ..data.pointcloud import get_dim_orient_traj_points, get_dim_traj_points
from .dgcnn import DGCNNDiscriminator
from .maskplanner import (MaskPlannerOutput, PointNet2Regressor,
                          PointNet2SoPs, PointNet2StrokeMasks,
                          PointNet2StrokeWise)
from .mlp import MLP, MLPGenerator, MLPRegressor
from .point_transformer import PointTransformer
from .pointnet import (PointNetRegressor, PointNetSegmenter,
                       PointNetSegmenterConv1d)
from .pointnet2_seg import PointNet2Segmenter, PointNet2SegmenterPaintNet

__all__ = ["DGCNNDiscriminator", "MLP", "MLPGenerator", "MLPRegressor",
           "MaskPlannerOutput", "PointNet2Regressor", "PointNet2Segmenter",
           "PointNet2SegmenterPaintNet", "PointNet2SoPs",
           "PointNet2StrokeMasks", "PointNet2StrokeWise",
           "PointNetRegressor", "PointNetSegmenter",
           "PointNetSegmenterConv1d", "PointTransformer",
           "compute_out_vectors", "get_io_info", "get_model",
           "init_parameters"]

# the models whose output is a ``MaskPlannerOutput`` of stroke masks
STROKE_MASK_BACKBONES = ("pointnet2_strokemasks",
                         "pointnet2_strokemasks_retrocompatible")
PORTED_BACKBONES = (*STROKE_MASK_BACKBONES, "pointnet2",
                    "pointnet2_sops", "pointnet2_strokewise",
                    "pointnet2_3dbbox", "mlp_rollout", "point_transformer",
                    "pointnet", "pointnet_deeper", "pointnet_segmenter",
                    "pointnet_segmenter_conv1d", "pointnet2_segmenter_v1",
                    "pointnet2_segmenter_paintnet_v1", "mlp_generator",
                    "dgcnn")
# named by the original repository, never released there
UNRELEASED_BACKBONES = ("samplenet", "gnn", "transformer")


def compute_out_vectors(config) -> int:
    """Number of predicted segments: ``(n_points − λ) // (λ − overlap) + 1``
    (449 for the flagship's 1350 points at λ=4)."""
    lam = config["lambda_points"]
    overlap = config["overlapping"]
    if config.get("traj_with_equally_spaced_points"):
        n_points = config["n_pred_traj_points"]
        if n_points is None:
            raise ValueError("n_pred_traj_points must be set")
    else:
        n_points = config["traj_points"]
    if lam == 1:
        return n_points
    return (n_points - lam) // (lam - overlap) + 1


def get_io_info(io_type: str, config) -> dict[str, Any]:
    """Input/output sizes by task: ``paintnet``, ``MaskPlanner`` (with the
    stroke masks), ``StrokeWise``, ``multipathregression``,
    ``ODv1_strokeProposal`` (start-of-path tokens) and
    ``ODv1_strokeRollout`` (the rollout head, by ``rollout_loss``) and
    ``ContrastiveClustering`` (the segmenters' λ-segments)."""
    outdim = get_dim_traj_points(config["extra_data"])
    orient_outdim = get_dim_orient_traj_points(config["extra_data"])
    lam = config["lambda_points"]

    if io_type in ("paintnet", "MaskPlanner"):
        info = {
            "inputdim": 3,
            "outdim": outdim,
            "orient_outdim": orient_outdim,
            "vector_outdim_transl": (outdim - orient_outdim) * lam,
            "vector_outdim_orient": orient_outdim * lam,
            "out_vectors": compute_out_vectors(config),
        }
        if io_type == "MaskPlanner":
            info["n_stroke_masks"] = config["max_n_strokes"]
        return info

    if io_type in ("StrokeWise", "multipathregression"):
        points, vectors = (("max_n_stroke_points", "max_n_strokes")
                           if io_type == "StrokeWise"
                           else ("stroke_points", "n_strokes"))
        return {
            "inputdim": 3,
            "outdim": outdim,
            "orient_outdim": orient_outdim,
            "vector_outdim_transl": (outdim - orient_outdim)
            * config[points],
            "vector_outdim_orient": orient_outdim * config[points],
            "out_vectors": config[vectors],
        }

    if io_type == "ODv1_strokeProposal":
        tok = int(config.get("start_of_path_token_length", 1))
        return {
            "vector_outdim_transl": (outdim - orient_outdim) * tok,
            "vector_outdim_orient": orient_outdim * tok,
        }

    if io_type == "ODv1_strokeRollout":
        input_size = int(config["stroke_prototype_dim"])
        if config.select("rollout_model.object_features"):
            input_size += 1024
        rollout_loss = config.get("rollout_loss") or []
        eop = False
        if "mse_strokes" in rollout_loss:
            out_vectors = config["stroke_points"]
        elif "chamfer_strokes" in rollout_loss:
            out_vectors = config["out_segments_per_stroke"]
        elif "masked_mse_strokes" in rollout_loss:
            out_vectors = config["out_points_per_stroke"]
            eop = True
        elif "masked_mse_strokes_from_segments" in rollout_loss:
            out_vectors = config["out_points_per_stroke"]
        elif "mse_nexttoken" in rollout_loss:
            out_vectors = 1
            input_size += (config["substroke_points"] - 1) * outdim * lam
        elif "mse_nexttoken_v2" in rollout_loss:
            out_vectors = 1
            input_size += config["substroke_points"] * outdim * lam
            eop = bool(config.get("end_of_path_confidence"))
        else:
            raise ValueError(f"unsupported rollout_loss: {rollout_loss}")
        return {
            "input_size": input_size,
            "outdim_trasl": (outdim - orient_outdim) * lam,
            "outdim_orient": orient_outdim * lam,
            "out_vectors": out_vectors,
            "outdim": outdim,
            "end_of_path_confidence": eop,
        }

    if io_type == "ContrastiveClustering":
        return {"inputdim": outdim * lam}
    raise ValueError(f"unknown io_type: {io_type}")


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default init, drawn from ``generator``: Linear weights and
    biases uniform in ±1/sqrt(fan_in), norms at weight 1 and bias 0. A
    Linear layer marked ``zero_init`` (the PointNet transform nets' last
    layer, zero-initialised in the JAX package) starts at 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
                if getattr(m, "zero_init", False):
                    m.weight.zero_()
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm1d, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
                if isinstance(m, nn.BatchNorm1d):
                    m.reset_running_stats()


def get_model(config, *, device: str | torch.device,
              generator: torch.Generator | None = None,
              dropout: float = 0.3, which: str | None = None,
              io_type: str = "MaskPlanner") -> nn.Module:
    """Build the backbone named by ``which`` (default
    ``config.model.backbone``) in eval mode on ``device``, its weights
    drawn from ``generator`` (default: seeded from ``config.seed``).
    ``dropout``: the regressor heads' rate in train mode. Under
    ``model.bf16`` the MaskPlanner and the plain regressor compute in
    bf16, in train and in eval (the parameters stay f32); the others
    ignore it, as in the JAX package: the start-of-path and stroke-wise
    regressors take ``model.norm`` and stay f32, ``pointnet2_3dbbox`` has
    a BatchNorm encoder whatever ``model.norm`` says, and so have the
    PointNet++ segmenters. ``io_type``: the inputs of ``pointnet``,
    ``pointnet_deeper``, ``mlp_generator`` and the segmenters (the module's
    docstring). It asserts and raises where the JAX factory does: PointNet
    and the generator without orientations, the segmenters with
    ``latent_dim`` (no shipped default)."""
    which = which or config["model"]["backbone"]
    if which == "pointnet2_strokemasks_retrocompatible":
        which = "pointnet2_strokemasks"   # differs only in a layer name
    if which in UNRELEASED_BACKBONES:
        raise NotImplementedError(
            f"backbone {which!r} is unreleased in the original repository "
            "and has no behavior to match")
    if which not in PORTED_BACKBONES:
        raise ValueError(f"unknown backbone: {which}")
    outdim = get_dim_traj_points(config["extra_data"])
    orient_outdim = get_dim_orient_traj_points(config["extra_data"])
    hidden = tuple(config["model"].get("hidden_size", (1024, 1024)))
    norm = config["model"].get("norm") or "batch"
    poses = dict(outdim=outdim - orient_outdim, outdim_orient=orient_outdim,
                 weight_orient=config["weight_orient"])
    if which in ("pointnet2_strokemasks", "pointnet2"):
        info = get_io_info("MaskPlanner" if which == "pointnet2_strokemasks"
                           else "paintnet", config)
        common = dict(
            **poses, out_vectors=info["out_vectors"],
            lambda_points=config["lambda_points"], hidden_size=hidden,
            encoder_norm=norm, dropout=dropout,
            dtype=torch.bfloat16 if config["model"].get("bf16")
            else torch.float32)
        if which == "pointnet2":
            model = PointNet2Regressor(**common)
        else:
            model = PointNet2StrokeMasks(
                **common, n_stroke_masks=info["n_stroke_masks"],
                segment_confidence_scores=bool(
                    config.get("per_segment_confidence")))
    elif which == "pointnet2_sops":
        model = PointNet2SoPs(
            config["out_prototypes"], **poses,
            token_length=config.get("start_of_path_token_length", 1),
            hidden_size=hidden, sop_confidence_scores=bool(
                config.get("sop_confidence_scores")),
            encoder_norm=norm, dropout=dropout)
    elif which == "pointnet2_strokewise":
        model = PointNet2StrokeWise(
            config["max_n_strokes"], config["max_n_stroke_points"], **poses,
            hidden_size=hidden, encoder_norm=norm, dropout=dropout)
    elif which == "pointnet2_3dbbox":
        model = PointNet2SoPs(config["out_prototypes"], outdim=6,
                              outdim_orient=0, hidden_size=hidden,
                              dropout=dropout)
    elif which == "mlp_rollout":
        info = get_io_info("ODv1_strokeRollout", config)
        model = MLPRegressor(
            info["input_size"], info["out_vectors"], info["outdim_trasl"],
            hidden, outdim_orient=info["outdim_orient"],
            weight_orient=config["weight_orient"],
            confidence_scores=info["end_of_path_confidence"])
    elif which == "point_transformer":
        model = PointTransformer(
            input_dim=outdim * config["lambda_points"],
            outdim=outdim * config["lambda_points"],
            max_seq_len=int(config.get("max_seq_len", 100)),
            weight_orient=config["weight_orient"])
    else:
        model = _zoo_model(which, config, io_type, dropout)
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.get("seed") or 0))
    init_parameters(model, generator)
    return model.to(device).eval()


def _zoo_model(which: str, config, io_type: str,
               dropout: float) -> nn.Module:
    """The PointNet family, the segmenters, the generator and the critic."""
    outdim = get_dim_traj_points(config["extra_data"])
    orient_outdim = get_dim_orient_traj_points(config["extra_data"])
    lam = config["lambda_points"]
    affinetrans = bool(config["model"].get("affinetrans"))
    # the segmenters' inputs: λ-segments, or the driver's point clouds
    inputdim = (get_io_info("ContrastiveClustering", config)["inputdim"]
                if io_type == "ContrastiveClustering" else 3)
    if which in ("pointnet", "pointnet_deeper", "mlp_generator"):
        info = get_io_info("paintnet" if io_type == "MaskPlanner"
                           else io_type, config)
    if which in ("pointnet", "pointnet_deeper"):
        assert orient_outdim == 0, (
            f"{which} backbone does not support output normals")
        return PointNetRegressor(
            info["out_vectors"], info["vector_outdim_transl"],
            affinetrans=affinetrans,
            hidden_size=tuple(config["model"].get("hidden_size",
                                                  (1024, 1024))),
            deeper=which == "pointnet_deeper", dropout=dropout)
    if which == "mlp_generator":
        assert info["vector_outdim_orient"] == 0, (
            "mlp generator does not support output normals")
        return MLPGenerator(int(config.get("random_input_dim") or 32),
                            (512, 1024), info["out_vectors"],
                            info["vector_outdim_transl"])
    if which == "pointnet_segmenter":
        return PointNetSegmenter(config["latent_dim"],
                                 affinetrans=affinetrans, inputdim=inputdim)
    if which == "pointnet_segmenter_conv1d":
        return PointNetSegmenterConv1d(
            config["latent_dim"], lam,
            input_normals_only=bool(config.get("input_normals_only")),
            inputdim=inputdim)
    if which == "pointnet2_segmenter_v1":
        return PointNet2Segmenter(
            inputdim, config["latent_dim"], lam,
            ball_in_xyz_space=bool(config.get("ball_in_xyz_space")))
    if which == "pointnet2_segmenter_paintnet_v1":
        return PointNet2SegmenterPaintNet(
            outdim - orient_outdim, orient_outdim, config["weight_orient"],
            lam)
    return DGCNNDiscriminator(outdim, k=int(config.get("knn_gcn", 20)))
