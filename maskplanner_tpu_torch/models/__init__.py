"""Model factory and IO sizes (``maskplanner_tpu/models/__init__.py``).

The MaskPlanner backbone (``pointnet2_strokemasks``) and the baselines'
plain regressor (``pointnet2``) are ported; the others are queued in
ROADMAP.md ("Queue 1").
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from ..data.pointcloud import get_dim_orient_traj_points, get_dim_traj_points
from .maskplanner import (MaskPlannerOutput, PointNet2Regressor,
                          PointNet2StrokeMasks)

__all__ = ["MaskPlannerOutput", "PointNet2Regressor", "PointNet2StrokeMasks",
           "compute_out_vectors", "get_io_info", "get_model",
           "init_parameters"]


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
    """Input/output sizes of the MaskPlanner task, and of the ``paintnet``
    task (the same without the stroke masks)."""
    if io_type not in ("paintnet", "MaskPlanner"):
        raise NotImplementedError(
            f"io_type {io_type!r} is not ported yet (ROADMAP.md, Queue 1)")
    outdim = get_dim_traj_points(config["extra_data"])
    orient_outdim = get_dim_orient_traj_points(config["extra_data"])
    lam = config["lambda_points"]
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


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default init, drawn from ``generator``: Linear weights and
    biases uniform in ±1/sqrt(fan_in), norms at weight 1 and bias 0."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, (nn.BatchNorm1d, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.fill_(0.0)
                if isinstance(m, nn.BatchNorm1d):
                    m.reset_running_stats()


def get_model(config, *, device: str | torch.device,
              generator: torch.Generator | None = None,
              dropout: float = 0.3) -> nn.Module:
    """Build the backbone named by ``config.model.backbone`` in eval mode on
    ``device``, its weights drawn from ``generator`` (default: seeded from
    ``config.seed``). ``dropout``: the heads' rate in train mode. Under
    ``model.bf16`` it computes in bf16, in train and in eval (the
    parameters stay f32)."""
    which = config["model"]["backbone"]
    if which == "pointnet2_strokemasks_retrocompatible":
        which = "pointnet2_strokemasks"   # differs only in a layer name
    if which not in ("pointnet2_strokemasks", "pointnet2"):
        raise NotImplementedError(
            f"backbone {which!r} is not ported yet (ROADMAP.md, Queue 1)")
    info = get_io_info("MaskPlanner" if which == "pointnet2_strokemasks"
                       else "paintnet", config)
    common = dict(
        out_vectors=info["out_vectors"],
        outdim=info["outdim"] - info["orient_outdim"],
        outdim_orient=info["orient_outdim"],
        weight_orient=config["weight_orient"],
        lambda_points=config["lambda_points"],
        hidden_size=tuple(config["model"].get("hidden_size", (1024, 1024))),
        encoder_norm=config["model"].get("norm") or "batch",
        dropout=dropout,
        dtype=torch.bfloat16 if config["model"].get("bf16")
        else torch.float32,
    )
    if which == "pointnet2":
        model = PointNet2Regressor(**common)
    else:
        model = PointNet2StrokeMasks(
            **common, n_stroke_masks=info["n_stroke_masks"],
            segment_confidence_scores=bool(
                config.get("per_segment_confidence")))
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.get("seed") or 0))
    init_parameters(model, generator)
    return model.to(device).eval()
