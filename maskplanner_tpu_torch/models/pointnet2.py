"""PointNet++ (SSG) building blocks (``maskplanner_tpu/models/pointnet2.py``).

Channel-last like the JAX package: xyz (B, N, 3), features (B, N, C). The
modules are named as in the original PyTorch repository
(``sa{i}.mlp_convs.{j}``, ``sa{i}.mlp_bns.{j}``), with ``mlp_lns.{j}`` for
the LayerNorm levels it did not have. This slice ports the eval forward.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.fused_sa import LAYER_NORM_EPS, fused_sa_forward
from ..ops.sampling import farthest_point_sample, index_points, \
    query_ball_point

BATCH_NORM_EPS = 1e-5


class PointMLP(nn.Module):
    """Shared per-point MLP: Linear -> norm -> ReLU per layer, over the last
    axis. ``norm``: "batch" (eval BatchNorm from the running statistics),
    "layer" (LayerNorm over channels, eps 1e-6 as in Flax) or "none"."""

    def __init__(self, in_channel: int, channels: Sequence[int], norm: str):
        super().__init__()
        if norm not in ("batch", "layer", "none"):
            raise ValueError(f"unknown norm: {norm!r}")
        self.norm = norm
        widths = [in_channel, *channels]
        self.mlp_convs = nn.ModuleList(
            nn.Linear(ci, co) for ci, co in zip(widths[:-1], widths[1:]))
        if norm == "batch":
            self.mlp_bns = nn.ModuleList(
                nn.BatchNorm1d(c, eps=BATCH_NORM_EPS) for c in channels)
        elif norm == "layer":
            self.mlp_lns = nn.ModuleList(
                nn.LayerNorm(c, eps=LAYER_NORM_EPS) for c in channels)

    def run_mlp(self, x: torch.Tensor) -> torch.Tensor:
        for j, conv in enumerate(self.mlp_convs):
            x = conv(x)
            if self.norm == "batch":
                x = self.mlp_bns[j](x.reshape(-1, x.shape[-1])).reshape(x.shape)
            elif self.norm == "layer":
                x = self.mlp_lns[j](x)
            x = torch.relu(x)
        return x

    forward = run_mlp

    def layer_params(self):
        """Per-layer ``(w (C_out, C_in), b[, gamma, beta])`` for the fused
        level."""
        layers = []
        for j, conv in enumerate(self.mlp_convs):
            layer = (conv.weight, conv.bias)
            if self.norm == "layer":
                layer += (self.mlp_lns[j].weight, self.mlp_lns[j].bias)
            layers.append(layer)
        return tuple(layers)


class SetAbstraction(PointMLP):
    """PointNet++ set-abstraction level, single-scale grouping.

    Grouped ``layer``/``none`` levels run as one fused level
    (``ops.fused_sa.fused_sa_forward``: the CUDA kernel on the card). The
    ``group_all`` level, and a grouped ``batch`` level, run as plain ops."""

    def __init__(self, npoint: int | None, radius: float | None,
                 nsample: int | None, in_channel: int,
                 mlp: Sequence[int], group_all: bool, norm: str):
        super().__init__(in_channel, mlp, norm)
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None):
        if self.training:
            raise NotImplementedError(
                "only the eval forward is ported: call model.eval()")
        if self.group_all:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
            grouped = xyz[:, None]                              # (B, 1, N, 3)
            if features is not None:
                grouped = torch.cat([grouped, features[:, None]], dim=-1)
            return new_xyz, self.run_mlp(grouped).amax(dim=2)
        fps_idx = farthest_point_sample(xyz, self.npoint)
        new_xyz = index_points(xyz, fps_idx)                    # (B, S, 3)
        if self.norm in ("layer", "none"):
            pooled, _ = fused_sa_forward(
                self.radius, self.nsample, self.norm, xyz, new_xyz, features,
                self.layer_params())
            return new_xyz, pooled
        idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
        grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
        if features is not None:
            grouped = torch.cat([grouped, index_points(features, idx)], dim=-1)
        return new_xyz, self.run_mlp(grouped).amax(dim=2)


def level_norms(norm: str) -> list[str]:
    """``"batch"`` or a per-level spec ``"a+b+c"`` -> the three levels'
    norms."""
    norms = norm.split("+")
    if len(norms) == 1:
        norms = norms * 3
    if len(norms) != 3:
        raise ValueError(f"per-level norm spec needs 3 entries: {norm!r}")
    return norms


class PointNet2Encoder(nn.Module):
    """sa1 -> sa2 -> sa3 (group_all) -> (B, 1024) global feature."""

    def __init__(self, norm: str = "batch"):
        super().__init__()
        n1, n2, n3 = level_norms(norm)
        self.sa1 = SetAbstraction(512, 0.2, 32, 3, (64, 64, 128), False, n1)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128 + 3, (128, 128, 256),
                                  False, n2)
        self.sa3 = SetAbstraction(None, None, None, 256 + 3, (256, 512, 1024),
                                  True, n3)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        l1_xyz, l1_f = self.sa1(xyz, None)
        l2_xyz, l2_f = self.sa2(l1_xyz, l1_f)
        _, l3_f = self.sa3(l2_xyz, l2_f)
        return l3_f[:, 0, :]


def regression_head(x: torch.Tensor, layers) -> torch.Tensor:
    """The fc -> BatchNorm -> ReLU (-> dropout, a no-op in eval) trunk of
    every regressor head; ``layers`` is ``[(linear, batchnorm or None)]``.
    A function, so that the layers keep the original repo's names on the
    model (``fc1``, ``bn1``, ``sm_fc1``, ...)."""
    for linear, bn in layers:
        x = linear(x)
        if bn is not None:
            x = bn(x)
        x = torch.relu(x)
    return x


def assemble_pose_output(positions: torch.Tensor, normals: torch.Tensor,
                         out_vectors: int,
                         weight_orient: float) -> torch.Tensor:
    """(B, V·λ·3) positions and raw orientations -> (B, V, λ·6) segments of
    [x, y, z, nx, ny, nz] poses with unit orientations scaled by
    ``weight_orient``."""
    B = positions.shape[0]
    p = positions.reshape(B, -1, 3)
    n = torch.tanh(normals).reshape(B, -1, 3)
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    n = n * weight_orient
    return torch.cat([p, n], dim=-1).reshape(B, out_vectors, -1)
