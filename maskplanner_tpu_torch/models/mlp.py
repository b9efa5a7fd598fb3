"""The MLP heads (``maskplanner_tpu/models/mlp.py``): the plain ``MLP``
(the critic of ``discr_input_type=singlestrokes``), the random-noise
generator ``MLPGenerator`` (the ``mlp_generator`` backbone) and the
stroke-rollout head ``MLPRegressor`` (the ``mlp_rollout`` backbone).

Dense -> BatchNorm -> ReLU blocks (the BatchNorm with Flax's train-mode
semantics, :class:`FlaxBatchNorm1d`) named ``fcs.{j}`` and ``bns.{j}``;
the plain MLP's output layer is the last of ``fcs``. The rollout head
then gives the translations, the orientations (tanh, unit length, times
``weight_orient``) and, optionally, a confidence logit per output vector.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .pointnet2 import BATCH_NORM_EPS, FlaxBatchNorm1d


class MLP(nn.Module):
    """(B, input_size) -> (B, output_size): ``fcs.{j}`` -> ``bns.{j}`` ->
    ReLU per hidden size, then the last of ``fcs``."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 output_size: int):
        super().__init__()
        widths = [input_size, *hidden_sizes, output_size]
        self.fcs = nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(widths[:-1], widths[1:]))
        self.bns = nn.ModuleList(FlaxBatchNorm1d(h, eps=BATCH_NORM_EPS)
                                 for h in hidden_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for fc, bn in zip(self.fcs, self.bns):
            x = torch.relu(bn(fc(x)))
        return self.fcs[-1](x)


class MLPGenerator(nn.Module):
    """(B, input_size) noise -> (B, out_vectors, outdim) through ``mlp``
    (:class:`MLP`)."""

    def __init__(self, input_size: int, hidden_sizes: Sequence[int],
                 out_vectors: int, outdim: int = 3):
        super().__init__()
        self.out_vectors = out_vectors
        self.outdim = outdim
        self.mlp = MLP(input_size, hidden_sizes, out_vectors * outdim)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator       # no random draw
        return self.mlp(x).reshape(x.shape[0], self.out_vectors, self.outdim)


class MLPRegressor(nn.Module):
    """(B, input_size) -> (B, out_vectors, λ·outdim) poses, and with
    ``confidence_scores`` the (B, out_vectors, 1) logits beside them. The
    hidden layers are ``fcs.{j}`` and ``bns.{j}``; the outputs
    ``output_trasl``, ``output_normals`` and ``out_confidence``, as in the
    JAX package."""

    def __init__(self, input_size: int, out_vectors: int, outdim_trasl: int,
                 hidden_sizes: Sequence[int], outdim_orient: int = 3,
                 weight_orient: float = 1.0,
                 confidence_scores: bool = False):
        super().__init__()
        widths = [input_size, *hidden_sizes]
        self.fcs = nn.ModuleList(nn.Linear(a, b)
                                 for a, b in zip(widths[:-1], widths[1:]))
        self.bns = nn.ModuleList(FlaxBatchNorm1d(h, eps=BATCH_NORM_EPS)
                                 for h in hidden_sizes)
        self.out_vectors = out_vectors
        self.outdim_trasl = outdim_trasl
        self.outdim_orient = outdim_orient
        self.weight_orient = weight_orient
        self.confidence_scores = confidence_scores
        self.output_trasl = nn.Linear(widths[-1], out_vectors * outdim_trasl)
        if outdim_orient > 0:
            self.output_normals = nn.Linear(widths[-1],
                                            out_vectors * outdim_orient)
        if confidence_scores:
            self.out_confidence = nn.Linear(widths[-1], out_vectors)

    def forward(self, x: torch.Tensor, relative_pred: bool = False):
        """``relative_pred``: the translations are offsets from the
        input's first three values."""
        B = x.shape[0]
        h = x
        for fc, bn in zip(self.fcs, self.bns):
            h = torch.relu(bn(fc(h)))
        trasl = self.output_trasl(h)
        if self.outdim_orient > 0:
            normals = torch.tanh(self.output_normals(h)).reshape(B, -1, 3)
            normals = normals / torch.clamp(
                torch.linalg.vector_norm(normals, dim=-1, keepdim=True),
                min=1e-12) * self.weight_orient
            trasl = trasl.reshape(B, -1, 3)
            if relative_pred:
                trasl = trasl + x[:, None, :3]
            out = torch.cat([trasl, normals], dim=-1).reshape(
                B, self.out_vectors, -1)
        else:
            out = trasl.reshape(B, self.out_vectors, self.outdim_trasl)
        if self.confidence_scores:
            return out, self.out_confidence(h).reshape(B, self.out_vectors, 1)
        return out
