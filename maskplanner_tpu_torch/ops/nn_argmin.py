"""Masked nearest-neighbour argmin
(``maskplanner_tpu/ops/pallas/nn_argmin.py``).

For every x row, the index of the nearest valid y row by squared distance,
formed in the fixed order of ``ops.distance.square_distance``. Ties go to
the lowest index; a row with no valid y row gives 0. Only indices come out:
the chamfer terms recompute the matched distances by a gather, so that the
gradient flows through the gather (``ops/chamfer.py``).

A CUDA tensor goes to the kernel (``ops/cuda/nn_argmin.py``), a CPU tensor
to :func:`nn_argmin_plain`.
"""
from __future__ import annotations

import torch

from .distance import square_distance


def nn_argmin_plain(x: torch.Tensor, y: torch.Tensor,
                    y_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the (B, P1, P2) distance matrix and a masked argmin
    (``torch.argmin`` returns the first minimal index)."""
    d = square_distance(x.detach(), y.detach())
    if y_mask is not None:
        d = torch.where(y_mask[:, None, :], d, torch.inf)
    idx = torch.argmin(d, dim=-1)
    if y_mask is not None:
        idx = torch.where(y_mask.any(dim=-1, keepdim=True), idx, 0)
    return idx.to(torch.int32)


def nn_argmin(x: torch.Tensor, y: torch.Tensor,
              y_mask: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, P1, D), y (B, P2, D), y_mask optional (B, P2) bool ->
    (B, P1) int32 indices into y."""
    if x.device.type == "cuda":
        from .cuda.nn_argmin import nn_argmin_cuda

        return nn_argmin_cuda(x.detach(), y.detach(), y_mask)
    if x.device.type == "cpu":
        return nn_argmin_plain(x, y, y_mask)
    raise ValueError(f"no nn_argmin for device {x.device}")
