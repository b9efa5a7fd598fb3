"""Masked chamfer distance (``maskplanner_tpu/ops/chamfer.py``).

The flags the MaskPlanner v6 loss uses: ``padded``, ``x_mask``/``y_mask``,
``asymmetric``, ``reverse_asymmetric``, ``return_matching``,
``point_reduction``, ``batch_reduction``. Matched indices come from
``nn_argmin`` (the CUDA kernel on the card); the squared distances are
recomputed by a gather, so that the gradient flows through the gather to
both endpoints as it does through a min over the distance matrix. A
direction that the asymmetric variants do not need is skipped, as in the
JAX package's ``_nn_gather_chamfer``.

``x`` is the prediction set, ``y`` the ground truth (−100-padded rows).
All distances are squared euclidean distances.
"""
from __future__ import annotations

import torch

from .nn_argmin import nn_argmin

PAD_VALUE = -100.0


def mask_from_padding(y: torch.Tensor,
                      pad_value: float = PAD_VALUE) -> torch.Tensor:
    """Validity mask from sentinel padding: True until the first row whose
    coordinate 0 equals ``pad_value`` (suffix padding)."""
    is_pad = (y[..., 0] == pad_value).to(torch.int32)
    return torch.cumsum(is_pad, dim=-1) == 0


def _gather_rows(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(points, 1,
                        idx.long()[..., None].expand(-1, -1, points.shape[-1]))


def chamfer_distance(x, y, x_mask=None, y_mask=None, batch_reduction="mean",
                     point_reduction="mean", velocities=False,
                     min_centroids=False, padded=False,
                     avoid_in_sequence_collapsing=False,
                     soft_attraction=False, asymmetric=False,
                     reverse_asymmetric=False, return_matching=False):
    """Chamfer distance between two batched point sets; ``(dist, None)`` or,
    with ``return_matching``, ``(dist, None, x_idx, y_idx)``."""
    if velocities or min_centroids or avoid_in_sequence_collapsing \
            or soft_attraction:
        raise NotImplementedError(
            "chamfer_distance: velocities, min_centroids and the attraction "
            "variants are not ported yet (ROADMAP.md, Queue 1)")
    B, P1, _ = x.shape
    P2 = y.shape[1]
    if padded and y_mask is None:
        y_mask = mask_from_padding(y)
    x_lengths = (torch.full((B,), float(P1), device=x.device)
                 if x_mask is None else x_mask.sum(-1).float())
    y_lengths = (torch.full((B,), float(P2), device=x.device)
                 if y_mask is None else y_mask.sum(-1).float())

    cham_x = x.new_zeros((B, P1))
    cham_y = x.new_zeros((B, P2))
    x_idx = y_idx = None
    if not reverse_asymmetric or return_matching:
        x_idx = nn_argmin(x, y, y_mask)
        cham_x = ((x - _gather_rows(y, x_idx)) ** 2).sum(-1)
    if not asymmetric or return_matching:
        y_idx = nn_argmin(y, x, x_mask)
        cham_y = ((y - _gather_rows(x, y_idx)) ** 2).sum(-1)

    if x_mask is not None:
        cham_x = torch.where(x_mask, cham_x, 0.0)
    if y_mask is not None:
        cham_y = torch.where(y_mask, cham_y, 0.0)

    if point_reduction is not None:
        cham_x = cham_x.sum(-1)
        cham_y = cham_y.sum(-1)
        if point_reduction == "mean":
            cham_x = cham_x / x_lengths
            cham_y = cham_y / torch.clamp(y_lengths, min=1.0)

    if batch_reduction is not None:
        cham_x = cham_x.sum()
        cham_y = cham_y.sum()
        if batch_reduction == "mean":
            cham_x = cham_x / B
            cham_y = cham_y / B

    if asymmetric:
        dist = cham_x
    elif reverse_asymmetric:
        dist = cham_y
    else:
        dist = cham_x + cham_y
    if return_matching:
        return dist, None, x_idx, y_idx
    return dist, None
