"""Masked chamfer distance (``maskplanner_tpu/ops/chamfer.py``).

Every flag of the JAX package's: ``padded``, ``x_mask``/``y_mask``,
``asymmetric``, ``reverse_asymmetric``, ``return_matching``,
``point_reduction``, ``batch_reduction``, ``velocities`` (the search on
the positions, the distance on the full rows), ``min_centroids`` (the
λ-window centroids) and ``avoid_in_sequence_collapsing`` with
``soft_attraction`` (the attraction chamfer, :func:`_attraction_chamfer`).
Matched indices come from ``nn_argmin`` (the CUDA kernel on the card); the
squared distances are recomputed by a gather on the full rows, so that the
gradient flows through the gather to both endpoints as it does through a
min over the distance matrix. A direction that the asymmetric variants do
not need is skipped, as in the JAX package's ``_nn_gather_chamfer``.

``x`` is the prediction set, ``y`` the ground truth (−100-padded rows).
All distances are squared euclidean distances.
"""
from __future__ import annotations

import torch

from .distance import smallest_k, square_distance
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


def nearest_sq_distance(x, y, y_mask=None, search_dims=None):
    """One direction of the chamfer distance: for every x row the squared
    distance to its nearest valid y row, recomputed by a gather, and that
    row's index -> (B, P1) distances, (B, P1) int32 indices. One
    ``nn_argmin`` launch. ``search_dims``: search on the first that many
    coordinates only (the distance still takes every coordinate)."""
    if search_dims is None:
        idx = nn_argmin(x, y, y_mask)
    else:
        idx = nn_argmin(x[..., :search_dims], y[..., :search_dims], y_mask)
    return ((x - _gather_rows(y, idx)) ** 2).sum(-1), idx


def chamfer_distance(x, y, x_mask=None, y_mask=None, batch_reduction="mean",
                     point_reduction="mean", velocities=False,
                     min_centroids=False, padded=False,
                     avoid_in_sequence_collapsing=False,
                     soft_attraction=False, asymmetric=False,
                     reverse_asymmetric=False, return_matching=False):
    """Chamfer distance between two batched point sets; ``(dist, None)`` or,
    with ``return_matching``, ``(dist, None, x_idx, y_idx)``."""
    B, P1, D = x.shape
    P2 = y.shape[1]
    if padded and y_mask is None:
        y_mask = mask_from_padding(y)
    x_lengths = (torch.full((B,), float(P1), device=x.device)
                 if x_mask is None else x_mask.sum(-1).float())
    y_lengths = (torch.full((B,), float(P2), device=x.device)
                 if y_mask is None else y_mask.sum(-1).float())

    if min_centroids:
        # compare the λ-window centroids, every 3 values taken as a point
        lam = D // 3
        x = x.reshape(B, P1, lam, 3).mean(-2)
        y = y.reshape(B, P2, lam, 3).mean(-2)
    if avoid_in_sequence_collapsing and not velocities:
        return _attraction_chamfer(x, y, soft=soft_attraction)
    search_dims = 3 if velocities else None

    cham_x = x.new_zeros((B, P1))
    cham_y = x.new_zeros((B, P2))
    x_idx = y_idx = None
    if not reverse_asymmetric or return_matching:
        cham_x, x_idx = nearest_sq_distance(x, y, y_mask, search_dims)
    if not asymmetric or return_matching:
        cham_y, y_idx = nearest_sq_distance(y, x, x_mask, search_dims)

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


def _attraction_chamfer(x, y, soft: bool):
    """The chamfer that skips self-matches at the same sequence position
    (x and y hold P rows each, row i of x belongs with row i of y): a
    nearest row at the own index is replaced by the second nearest (hard)
    or the row is dropped (soft). The hard variant sums over the rows and
    averages over the batch whatever the reductions asked for, as the JAX
    package does."""
    P = x.shape[1]
    seq = torch.arange(P, device=x.device)

    def one_direction(src, dst):
        top2, idx = smallest_k(square_distance(src, dst), 2)
        d0, d1 = top2[..., 0], top2[..., 1]
        self_match = idx[..., 0] == seq[None, :]
        if soft:
            keep = ~self_match
            per_b = torch.where(keep, d0, 0.0).sum(-1) / torch.clamp(
                keep.sum(-1), min=1)
            return per_b.mean()
        return torch.where(self_match, d1, d0).sum(-1)

    cham_x = one_direction(x, y)
    cham_y = one_direction(y, x)
    if soft:
        return cham_x + cham_y, None
    return (cham_x + cham_y).mean(), None
