"""The chamfer loss terms (``maskplanner_tpu/losses/chamfer_losses.py``).

y_pred (B, S_pred, D) predicted segments; y (B, S_gt, D) GT segments,
−100-padded (``y_mask`` optional); traj_as_pc (B, P_gt, outdim) GT poses,
−100-padded (``pc_mask`` optional); outdim: values per pose.
"""
from __future__ import annotations

import torch

from ..ops.chamfer import chamfer_distance
from ..parallel import global_rows, local_rows


def chamfer(y_pred, y, y_mask=None, min_centroids=False, velocities=False,
            **_):
    """Symmetric segment chamfer ×100 (``velocities``: the search on the
    positions; ``min_centroids``: on the λ-window centroids)."""
    if velocities:
        return 100.0 * chamfer_distance(y_pred, y, velocities=True,
                                        padded=True, y_mask=y_mask)[0]
    return 100.0 * chamfer_distance(y_pred, y, padded=True, y_mask=y_mask,
                                    min_centroids=min_centroids)[0]


def symm_segment_chamfer(y_pred, y, y_mask=None, **kw):
    """The symmetric segment chamfer under its registry name."""
    return chamfer(y_pred, y, y_mask=y_mask, **kw)


def symm_point_chamfer(y_pred, traj_as_pc, outdim, pc_mask=None, **_):
    """Symmetric chamfer between the predicted poses and the GT poses
    ×100."""
    points = y_pred.reshape(y_pred.shape[0], -1, outdim)
    return 100.0 * chamfer_distance(points, traj_as_pc, padded=True,
                                    y_mask=pc_mask)[0]


def asymm_segment_chamfer(y_pred, y, y_mask=None, **_):
    """Predicted segments -> GT segments chamfer ×100."""
    return 100.0 * chamfer_distance(y_pred, y, padded=True, y_mask=y_mask,
                                    asymmetric=True)[0]


def reverse_asymm_point_chamfer(y_pred, traj_as_pc, outdim, pc_mask=None,
                                **_):
    """GT poses -> predicted poses chamfer ×100."""
    points = y_pred.reshape(y_pred.shape[0], -1, outdim)
    return 100.0 * chamfer_distance(points, traj_as_pc, padded=True,
                                    y_mask=pc_mask,
                                    reverse_asymmetric=True)[0]


def reverse_asymm_segment_chamfer(y_pred, y, y_mask=None, **_):
    """GT segments -> predicted segments chamfer ×100."""
    return 100.0 * chamfer_distance(y_pred, y, padded=True, y_mask=y_mask,
                                    reverse_asymmetric=True)[0]


def random_subset(n: int, take: int, batch: int, device,
                  generator: torch.Generator | None) -> torch.Tensor:
    """(batch, take) int64: per sample the first ``take`` of a random
    permutation of ``n``, drawn as the argsort of uniform keys from
    ``generator`` on ``device`` (which a CUDA graph can capture, where
    ``torch.randperm`` cannot)."""
    keys = local_rows(torch.rand((global_rows(batch), n),
                                 generator=generator, device=device))
    return keys.argsort(dim=-1)[:, :take]


def stoch_reverse_asymm_segment_chamfer(y_pred, y, y_mask=None,
                                        generator=None, perm=None, **_):
    """Reverse segment chamfer ×100 on a random subset of S_pred GT
    segments a sample (all of them when there are fewer). ``perm``: that
    subset, (B, min(S_pred, S_gt)) indices; None draws it from
    ``generator`` (:func:`random_subset`)."""
    B, n_pred, _ = y_pred.shape
    n_gt = y.shape[1]
    if perm is None:
        perm = random_subset(n_gt, min(n_pred, n_gt), B, y.device, generator)
    sel = torch.take_along_dim(y, perm[..., None], dim=1)
    sel_mask = (None if y_mask is None
                else torch.take_along_dim(y_mask, perm, dim=1))
    return 100.0 * chamfer_distance(y_pred, sel, padded=True, y_mask=sel_mask,
                                    reverse_asymmetric=True)[0]


def attraction_chamfer(y_pred, **_):
    """Chamfer between the segments' first and last 3 values ×100 (for
    position-only data, their start and end points)."""
    return 100.0 * chamfer_distance(y_pred[:, :, :3], y_pred[:, :, -3:])[0]


def rich_attraction_chamfer(y_pred, outdim, soft_attraction=False, **_):
    """Attraction between the segments' end poses, each with the start's
    inferred velocity appended, skipping a segment's match to itself
    (``ops.chamfer._attraction_chamfer``)."""
    vel_start = y_pred[:, :, outdim:outdim + 3] - y_pred[:, :, :3]
    starts = torch.cat([y_pred[:, :, :outdim], vel_start], dim=-1)
    ends = torch.cat([y_pred[:, :, -outdim:], vel_start], dim=-1)
    reduction = None if soft_attraction else "mean"
    return 100.0 * chamfer_distance(
        starts, ends, avoid_in_sequence_collapsing=True,
        soft_attraction=soft_attraction, point_reduction=reduction,
        batch_reduction=reduction)[0]


def chamfer_bbox(bbox_pred, bbox_gt, bbox_mask=None, **_):
    """Symmetric chamfer between predicted and GT boxes ×100."""
    return 100.0 * chamfer_distance(bbox_pred, bbox_gt, padded=True,
                                    y_mask=bbox_mask)[0]


def chamfer_strokes(segments_per_stroke_pred, segments_per_stroke_gt,
                    gt_mask=None, **_):
    """Symmetric chamfer ×100 between each predicted stroke's segments and
    its GT stroke's, the strokes stacked on the batch axis (B·M, S,
    λ·outdim), the GT −100-padded (or ``gt_mask``): two argmin launches on
    the stack."""
    return 100.0 * chamfer_distance(segments_per_stroke_pred,
                                    segments_per_stroke_gt, padded=True,
                                    y_mask=gt_mask)[0]
