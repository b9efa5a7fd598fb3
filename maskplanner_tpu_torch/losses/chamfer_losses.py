"""The chamfer loss terms of the MaskPlanner v6 loss
(``maskplanner_tpu/losses/chamfer_losses.py``).

y_pred (B, S_pred, D) predicted segments; y (B, S_gt, D) GT segments,
−100-padded (``y_mask`` optional); traj_as_pc (B, P_gt, outdim) GT poses,
−100-padded (``pc_mask`` optional); outdim: values per pose.
"""
from __future__ import annotations

from ..ops.chamfer import chamfer_distance


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
