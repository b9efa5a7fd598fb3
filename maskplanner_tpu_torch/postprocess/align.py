"""Stroke-id alignment for visualization
(``maskplanner_tpu/postprocess/align.py``).

Reference: utils/postprocessing.py:456-569
(permute_and_align_stroke_ids_for_visualization + match_stroke_masks):
rename predicted stroke ids so matching strokes share the GT's id (and
therefore color) in side-by-side renders. The matching maximizes
segment-overlap between predicted-id groups and GT-projected-id groups via
the Hungarian assignment. Host code: the nearest GT segment comes from the
port's ``ops.chamfer`` on CPU tensors (its plain argmin).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..ops.chamfer import chamfer_distance
from . import native


def _lap_pairs(cost: np.ndarray):
    """(row_idx, col_idx) of the optimal assignment — native C++ JV when
    available (native/ocmg_native.cpp), scipy otherwise."""
    n, m = cost.shape
    if n >= m:
        row4col = native.solve_lap(cost)
        if row4col is not None:
            return row4col, np.arange(m)
    else:
        col4row = native.solve_lap(cost.T)
        if col4row is not None:
            return np.arange(n), col4row
    return linear_sum_assignment(cost)


def permute_and_align_stroke_ids_for_visualization(
    traj_pred, pred_stroke_ids, traj_gt, gt_stroke_ids, config
):
    """Returns renamed pred stroke ids aligned to GT ids.

    1. chamfer-match each predicted segment to its nearest GT segment and
       adopt that segment's GT stroke id (reference :473-476)
    2. Hungarian-match predicted-id groups to GT-id groups by overlap
    3. unmatched predicted ids get fresh ids beyond the GT range
    """
    _, _, match, _ = chamfer_distance(
        torch.as_tensor(np.asarray(traj_pred), device="cpu"),
        torch.as_tensor(np.asarray(traj_gt), device="cpu"), padded=True,
        return_matching=True)
    match = match.numpy()
    gt_stroke_ids = np.asarray(gt_stroke_ids)
    pred_stroke_ids = np.asarray(pred_stroke_ids)

    B = traj_pred.shape[0]
    out = np.full_like(pred_stroke_ids, -1, dtype=np.int64)
    for b in range(B):
        target_ids = gt_stroke_ids[b][match[b]]  # GT id per pred segment
        pred_ids = pred_stroke_ids[b]
        p_uniq = [p for p in np.unique(pred_ids) if p >= 0]
        g_uniq = [g for g in np.unique(target_ids) if g >= 0]
        overlap = np.zeros((len(p_uniq), len(g_uniq)))
        for i, p in enumerate(p_uniq):
            for j, g in enumerate(g_uniq):
                overlap[i, j] = np.sum((pred_ids == p) & (target_ids == g))
        ri, ci = _lap_pairs(-overlap)
        mapping = {p_uniq[i]: g_uniq[j] for i, j in zip(ri, ci)}
        next_id = (max(g_uniq) + 1) if g_uniq else 0
        for p in p_uniq:
            if p not in mapping:
                mapping[p] = next_id
                next_id += 1
        for p, g in mapping.items():
            out[b][pred_ids == p] = g
    return out
