"""Stroke-mask -> stroke-id extraction (DETR-style postprocess).

Reference: utils/postprocessing.py:92-152. Vectorized numpy; no torch.
"""
from __future__ import annotations

import numpy as np


def stable_sigmoid(x, dtype=None):
    """Overflow-stable sigmoid (exp only ever sees non-positive args).

    ``dtype=None`` preserves a float input's dtype — float32 saturation
    ties then resolve exactly like the reference's torch float32 sigmoid;
    non-float inputs (and explicit ``dtype`` requests) are cast. Shared by
    every postprocess module that thresholds confidence logits."""
    x = np.asarray(x)
    if dtype is not None:
        x = x.astype(dtype)
    elif x.dtype.kind != "f":
        x = x.astype(np.float64)
    out = np.empty_like(x)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


_sigmoid = stable_sigmoid  # module-internal alias (callers below)


def process_pred_stroke_masks_to_stroke_ids(
    pred_stroke_masks: np.ndarray,
    confidence_scores: np.ndarray,
    confidence_threshold: float = 0.5,
) -> np.ndarray:
    """Assign a stroke id to every predicted segment.

    1. sigmoid masks + confidences; zero out masks whose confidence is
       below threshold (reference utils/postprocessing.py:126-131)
    2. per-segment argmax over masks
    3. re-number the surviving mask ids contiguously from 0

    Returns (B, out_segments) float array of contiguous stroke ids.
    """
    assert pred_stroke_masks.ndim == 3 and confidence_scores.ndim == 2
    probs = _sigmoid(np.asarray(pred_stroke_masks))
    conf = _sigmoid(np.asarray(confidence_scores))
    probs = np.where((conf >= confidence_threshold)[:, :, None], probs, 0.0)

    B, _, out_segments = probs.shape
    stroke_ids = np.full((B, out_segments), -1.0)
    assoc = probs.argmax(axis=1)  # (B, out_segments)
    for b in range(B):
        for i, mask_id in enumerate(np.unique(assoc[b])):
            stroke_ids[b, assoc[b] == mask_id] = i
    return stroke_ids


def handle_end_of_sequence(sequence, confidence_logits, threshold):
    """Truncate a sequence at the first low-confidence vector
    (reference utils/postprocessing.py:77-90)."""
    high = np.asarray(confidence_logits) > threshold
    if np.all(high):
        return sequence
    return sequence[: int(np.argmin(high))]


def from_stroke_ids_to_masks(stroke_ids, n_masks=None):
    """Binary per-stroke masks from a stroke-id vector (reference
    utils/postprocessing.py ``from_stroke_ids_to_masks``, used by the
    render driver's align path). Negative ids (padding) belong to no
    mask. Returns (n_masks, n_segments) float 0/1."""
    ids = np.asarray(stroke_ids).reshape(-1)
    valid = ids >= 0
    n = int(n_masks) if n_masks is not None else (
        int(ids[valid].max()) + 1 if valid.any() else 0)
    return (ids[None, :] == np.arange(n)[:, None]).astype(np.float64)


def compute_total_path_length(traj_points, stroke_id_col=6):
    """Total spatial length of a point-format trajectory (reference
    standalone/from_pred_to_offline_v2.py:244-260): sum of
    consecutive-point distances over the xyz columns, accumulated per
    stroke id so travel moves between strokes do not count.

    ``stroke_id_col`` names the stroke-id column (the reference's
    trajectory.txt format keeps it at index 6). It is only honored when
    the array is wide enough; pass ``stroke_id_col=None`` for pure pose
    rows with no id column — a width heuristic alone cannot tell a
    7-column X..C+strokeId row from a 7-column xyz+orientquat pose."""
    pts = np.asarray(traj_points, np.float64)
    if pts.shape[0] < 2:
        return 0.0
    if (stroke_id_col is not None and pts.ndim == 2
            and pts.shape[1] > stroke_id_col):
        total = 0.0
        for pid in np.unique(pts[:, stroke_id_col]):
            stroke = pts[pts[:, stroke_id_col] == pid, :3]
            if stroke.shape[0] < 2:
                continue
            total += float(np.linalg.norm(np.diff(stroke, axis=0),
                                          axis=1).sum())
        return total
    return float(np.linalg.norm(np.diff(pts[:, :3], axis=0), axis=1).sum())
