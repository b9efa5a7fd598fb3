"""StrokeWise-task inference postprocessing (host side, numpy).

Reference: ``postprocess_strokewise_predictions_into_strokes``
(utils/postprocessing.py:705-756), ``from_strokewise_to_pointwise``
(:759-797) and ``remove_padding_from_tensors`` (:800-816). The StrokeWise
model predicts whole fixed-length strokes plus per-stroke and per-point
confidences; postprocessing keeps confident strokes and truncates each at
its first low-confidence point.
"""
from __future__ import annotations

import numpy as np

from .stroke_ids import stable_sigmoid

from ..data.pointcloud import get_dim_traj_points

PAD = -100.0


def _sigmoid(x):
    return stable_sigmoid(x, dtype=np.float64)


def postprocess_strokewise_predictions_into_strokes(
    strokes,
    point_scores,
    stroke_scores,
    config,
    stroke_conf_threshold: float = 0.5,
    point_conf_threshold: float = 0.5,
):
    """Keep confident strokes, truncate each at its learned length.

    strokes: (B, max_n_strokes, max_points*outdim) raw predictions
    point_scores: (B, max_n_strokes, max_points) logits
    stroke_scores: (B, max_n_strokes) logits
    Returns a list of B arrays (n_retained, max_points*outdim) with points
    beyond the learned length padded with -100.

    Truncation = first point whose confidence falls below the threshold
    (reference :743-751). The reference's bare argmax yields zero-length
    strokes when NO point is below threshold (a flagged TODO at :739-741);
    here that case keeps the full stroke.
    """
    strokes = np.asarray(strokes)
    B = strokes.shape[0]
    outdim = get_dim_traj_points(config["extra_data"])
    point_logits = _sigmoid(point_scores)
    stroke_logits = _sigmoid(stroke_scores)

    out = []
    for b in range(B):
        keep = stroke_logits[b] > stroke_conf_threshold
        retained = strokes[b][keep].copy()
        retained = retained.reshape(retained.shape[0], -1, outdim)
        logits = point_logits[b][keep]

        below = logits < point_conf_threshold
        lengths = np.argmax(below, axis=-1)
        lengths[~below.any(axis=-1)] = logits.shape[-1]  # all-confident
        mask = np.arange(logits.shape[-1])[None, :] < lengths[:, None]
        retained[~mask] = PAD
        out.append(retained.reshape(retained.shape[0], -1))
    return out


def from_strokewise_to_pointwise(strokes, config, return_stroke_ids=True,
                                 remove_padding=True):
    """(N, max_points*outdim) stroke rows -> (M, outdim) flat points (+ids),
    dropping -100 pad points (reference :759-797)."""
    strokes = np.asarray(strokes)
    assert strokes.ndim == 2, "batch dimension is not expected"
    N = strokes.shape[0]
    outdim = get_dim_traj_points(config["extra_data"])

    pts = strokes.reshape(N, -1, outdim)
    ppstroke = pts.shape[1]
    flat = pts.reshape(N * ppstroke, outdim)
    ids = np.repeat(np.arange(N), ppstroke)

    if remove_padding:
        fake = np.all(np.isclose(flat, PAD), axis=-1)
        flat = flat[~fake]
        ids = ids[~fake]
    if return_stroke_ids:
        return flat, ids
    return flat


def remove_padding_from_tensors(tensors):
    """Drop all-(-100) rows from an (N, D) array (reference :800-816)."""
    tensors = np.asarray(tensors)
    assert tensors.ndim == 2
    fake = np.all(tensors == PAD, axis=-1)
    return tensors[~fake]
