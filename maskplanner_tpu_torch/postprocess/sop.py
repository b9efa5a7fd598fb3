"""Start-of-path (SoP) prediction postprocessing.

Reference: utils/postprocessing.py:639-702 (confidence filtering of SoP
tokens, autoregressive end-of-path truncation).
"""
from __future__ import annotations

import numpy as np

from .stroke_ids import stable_sigmoid


def _sigmoid(x):
    return stable_sigmoid(x, dtype=np.float64)


def unpad_rows(rows: np.ndarray, pad_value: float = -100.0):
    """Drop rows that are entirely pad_value (reference
    utils/postprocessing.py ``remove_padding_from_tensors``)."""
    rows = np.asarray(rows)
    fake = np.all(rows == pad_value, axis=-1)
    return rows[~fake]


def postprocess_sop_predictions(sop_pred, pred_sop_conf_scores,
                                sop_conf_threshold=0.5):
    """Keep SoP tokens whose confidence clears the threshold.

    sop_pred: (B, n_prototypes, D); pred_sop_conf_scores: (B, n_prototypes)
    Returns list of B arrays (retained_n, D).
    (reference utils/postprocessing.py:639-667)
    """
    sop_pred = np.asarray(sop_pred)
    conf = _sigmoid(np.asarray(pred_sop_conf_scores))
    # strictly-greater, like the reference (:648 ``sop_probs[b] > t``)
    return [sop_pred[b][conf[b] > sop_conf_threshold]
            for b in range(sop_pred.shape[0])]


def truncate_autoregressive_eop(strokes, eop_logits, threshold=0.5):
    """Truncate rolled-out strokes at the first end-of-path trigger
    (reference utils/postprocessing.py:670-702)."""
    out = []
    for s, logit in zip(strokes, eop_logits):
        prob = _sigmoid(np.asarray(logit))
        hit = prob >= threshold
        end = int(np.argmax(hit)) + 1 if hit.any() else len(s)
        out.append(np.asarray(s)[:end])
    return out


def select_top_bboxes(batch_bboxes, threshold=0.05):
    """Greedy distance-based dedup of stroke-proposal 3D bboxes.

    For each surviving box (ascending index) drop every later box whose
    bbox-vector euclidean distance is below ``threshold`` (reference
    select_top_bboxes, utils/postprocessing.py:29-74; its unused NMS
    branch is not reproduced). Returns a list of per-sample retained-box
    arrays.
    """
    out = []
    for bboxes in batch_bboxes:
        bboxes = np.asarray(bboxes)
        n = bboxes.shape[0]
        d = np.linalg.norm(bboxes[:, None, :] - bboxes[None, :, :], axis=-1)
        dropped = np.zeros(n, dtype=bool)
        for i in range(n):
            if dropped[i]:
                continue
            close = d[i] < threshold
            close[i] = False
            dropped |= close
        out.append(bboxes[~dropped])
    return out
