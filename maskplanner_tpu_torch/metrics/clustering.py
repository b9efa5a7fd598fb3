"""Clustering evaluation metrics (numpy, dependency-free).

Replaces the reference's vendored torchmetrics clustering internals
(``utils/metrics/homogeneity_completeness_v_measure.py``,
``utils/metrics/mutual_info_score.py``, ``utils/metrics/utils.py``):
contingency matrix, entropies, mutual information, homogeneity /
completeness / V-measure, and adjusted Rand score via the pair-confusion
matrix.
"""
from __future__ import annotations

import numpy as np


def contingency_matrix(labels_true, labels_pred):
    """Counts n_ij of points with true label i and predicted label j."""
    true_classes, true_idx = np.unique(labels_true, return_inverse=True)
    pred_classes, pred_idx = np.unique(labels_pred, return_inverse=True)
    n = np.zeros((len(true_classes), len(pred_classes)), dtype=np.int64)
    np.add.at(n, (true_idx, pred_idx), 1)
    return n


def _entropy(counts):
    p = counts[counts > 0].astype(np.float64)
    p = p / p.sum()
    return float(-(p * np.log(p)).sum())


def mutual_info_score(labels_true, labels_pred, contingency=None):
    """Mutual information between two labelings (natural log)."""
    c = contingency_matrix(labels_true, labels_pred) if contingency is None else contingency
    total = c.sum()
    nz = c > 0
    pij = c[nz].astype(np.float64) / total
    pi = (c.sum(axis=1, keepdims=True) / total).repeat(c.shape[1], axis=1)[nz]
    pj = (c.sum(axis=0, keepdims=True) / total).repeat(c.shape[0], axis=0)[nz]
    return float((pij * (np.log(pij) - np.log(pi * pj))).sum())


def homogeneity_completeness_v_measure(labels_true, labels_pred, beta=1.0):
    """Reference: utils/metrics/homogeneity_completeness_v_measure.py."""
    labels_true = np.asarray(labels_true).ravel()
    labels_pred = np.asarray(labels_pred).ravel()
    if len(labels_true) == 0:
        return 1.0, 1.0, 1.0
    c = contingency_matrix(labels_true, labels_pred)
    h_c = _entropy(c.sum(axis=1))
    h_k = _entropy(c.sum(axis=0))
    mi = mutual_info_score(None, None, contingency=c)
    homogeneity = mi / h_c if h_c else 1.0
    completeness = mi / h_k if h_k else 1.0
    if homogeneity + completeness == 0.0:
        v = 0.0
    else:
        v = ((1 + beta) * homogeneity * completeness
             / (beta * homogeneity + completeness))
    return homogeneity, completeness, v


def v_measure_score(labels_true, labels_pred, beta=1.0):
    return homogeneity_completeness_v_measure(labels_true, labels_pred, beta)[2]


def homogeneity_score(labels_true, labels_pred):
    """Reference: utils/metrics/homogeneity_completeness_v_measure.py:46."""
    return homogeneity_completeness_v_measure(labels_true, labels_pred)[0]


def completeness_score(labels_true, labels_pred):
    """Reference: utils/metrics/homogeneity_completeness_v_measure.py:39."""
    return homogeneity_completeness_v_measure(labels_true, labels_pred)[1]


def pair_confusion_matrix(labels_true, labels_pred):
    """2x2 pair confusion matrix (reference utils/metrics/utils.py)."""
    c = contingency_matrix(labels_true, labels_pred).astype(np.float64)
    n = c.sum()
    sum_sq = (c**2).sum()
    sum_rows_sq = (c.sum(axis=1) ** 2).sum()
    sum_cols_sq = (c.sum(axis=0) ** 2).sum()
    tn = n**2 + sum_sq - sum_rows_sq - sum_cols_sq
    fp = sum_cols_sq - sum_sq
    fn = sum_rows_sq - sum_sq
    tp = sum_sq - n
    return np.array([[tn, fp], [fn, tp]])


def adjusted_rand_score(labels_true, labels_pred):
    (tn, fp), (fn, tp) = pair_confusion_matrix(labels_true, labels_pred)
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))
