"""The paint-coverage metric from per-face thickness feedback: the port's
copy of ``get_thicknesses_values_per_face`` and ``coverage_for_pair`` of
the repo-root ``standalone/compute_paint_coverage_per_face.py`` (the
paper's ">99% coverage" metric).

A face counts as GT-covered when its mean-vertex thickness clears the GT's
p-th percentile over non-zero faces; coverage is the share of GT-covered
faces also covered in the prediction.
"""
from __future__ import annotations

import numpy as np


def get_thicknesses_values_per_face(path: str) -> np.ndarray:
    """CSV of 3·N per-vertex thicknesses (``index;thickness`` rows or one
    value a row) -> N per-face means."""
    values = np.genfromtxt(path, delimiter=";", dtype=np.float64)
    if values.ndim == 2:
        values = values[:, 1]
    if values.shape[0] % 3:
        raise ValueError(f"{path}: expected 3 vertex rows per face, got "
                         f"{values.shape[0]} rows")
    return values.reshape(-1, 3).mean(axis=1)


def coverage_for_pair(gt_faces: np.ndarray, pred_faces: np.ndarray,
                      percentile: int,
                      threshold: float | None = None) -> float:
    """Share of the GT-covered faces that the prediction covers. Pass the
    GT's ``threshold`` when it is already known (one sort a GT item)."""
    nonzero = ~np.isclose(gt_faces, 0.0)
    if not nonzero.any():
        raise ValueError("GT thickness file has no painted faces "
                         "(all-zero); coverage is undefined")
    if threshold is None:
        threshold = np.percentile(gt_faces[nonzero], percentile)
    covered = nonzero & (gt_faces >= threshold)
    n_gt = int(covered.sum())
    n_pred = int((pred_faces[covered] >= threshold).sum())
    return n_pred / max(n_gt, 1)
