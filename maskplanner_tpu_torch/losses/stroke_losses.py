"""The earth mover's distance term (``maskplanner_tpu/losses/
stroke_losses.py::emd``). The stroke-wise and start-of-path terms of that
module wait for their models (ROADMAP.md, Queue 1)."""
from __future__ import annotations

import torch

from ..ops.chamfer import mask_from_padding
from ..ops.hungarian import hungarian
from ..ops.sinkhorn import sinkhorn_emd
from .common import euclid_cdist

# above this many (prediction, GT) pairs the exact assignment gives way to
# Sinkhorn, as in the JAX package
EXACT_PAIRS = 128 * 128


def emd(y_pred, y, y_mask=None, **_):
    """Earth mover's distance: the predictions matched one to one to the
    valid GT entries at least total euclidean cost (``ops.hungarian``: the
    LAP kernel on the card), the mean over the matched pairs of the summed
    squared differences. Over ``EXACT_PAIRS`` pairs a sample, the Sinkhorn
    soft EMD (``ops.sinkhorn``) instead. With fewer predictions than valid
    GT entries only as many pairs as predictions are matched."""
    if y_mask is None:
        y_mask = mask_from_padding(y)
    n_pred = y_pred.shape[1]
    if n_pred * y.shape[1] > EXACT_PAIRS:
        return sinkhorn_emd(y_pred, y, y_mask=y_mask)
    row4col, matched = hungarian(euclid_cdist(y_pred, y), y_mask)
    # the square padding gives the excess GT columns fake rows
    matched = matched & (row4col < n_pred)
    chosen = torch.take_along_dim(
        y_pred, torch.clamp(row4col, max=n_pred - 1)[..., None], dim=1)
    per_col = ((chosen - torch.where(y_mask[..., None], y, 0.0)) ** 2).sum(-1)
    total = torch.clamp(matched.sum(), min=1)
    return torch.where(matched, per_col, 0.0).sum() / total
