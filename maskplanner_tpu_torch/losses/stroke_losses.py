"""Stroke-level, autoregressive and set-matching loss terms
(``maskplanner_tpu/losses/stroke_losses.py``).

The whole-stroke terms of the stroke-wise model and of the rollout head,
the next-token terms of the autoregressive rollout, the earth mover's
distance, and the start-of-path matching. The matchings run through
``ops.hungarian`` (the LAP kernel on the card); variable stroke counts are
validity masks over static stroke axes.
"""
from __future__ import annotations

import torch
from torch.nn import functional

from ..ops.chamfer import mask_from_padding
from ..ops.hungarian import hungarian
from ..ops.sinkhorn import sinkhorn_emd
from .common import bce_with_logits, euclid_cdist

# above this many (prediction, GT) pairs the exact assignment gives way to
# Sinkhorn, as in the JAX package
EXACT_PAIRS = 128 * 128
PAD = -100.0


def mse_strokes(stacked_strokes_pred, stacked_strokes_gt, **_):
    """Squared differences summed over the values of a stroke, mean over
    the strokes."""
    return ((stacked_strokes_pred - stacked_strokes_gt) ** 2).sum(-1).mean()


def mse_nexttoken(stacked_pred_nexttoken, stacked_gt_nexttoken, **_):
    """The next segment's squared error summed over its values, mean over
    the histories."""
    return ((stacked_pred_nexttoken - stacked_gt_nexttoken) ** 2) \
        .sum(-1).mean()


def mse_nexttoken_v2(stacked_pred_nexttoken, stacked_gt_nexttoken,
                     end_of_path_scores, end_of_path_gt, weights, **_):
    """100 × the next-token MSE, plus the end-of-path BCE on logits with
    the non-final histories weighted by (#final / #non-final), times
    ``explicit_weight_endofpath_confidence_loss``."""
    mse = 100.0 * ((stacked_pred_nexttoken - stacked_gt_nexttoken) ** 2) \
        .sum(-1).mean()
    eop = end_of_path_gt.to(torch.float32)
    true_count = torch.clamp(eop.sum(), min=1.0)
    false_count = torch.clamp((1.0 - eop).sum(), min=1.0)
    w = torch.where(eop == 0, true_count / false_count, 1.0)
    bce = (w * bce_with_logits(end_of_path_scores, eop)).mean()
    return mse + weights["explicit_weight_endofpath_confidence_loss"] * bce


def _masked_mse_rows(pred_rows, gt_rows):
    """Σ over the values of (pred − gt)², the −100 GT values left out."""
    fake = torch.isclose(gt_rows, torch.full_like(gt_rows, PAD))
    diff = torch.where(fake, 0.0, pred_rows - gt_rows)
    return (diff ** 2).sum(-1)


def masked_mse_strokes(stacked_points_per_stroke_pred,
                       stacked_points_per_stroke_gt, confidence_scores, **_):
    """Strokes stacked on axis 0, (K, N, outdim): the ordered squared error
    over the GT's real points, summed over a stroke, mean over the strokes,
    plus the per-point length-confidence BCE on logits (target: the point
    is real) likewise summed and averaged."""
    gt = stacked_points_per_stroke_gt
    n_gt = gt.shape[1]
    pred = stacked_points_per_stroke_pred[:, :n_gt, :]
    fake = torch.all(gt == PAD, dim=-1)                       # (K, N_gt)
    diff = torch.where(fake[..., None], 0.0, pred - gt)
    mse = (diff ** 2).sum(-1).sum(-1).mean()
    conf = confidence_scores[:, :n_gt, 0]
    bce = bce_with_logits(conf, (~fake).to(torch.float32)).sum(-1).mean()
    return bce + mse


def masked_mse_strokes_from_segments(stacked_points_per_stroke_pred,
                                     stacked_points_per_stroke_gt,
                                     confidence_scores, output_mask, **_):
    """The masked point MSE, plus the end-of-stroke BCE on probabilities
    (10 at a stroke's last real point, 1 elsewhere). The EoS term is
    reduced to its mean over every entry and only then scaled by the mean
    of the mask, as the JAX package (and the reference's WeightedBCELoss)
    do."""
    mask = output_mask[..., None].to(torch.float32)
    point_loss = (((stacked_points_per_stroke_pred
                    - stacked_points_per_stroke_gt) ** 2) * mask).mean()
    eos_probs = torch.clamp(confidence_scores, 1e-7, 1 - 1e-7)
    N = eos_probs.shape[1]
    last_idx = (output_mask.sum(dim=1) - 1).long()
    # JAX's one_hot gives a zero row for an index out of range (-1 for a
    # stroke without real points)
    eos_targets = (last_idx[:, None] == torch.arange(
        N, device=last_idx.device)).to(eos_probs.dtype)[..., None]
    pos_w, neg_w = 10.0, 1.0
    eos_loss = (-pos_w * eos_targets * torch.log(eos_probs)
                - neg_w * (1 - eos_targets) * torch.log(1 - eos_probs))
    return point_loss + eos_loss.mean() * mask.mean()


def _take_rows(x, rows):
    """``x`` (B, n, ...) gathered at ``rows`` (B, k) along axis 1, NaN where
    a row is n or more, as ``jnp.take_along_axis`` fills. ``hungarian``
    pads a problem with fewer rows than columns with fake rows, which the
    masked columns may take; their NaN is dropped by the callers' masks
    and gets no gradient."""
    n = x.shape[1]
    chosen = torch.take_along_dim(x, rows.clamp(max=n - 1)[..., None], dim=1)
    return torch.where((rows < n)[..., None], chosen, torch.nan)


def _assigned(row4col, matched, n_rows):
    """(B, n_rows) 1 where a prediction row is matched to a real column; a
    fake row (n_rows or more) has no one-hot bit, as in ``jax.nn.one_hot``."""
    one_hot = (row4col[..., None] == torch.arange(
        n_rows, device=row4col.device)).to(torch.float32)
    return (one_hot * matched[..., None]).sum(dim=1).clamp(0.0, 1.0)


def masked_mse_strokes_v2(pred_points_per_stroke, points_per_stroke,
                          pred_point_scores, pred_stroke_scores,
                          gt_stroke_mask, weights, outdim=6, **_):
    """The stroke-wise model's loss: its strokes matched one to one to the
    real GT strokes (``gt_stroke_mask``) at least total masked squared
    error (``ops.hungarian``), then the weighted sum of the matched masked
    MSE, the matched per-point confidence BCE and the per-stroke
    confidence BCE (unmatched strokes weighted by
    ``explicit_no_stroke_weight``). ``points_per_stroke``: (B, M_gt,
    N_gt·outdim), −100-padded within strokes. The cost is
    Σ m·p² − 2 Σ m·p·g + Σ m·g², as the JAX package computes it, so
    that the assignment sees the same costs to rounding."""
    B, M_pred, _ = pred_points_per_stroke.shape
    M_gt, D_gt = points_per_stroke.shape[1], points_per_stroke.shape[2]

    pred_trunc = pred_points_per_stroke[:, :, :D_gt]
    fake = torch.isclose(points_per_stroke,
                         torch.full_like(points_per_stroke, PAD))
    gt0 = torch.where(fake, 0.0, points_per_stroke)
    m = (~fake).to(pred_trunc.dtype)
    p2 = torch.einsum("bid,bkd->bik", pred_trunc ** 2, m)
    cross = torch.einsum("bid,bkd->bik", pred_trunc, m * gt0)
    g2 = (gt0 ** 2).sum(-1)[:, None, :]
    cost = p2 - 2.0 * cross + g2

    row4col, matched = hungarian(cost, gt_stroke_mask)

    chosen = _take_rows(pred_trunc, row4col)
    per_col = _masked_mse_rows(chosen, points_per_stroke)
    total = torch.clamp(matched.sum(), min=1)
    masked_mse = torch.where(matched, per_col, 0.0).sum() / total

    # per-point confidence: the matched GT stroke's point validity, 0
    # beyond the GT's point budget
    n_pred_pts = pred_point_scores.shape[-1]
    gt_point_fake = torch.all(
        points_per_stroke.reshape(B, M_gt, -1, outdim) == PAD, dim=-1)
    n_gt_points = gt_point_fake.shape[-1]
    targets = (~gt_point_fake).to(torch.float32)
    if n_pred_pts > n_gt_points:
        targets = functional.pad(targets, (0, n_pred_pts - n_gt_points))
    targets = targets[..., :n_pred_pts]
    chosen_scores = _take_rows(pred_point_scores, row4col)
    point_bce = bce_with_logits(chosen_scores, targets).sum(-1)
    point_conf = torch.where(matched, point_bce, 0.0).sum() / total

    assigned = _assigned(row4col, matched, M_pred)
    w = torch.where(assigned > 0, 1.0, weights["explicit_no_stroke_weight"])
    stroke_conf = (w * bce_with_logits(pred_stroke_scores, assigned)).mean()

    return (weights["explicit_weight_masked_mse_loss"] * masked_mse
            + weights["explicit_weight_point_confidence_loss"] * point_conf
            + weights["explicit_weight_stroke_confidence_loss"]
            * stroke_conf)


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


def hungarian_sops(sop_pred, sop_gt, pred_sop_conf_scores, weights,
                   sop_mask=None, **_):
    """Start-of-path tokens matched one to one to the real GT tokens at
    least total euclidean cost, the mean squared error over the matched
    pairs, plus ``explicit_weight_sop_confidence_loss`` × the per-token
    confidence BCE (unmatched tokens weighted by
    ``explicit_no_sop_weight``). Needs at least as many predicted tokens as
    real GT tokens: with more, a real token matched to a fake row makes the
    loss NaN, as in the JAX package, whose term has no guard either."""
    if sop_mask is None:
        sop_mask = mask_from_padding(sop_gt)
    row4col, matched = hungarian(euclid_cdist(sop_pred, sop_gt), sop_mask)
    chosen = _take_rows(sop_pred, row4col)
    per_col = ((chosen - torch.where(sop_mask[..., None], sop_gt, 0.0))
               ** 2).sum(-1)
    total = torch.clamp(matched.sum(), min=1)
    mse = torch.where(matched, per_col, 0.0).sum() / total

    assigned = _assigned(row4col, matched, sop_pred.shape[1])
    w = torch.where(assigned > 0, 1.0, weights["explicit_no_sop_weight"])
    conf = (w * bce_with_logits(pred_sop_conf_scores, assigned)).mean()
    return mse + weights["explicit_weight_sop_confidence_loss"] * conf
