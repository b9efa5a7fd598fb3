"""The stroke-mask loss and the four composites built on it: the
MaskPlanner v6 loss, its v11 variant, the symmetric v1 loss and the
baselines' symmetric segment chamfer with stroke masks
(``maskplanner_tpu/losses/mask_losses.py``).

Dense one-hot target masks, a BCE (or MSE) cost matrix and the batched
Hungarian match (``ops.hungarian``: the CUDA kernel on the card) take the
place of the reference's per-sample loops and host LAP.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.chamfer import (chamfer_distance, mask_from_padding,
                           nearest_sq_distance)
from ..ops.hungarian import hungarian
from ..parallel import batch_count
from .chamfer_losses import (reverse_asymm_point_chamfer,
                             reverse_asymm_segment_chamfer,
                             symm_point_chamfer)
from .common import (at_least_f32, bce_with_logits,
                     segment_distance_to_confidence)


def per_segment_confidence_loss(nn_distance, seg_logits, weights):
    """Confidence regression to a distance-derived target."""
    targets = segment_distance_to_confidence(nn_distance)
    loss = ((seg_logits - targets) ** 2).sum(-1).mean()
    return weights["explicit_weight_segments_confidence"] * loss


def stroke_masks_loss(pred_to_gt_match, pred_stroke_masks, scores,
                      stroke_ids, weights, nn_distance=None,
                      smooth_targets=False):
    """Hungarian-matched stroke-mask loss.

    pred_to_gt_match (B, S_pred) NN GT-segment index of each predicted
    segment; pred_stroke_masks (B, M, S_pred) logits; scores (B, M) mask
    confidence logits; stroke_ids (B, S_gt) GT stroke ids, −1 padded. Each
    predicted segment adopts the stroke id of its nearest GT segment; the
    per-stroke target masks that occur are matched to the predicted masks by
    a BCE (or, with ``smooth_targets``, MSE) cost; matched masks get a
    BCE/MSE loss and every mask confidence a BCE, unmatched ones weighted by
    ``explicit_no_stroke_weight``."""
    B, M, S_pred = pred_stroke_masks.shape
    x = at_least_f32(pred_stroke_masks)
    target_ids = torch.gather(stroke_ids, 1, pred_to_gt_match.long())
    ks = torch.arange(M, device=x.device)
    tgt_binary = target_ids[:, None, :] == ks[None, :, None]   # (B, M, S)
    col_valid = tgt_binary.any(-1)                               # (B, M)

    if smooth_targets:
        conf = segment_distance_to_confidence(nn_distance)      # (B, S)
        tgt = torch.where(tgt_binary, conf[:, None, :], 0.0)
        x2 = (x ** 2).sum(-1)
        t2 = (tgt ** 2).sum(-1)
        cross = torch.einsum("bis,bks->bik", x, tgt)
        cost = x2[:, :, None] - 2.0 * cross + t2[:, None, :]
    else:
        tgt = tgt_binary.to(x.dtype)
        a = (torch.clamp(x, min=0.0)
             + torch.log1p(torch.exp(-torch.abs(x)))).sum(-1)
        cross = torch.einsum("bis,bks->bik", x, tgt)
        cost = a[:, :, None] - cross

    row4col, matched = hungarian(cost.detach(), col_valid)      # (B, M)

    chosen = torch.gather(x, 1, row4col[..., None].expand(-1, -1, S_pred))
    if smooth_targets:
        per_col = ((chosen - tgt) ** 2).sum(-1)
    else:
        per_col = bce_with_logits(chosen, tgt).sum(-1)
    # over the global batch in a data-parallel step (``parallel``)
    total_matched = batch_count(matched.sum(), 1)
    mask_loss = torch.where(matched, per_col, 0.0).sum() / total_matched

    # 1 where predicted mask i was matched to a real target
    assigned = (F.one_hot(row4col, M).float() * matched[..., None].float()) \
        .sum(1).clamp(0.0, 1.0)
    w = torch.where(assigned > 0, 1.0, weights["explicit_no_stroke_weight"])
    conf_loss = (w * bce_with_logits(at_least_f32(scores), assigned)).mean()
    return (weights["explicit_weight_stroke_masks"] * mask_loss
            + weights["explicit_weight_stroke_masks_confidence"] * conf_loss)


def _forward_segment_chamfer_with_matching(y_pred, y, y_mask):
    """Unreduced forward segment chamfer + matching indices: the values of
    ``chamfer_distance(y_pred, y, padded=True, y_mask=y_mask,
    asymmetric=True, return_matching=True, point_reduction=None,
    batch_reduction=None)``, whose reverse matching this loss does not use,
    so only the forward direction is searched."""
    if y_mask is None:
        y_mask = mask_from_padding(y)
    return nearest_sq_distance(y_pred, y, y_mask)  # (B, S_pred), (B, S_pred)


def asymm_v6_chamfer_with_stroke_masks(
        y_pred, y, pred_stroke_masks, mask_scores, seg_logits, stroke_ids,
        traj_as_pc, outdim, weights, y_mask=None, pc_mask=None,
        per_segment_confidence=False, smooth_targets=False, **_):
    """The MaskPlanner loss: forward segment chamfer (+ per-segment
    confidence) + reverse point chamfer + reverse segment chamfer +
    stroke-mask loss."""
    nn_dist, match = _forward_segment_chamfer_with_matching(y_pred, y, y_mask)
    fwd = 100.0 * nn_dist.mean()
    seg_conf = (per_segment_confidence_loss(nn_dist, seg_logits, weights)
                if per_segment_confidence else 0.0)
    rev_point = reverse_asymm_point_chamfer(y_pred, traj_as_pc, outdim,
                                            pc_mask=pc_mask)
    rev_seg = reverse_asymm_segment_chamfer(y_pred, y, y_mask=y_mask)
    masks = stroke_masks_loss(match, pred_stroke_masks, mask_scores,
                              stroke_ids, weights, nn_distance=nn_dist,
                              smooth_targets=smooth_targets)
    return (weights["weight_asymm_segment_chamfer"] * fwd
            + seg_conf
            + weights["weight_reverse_asymm_point_chamfer"] * rev_point
            + weights["weight_reverse_asymm_segment_chamfer"] * rev_seg
            + masks)


def asymm_v11_chamfer_with_stroke_masks(
        y_pred, y, pred_stroke_masks, mask_scores, seg_logits, stroke_ids,
        traj_as_pc, outdim, weights, y_mask=None, pc_mask=None,
        per_segment_confidence=False, smooth_targets=False, **_):
    """The v6 loss without its reverse segment term."""
    nn_dist, match = _forward_segment_chamfer_with_matching(y_pred, y, y_mask)
    fwd = 100.0 * nn_dist.mean()
    seg_conf = (per_segment_confidence_loss(nn_dist, seg_logits, weights)
                if per_segment_confidence else 0.0)
    rev_point = reverse_asymm_point_chamfer(y_pred, traj_as_pc, outdim,
                                            pc_mask=pc_mask)
    masks = stroke_masks_loss(match, pred_stroke_masks, mask_scores,
                              stroke_ids, weights, nn_distance=nn_dist,
                              smooth_targets=smooth_targets)
    return (weights["weight_asymm_segment_chamfer"] * fwd
            + seg_conf
            + weights["weight_reverse_asymm_point_chamfer"] * rev_point
            + masks)


def _symmetric_segment_chamfer_with_matching(y_pred, y, y_mask):
    """The symmetric segment chamfer and each predicted segment's nearest
    GT segment (both directions searched)."""
    dist, _, match, _ = chamfer_distance(y_pred, y, padded=True,
                                         y_mask=y_mask, return_matching=True)
    return dist, match


def symm_v1_chamfer_with_stroke_masks(
        y_pred, y, pred_stroke_masks, mask_scores, stroke_ids, traj_as_pc,
        outdim, weights, y_mask=None, pc_mask=None, **_):
    """Symmetric segment chamfer + symmetric point chamfer + stroke-mask
    loss."""
    symm_seg, match = _symmetric_segment_chamfer_with_matching(y_pred, y,
                                                               y_mask)
    symm_point = symm_point_chamfer(y_pred, traj_as_pc, outdim,
                                    pc_mask=pc_mask)
    masks = stroke_masks_loss(match, pred_stroke_masks, mask_scores,
                              stroke_ids, weights)
    return (weights["weight_symm_segment_chamfer"] * (100.0 * symm_seg)
            + weights["weight_symm_point_chamfer"] * symm_point
            + masks)


def chamfer_with_stroke_masks(y_pred, y, pred_stroke_masks, mask_scores,
                              stroke_ids, weights, y_mask=None, **_):
    """The baselines' loss (``segmentWise``, ``pointWise``): symmetric
    segment chamfer + stroke-mask loss."""
    cham, match = _symmetric_segment_chamfer_with_matching(y_pred, y, y_mask)
    masks = stroke_masks_loss(match, pred_stroke_masks, mask_scores,
                              stroke_ids, weights)
    return 100.0 * cham + masks
