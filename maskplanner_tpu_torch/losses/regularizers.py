"""The geometric regularizers (``maskplanner_tpu/losses/regularizers.py``):
repulsion, align, intra-align, velcosine and mse, and the segmenters'
contrastive loss ``contrastive_v1``.

The neighbour searches take the k smallest distances with ties to the
lower index (``ops.distance.smallest_k``), as ``jax.lax.top_k`` orders
them; the singular values are ``torch.linalg.svdvals``.
"""
from __future__ import annotations

import math

import torch

from ..ops.chamfer import mask_from_padding
from ..ops.distance import smallest_k
from .common import euclid_cdist, masked_mean

_BIG = 1e10


def _knn(points: torch.Tensor, k: int):
    """(B, N, 3) -> the distances (B, N, k+1) to each point's k+1 nearest
    points, itself first, and their indices."""
    return smallest_k(euclid_cdist(points, points), k + 1)


def _gather_neighbours(values: torch.Tensor, idx: torch.Tensor):
    """values (B, N, C), idx (B, N, K) -> (B, N, K, C) rows of values."""
    B, N, K = idx.shape
    flat = torch.take_along_dim(values, idx.reshape(B, N * K, 1), dim=1)
    return flat.reshape(B, N, K, values.shape[-1])


def mean_knn_distance(points: torch.Tensor, k: int,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B,) per cloud the mean over its (valid) points of each point's
    mean distance to its k nearest other (valid) points, each distance
    clamped at 1e-12."""
    d = euclid_cdist(points, points)
    eye = torch.eye(points.shape[1], dtype=torch.bool, device=points.device)
    d = torch.where(eye[None], _BIG, d)
    if mask is not None:
        d = torch.where(mask[:, None, :], d, _BIG)
    top, _ = smallest_k(d, k)
    per_point = torch.clamp(top, min=1e-12).mean(-1)          # (B, N)
    if mask is not None:
        return masked_mean(per_point, mask, dim=-1)
    return per_point.mean(-1)


def repulsion(y_pred, y, outdim, knn_repulsion=1, rep_target=None,
              lambda_points=1, y_mask=None, **_):
    """Gaussian-weighted repulsion from each predicted position's
    ``knn_repulsion`` nearest ×100 (the positions of every pose at λ > 1,
    the segments' first 3 values at λ = 1). The bandwidth is
    ``rep_target`` · √2, else the GT's own mean kNN distance · √2 (over the
    GT segments' first positions; without ``y_mask`` the mask comes from
    the padding at λ > 1 only, none at λ = 1, as in the JAX package)."""
    B = y_pred.shape[0]
    pts = (y_pred.reshape(B, -1, outdim) if lambda_points > 1
           else y_pred)[:, :, :3]
    if rep_target is not None:
        h = torch.tensor(float(rep_target) * math.sqrt(2.0),
                         device=y_pred.device)
    else:
        gt_mask = y_mask
        if gt_mask is None and lambda_points > 1:
            gt_mask = mask_from_padding(y)
        target = mean_knn_distance(y[:, :, :3], knn_repulsion, mask=gt_mask)
        h = (target * math.sqrt(2.0))[:, None, None]
    top, _ = _knn(pts, knn_repulsion)
    top = torch.clamp(top[:, :, 1:], min=1e-12)            # drop the self
    weight = torch.exp(-(top ** 2) / (h ** 2))
    return 100.0 * (-top * weight).mean()


def align(y_pred, knn_repulsion=1, **_):
    """The variance each kNN neighbourhood (the point and its
    ``knn_repulsion`` nearest, of the segments' first positions) leaves
    outside its main direction: the sum of its singular values after the
    first, averaged."""
    pts = y_pred[:, :, :3]
    _, idx = _knn(pts, knn_repulsion)
    neigh = _gather_neighbours(pts, idx)                   # (B, N, k+1, 3)
    centered = neigh - neigh.mean(-2, keepdim=True)
    return torch.linalg.svdvals(centered)[..., 1:].sum(-1).mean()


def intra_align(y_pred, **_):
    """Per segment the third singular value of its centred λ-window, every
    3 values taken as a point, averaged: 0 for planar windows."""
    B, S, D = y_pred.shape
    data = y_pred.reshape(B, S, D // 3, 3)
    centered = data - data.mean(-2, keepdim=True)
    return torch.linalg.svdvals(centered)[..., 2].mean()


def velcosine(y_pred, knn_repulsion=1, **_):
    """Negative cosine similarity between each point's velocity (its values
    after the first 3) and the mean velocity of its ``knn_repulsion``
    nearest points."""
    pos, vel = y_pred[:, :, :3], y_pred[:, :, 3:]
    _, idx = _knn(pos, knn_repulsion)
    nn_vel = _gather_neighbours(vel, idx[:, :, 1:]).mean(-2)
    num = (vel * nn_vel).sum(-1)
    den = torch.clamp(torch.linalg.vector_norm(vel, dim=-1)
                      * torch.linalg.vector_norm(nn_vel, dim=-1), min=1e-6)
    return -(num / den).mean()


def mse(y_pred, y, **_):
    """Mean squared error."""
    return ((y_pred - y) ** 2).mean()


def contrastive_v1(latent_segments, stroke_ids, generator=None, margin=0.3,
                   balance_negatives=True, n_strokes_max=64, uniform=None,
                   **_):
    """Pairwise cosine contrastive loss over the latents (B, n, C) of the
    segments, whose strokes are ``stroke_ids`` (B, n): a pair of one
    stroke costs 1 − cos, a pair of two strokes relu(cos − ``margin``);
    the mean over all B·n·n pairs, the diagonal at 0. A stroke id of −1
    (padding), or one past ``n_strokes_max``, is a zero one-hot row (``jax.nn.one_hot``'s), so it pairs
    with nothing. With ``balance_negatives`` a pair of two strokes counts
    only where a uniform draw exceeds 1 − the share of same-stroke pairs
    in the whole padded tensor: ``uniform`` (B, n, n), else drawn from
    ``generator``."""
    B, n, _ = latent_segments.shape
    feat = latent_segments / torch.clamp(
        torch.linalg.vector_norm(latent_segments, dim=-1, keepdim=True),
        min=1e-12)
    pair_sim = torch.einsum("bic,bjc->bij", feat, feat)
    ids = stroke_ids.long()
    # an id outside [0, n_strokes_max) gets the extra class, dropped
    ids = torch.where((ids >= 0) & (ids < n_strokes_max), ids, n_strokes_max)
    one_hot = torch.nn.functional.one_hot(
        ids, n_strokes_max + 1)[..., :n_strokes_max].to(feat.dtype)
    pair_target = torch.einsum("bik,bjk->bij", one_hot, one_hot)
    cos_loss = (pair_target * (1.0 - pair_sim)
                + (1.0 - pair_target) * torch.relu(pair_sim - margin))
    positive = pair_target == 1
    if balance_negatives:
        if uniform is None:
            uniform = torch.rand(pair_target.shape, generator=generator,
                                 device=feat.device)
        pos_fraction = positive.to(feat.dtype).mean()
        sample_mask = positive | (uniform > 1 - pos_fraction)
    else:
        sample_mask = torch.ones_like(positive)
    diag = 1.0 - torch.eye(n, dtype=feat.dtype, device=feat.device)
    return (diag * sample_mask * cos_loss).mean()
