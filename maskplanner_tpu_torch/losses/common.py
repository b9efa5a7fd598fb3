"""Shared numerics of the loss terms (``maskplanner_tpu/losses/common.py``)."""
from __future__ import annotations

import torch

from ..ops.distance import square_distance


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """Lower-precision floats to float32 (the JAX package's ``astype(f32)``
    at the loss boundary); float32 and float64 stay as they are."""
    return t if t.dtype in (torch.float32, torch.float64) else t.float()


def bce_with_logits(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits, in the JAX package's
    stable form ``max(x, 0) − x·t + log1p(exp(−|x|))``."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def masked_mean(values: torch.Tensor, mask: torch.Tensor,
                dim=None) -> torch.Tensor:
    """Mean over the entries where ``mask`` is True (over ``dim``, or all);
    0 where there is none."""
    if dim is None:
        dim = tuple(range(values.dim()))
    total = torch.where(mask, values, 0.0).sum(dim)
    return total / torch.clamp(mask.sum(dim), min=1)


def euclid_cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched euclidean (not squared) distance matrix, the square root of
    the fixed-order squared distances, clamped at 1e-24 first so that its
    gradient stays finite at 0."""
    return torch.sqrt(torch.clamp(square_distance(a, b), min=1e-24))


def segment_distance_to_confidence(distance: torch.Tensor) -> torch.Tensor:
    """A segment distance -> a confidence in [0, 1] (constants c=2.17,
    d=−4.63 of the reference's transform)."""
    c, d = 2.17, -4.63
    logd = torch.log10(torch.clamp(distance, min=1e-12))
    return 1.0 - 1.0 / (1.0 + torch.exp(-c * logd + d))
