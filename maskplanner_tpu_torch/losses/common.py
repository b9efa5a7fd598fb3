"""Shared numerics of the loss terms (``maskplanner_tpu/losses/common.py``)."""
from __future__ import annotations

import torch


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


def segment_distance_to_confidence(distance: torch.Tensor) -> torch.Tensor:
    """A segment distance -> a confidence in [0, 1] (constants c=2.17,
    d=−4.63 of the reference's transform)."""
    c, d = 2.17, -4.63
    logd = torch.log10(torch.clamp(distance, min=1e-12))
    return 1.0 - 1.0 / (1.0 + torch.exp(-c * logd + d))
