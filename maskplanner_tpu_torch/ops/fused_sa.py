"""One fused PointNet++ set-abstraction level, forward only.

Counterpart of ``maskplanner_tpu/ops/pallas/fused_sa_train.py``'s forward:
first-K ball query -> gather ``[x - q ; f]`` (offsets first) -> per-point
MLP (Dense, LayerNorm with eps 1e-6 or no norm, ReLU) -> max over K. A CUDA
tensor goes to the kernel (``ops/cuda/fused_sa.py``), a CPU tensor to
:func:`fused_sa_forward_plain`.

This slice has no backward: asking for a gradient raises, so that nothing
trains through the level silently.
"""
from __future__ import annotations

import torch

from .sampling import index_points, query_ball_point

LAYER_NORM_EPS = 1e-6


def fused_sa_forward_plain(radius: float, nsample: int, norm: str,
                           xyz: torch.Tensor, new_xyz: torch.Tensor,
                           features: torch.Tensor | None, params):
    """Plain version: the same level as separate PyTorch ops."""
    idx = query_ball_point(radius, nsample, xyz, new_xyz)        # (B, S, K)
    h = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is not None:
        h = torch.cat([h, index_points(features, idx)], dim=-1)
    for layer in params:
        h = torch.matmul(h, layer[0].t()) + layer[1]
        if norm == "layer":
            mu = h.mean(-1, keepdim=True)
            var = ((h - mu) ** 2).mean(-1, keepdim=True)
            h = (h - mu) * torch.rsqrt(var + LAYER_NORM_EPS) * layer[2] \
                + layer[3]
        h = torch.relu(h)
    return h.amax(dim=2), idx


def fused_sa_forward(radius: float, nsample: int, norm: str,
                     xyz: torch.Tensor, new_xyz: torch.Tensor,
                     features: torch.Tensor | None, params):
    """One SA level -> (pooled (B, S, C_last) f32, idx (B, S, K) int32).

    xyz (B, N, 3); new_xyz (B, S, 3), the FPS centroids; features (B, N, F)
    or None; params: per layer ``(w (C_out, C_in), b)``, plus
    ``(gamma, beta)`` when ``norm == "layer"``."""
    if norm not in ("layer", "none"):
        raise ValueError(f"the fused level takes norm 'layer' or 'none', "
                         f"got {norm!r}")
    operands = [xyz, new_xyz, features, *(a for layer in params
                                          for a in layer)]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError("fused_sa_forward has no backward yet: run it "
                           "under torch.no_grad() or torch.inference_mode()")
    if xyz.device.type == "cuda":
        from .cuda.fused_sa import fused_sa_cuda

        return fused_sa_cuda(radius, nsample, norm == "layer", xyz, new_xyz,
                             features, params)
    if xyz.device.type == "cpu":
        return fused_sa_forward_plain(radius, nsample, norm, xyz, new_xyz,
                                      features, params)
    raise ValueError(f"no fused SA level for device {xyz.device}")
