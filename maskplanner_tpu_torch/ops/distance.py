"""Pairwise squared distances (``maskplanner_tpu/ops/distance.py``).

The port computes them in the JAX package's fixed-order elementwise form
(its ``MASKPLANNER_DETERMINISTIC_NN`` branch): each entry is
``((d0*d0) + (d1*d1)) + (d2*d2)`` of coordinate differences, with no
matmul expansion and no fused multiply-add. That is how the CUDA kernels
form distances too, so the plain versions and the kernels make identical
in-radius decisions, bit for bit.

:func:`square_distance_expanded` is the JAX package's other form (its
default, on a TPU): ``|x|² − 2 x·y + |y|²`` with the cross term one batched
matmul. The port takes it only for the kNN in feature space
(``models.dgcnn``), where the fixed-order form would make D passes over
the (B, N, N) distances.
"""
from __future__ import annotations

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., N, D), (..., M, D) -> (..., N, M) float32 squared distances."""
    src = src.float()
    dst = dst.float()
    acc = None
    for d in range(src.shape[-1]):
        diff = src[..., :, None, d] - dst[..., None, :, d]
        term = diff * diff
        acc = term if acc is None else acc + term
    return acc


def square_distance_expanded(src: torch.Tensor,
                             dst: torch.Tensor) -> torch.Tensor:
    """(..., N, D), (..., M, D) -> (..., N, M) squared distances as
    ``(|x|² − 2 x·y) + |y|²``, the cross term a batched matmul, in float32
    (float64 inputs stay float64; PyTorch keeps TF32 off for matmuls
    unless it is switched on)."""
    dtype = torch.promote_types(src.dtype, torch.float32)
    src = src.to(dtype)
    dst = dst.to(dtype)
    cross = torch.matmul(src, dst.transpose(-1, -2))
    s2 = (src * src).sum(-1, keepdim=True)
    d2 = (dst * dst).sum(-1, keepdim=True)
    return s2 - 2.0 * cross + d2.transpose(-1, -2)


def smallest_k(d: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row of ``d`` in ascending order,
    ties to the lower index (``jax.lax.top_k(-d, k)``'s order; ``torch.topk``
    promises none) -> (values (..., k), indices (..., k) int64). ``k``
    masked argmins on one copy of ``d``, each pass masking the column it
    took; the values are gathered from ``d``, so the gradient flows to the
    chosen entries."""
    rest = d.detach().clone() if k > 1 else d.detach()
    picked = []
    for i in range(k):
        idx = torch.argmin(rest, dim=-1, keepdim=True)
        picked.append(idx)
        if i + 1 < k:
            rest.scatter_(-1, idx, torch.inf)
    idx = torch.cat(picked, dim=-1)
    return d.gather(-1, idx), idx
