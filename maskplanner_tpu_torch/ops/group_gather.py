"""Ball query plus neighbourhood gather of one set-abstraction level.

Counterpart of ``maskplanner_tpu/ops/pallas/group_gather.py``
(``ball_group_pallas``): for each query, the first K in-radius neighbours'
rows ``[x − q ; f]`` (offsets first) and their indices. A CUDA tensor goes
through :class:`BallGroup`, whose forward is the kernel of
``ops/cuda/group_gather.py`` and whose backward is
:func:`ball_group_backward`; a CPU tensor goes to :func:`ball_group_plain`,
and autograd through it gives the gradient.

The backward is a scatter-add over the neighbour indices. The JAX package
computes it outside any Pallas kernel (``_ball_group_bwd``, a one-hot
contraction because XLA's scatter serialises on a TPU); here it is
PyTorch's ``index_add_``, the card's own scatter.

``single_pass=True`` is the JAX kernel's single-pass mode, which bf16
models group with: the row ``[bf16(x) − q ; bf16(f)]`` (the offsets
formed in f32), returned rounded to bf16, as the bf16 MLP that consumes
it rounds it. Its cotangent then arrives in bf16; the backward sums it in
f32, as the JAX package sums the same bf16 values.
"""
from __future__ import annotations

import torch

from . import library
from .fused_sa import bf16_round
from .sampling import ball_query_plain, index_points


def ball_group_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor,
                     features: torch.Tensor | None = None,
                     single_pass: bool = False):
    """Plain version: the ball query, then the gathers -> (grouped
    (B, S, K, 3 + F), idx (B, S, K) int32); single-pass: bf16 rows
    ``bf16(bf16(x) − q)`` and ``bf16(f)``."""
    idx = ball_query_plain(radius, nsample, xyz, new_xyz)
    x = index_points(xyz, idx)
    if single_pass:
        x = bf16_round(x)
    grouped = x - new_xyz[:, :, None, :]
    if features is not None:
        grouped = torch.cat([grouped, index_points(features, idx)], dim=-1)
    return (grouped.to(torch.bfloat16) if single_pass else grouped), idx


def ball_group_backward(idx: torch.Tensor, d_grouped: torch.Tensor, n: int,
                        need_xyz: bool, need_new: bool, need_feat: bool):
    """Gradients of the grouping from its indices (B, S, K) and the
    cotangent d_grouped (B, S, K, 3 + F) -> (d_xyz (B, n, 3), d_new_xyz
    (B, S, 3), d_features (B, n, F)), each None unless asked for: the
    offsets' and features' cotangents scatter-added over the flattened
    (B·n) source rows, and d_new_xyz = −Σ_K d_offsets; sums in f32 at
    least."""
    B, S, K, C = d_grouped.shape
    rows = (idx.long() + n * torch.arange(B, device=idx.device)[:, None, None])
    rows = rows.reshape(-1)
    # a bf16 cotangent (the single pass's) is summed in f32
    d_grouped = d_grouped.to(torch.promote_types(d_grouped.dtype,
                                                 torch.float32))

    def scatter(values: torch.Tensor) -> torch.Tensor:
        width = values.shape[-1]
        out = values.new_zeros((B * n, width))
        out.index_add_(0, rows, values.reshape(-1, width))
        return out.reshape(B, n, width)

    d_rel = d_grouped[..., :3]
    d_xyz = scatter(d_rel) if need_xyz else None
    d_new = -d_rel.sum(dim=2) if need_new else None
    d_feat = scatter(d_grouped[..., 3:]) if need_feat and C > 3 else None
    return d_xyz, d_new, d_feat


class BallGroup(torch.autograd.Function):
    """The grouping on the card: the kernel forward (its single pass with
    ``single_pass``) saves the indices, the backward scatters from them.
    ``apply(radius, nsample, xyz, new_xyz, features[, single_pass])`` ->
    (grouped, idx)."""

    @staticmethod
    def forward(ctx, radius, nsample, xyz, new_xyz, features,
                single_pass=False):
        from .cuda.group_gather import ball_group_cuda, ball_group_single_cuda

        group = ball_group_single_cuda if single_pass else ball_group_cuda
        grouped, idx = group(radius, nsample, xyz, new_xyz, features)
        ctx.n = xyz.shape[1]
        ctx.save_for_backward(idx)
        ctx.mark_non_differentiable(idx)
        return grouped, idx

    @staticmethod
    def backward(ctx, d_grouped, _d_idx):
        (idx,) = ctx.saved_tensors
        need_xyz, need_new, need_feat = ctx.needs_input_grad[2:5]
        d_xyz, d_new, d_feat = ball_group_backward(
            idx, d_grouped, ctx.n, need_xyz, need_new, need_feat)
        return None, None, d_xyz, d_new, d_feat, None


def ball_group(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor, features: torch.Tensor | None = None,
               single_pass: bool = False):
    """First-K in-radius grouping -> (grouped (B, S, K, 3 + F) f32 rows
    ``[x − q ; f]``, idx (B, S, K) int32), differentiable in xyz, new_xyz
    and features (the selection is piecewise constant).

    xyz (B, N, 3); new_xyz (B, S, 3), the FPS centroids; features
    (B, N, F) or None. ``single_pass``: bf16 rows for a bf16 consumer
    (see the module's docstring). Where autograd records nothing it calls
    the custom op ``maskplanner::ball_group`` or ``ball_group_single``
    (``ops.library``)."""
    if xyz.device.type in ("cuda", "cpu") and not library.needs_grad(
            xyz, new_xyz, features):
        op = library.ball_group_single if single_pass else library.ball_group
        return op(xyz, new_xyz, features, radius, nsample)
    if xyz.device.type == "cuda":
        return BallGroup.apply(radius, nsample, xyz, new_xyz, features,
                               single_pass)
    if xyz.device.type == "cpu":
        return ball_group_plain(radius, nsample, xyz, new_xyz, features,
                                single_pass)
    raise ValueError(f"no ball grouping for device {xyz.device}")
