"""One fused PointNet++ set-abstraction level, forward and backward.

Counterpart of ``maskplanner_tpu/ops/pallas/fused_sa_train.py``: first-K
ball query -> gather ``[x - q ; f]`` (offsets first) -> per-point MLP
(Dense, LayerNorm with eps 1e-6 or no norm, ReLU) -> max over K. A CUDA
tensor goes through :class:`FusedSALevel`, whose forward and backward are
the kernels of ``ops/cuda/fused_sa.py``; a CPU tensor goes to
:func:`fused_sa_forward_plain`, and autograd through it gives the gradient.

:func:`fused_set_abstraction` is the counterpart of
``maskplanner_tpu/ops/pallas/fused_sa.py``: a grouped BatchNorm level in
eval, its norm folded into the Dense weights (:func:`fold_pointmlp_params`).
Folded, a layer is Dense then ReLU, which is the fused level without a
norm; so on the card it launches the same forward kernel with
``norm="none"`` on the folded weights.
"""
from __future__ import annotations

import torch

from .sampling import ball_query_plain, index_points

LAYER_NORM_EPS = 1e-6


def fused_sa_forward_plain(radius: float, nsample: int, norm: str,
                           xyz: torch.Tensor, new_xyz: torch.Tensor,
                           features: torch.Tensor | None, params):
    """Plain version: the same level as separate PyTorch ops."""
    idx = ball_query_plain(radius, nsample, xyz, new_xyz)        # (B, S, K)
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


class FusedSALevel(torch.autograd.Function):
    """The level on the card with a kernel for each direction. The forward
    saves the neighbour indices and the pooled output; the backward
    recomputes the activations from them (``csrc/fused_sa_bwd.cu``).

    ``apply(radius, nsample, layer_norm, xyz, new_xyz, features, n_per,
    *flat_params)``: ``flat_params`` holds the layers' tensors in order,
    ``n_per`` of them a layer."""

    @staticmethod
    def forward(ctx, radius, nsample, layer_norm, xyz, new_xyz, features,
                n_per, *flat):
        from .cuda.fused_sa import fused_sa_cuda

        params = [flat[i:i + n_per] for i in range(0, len(flat), n_per)]
        pooled, idx = fused_sa_cuda(radius, nsample, layer_norm, xyz,
                                    new_xyz, features, params)
        ctx.level = (nsample, layer_norm, n_per)
        ctx.save_for_backward(xyz, new_xyz, features, idx, pooled, *flat)
        ctx.mark_non_differentiable(idx)
        return pooled, idx

    @staticmethod
    def backward(ctx, d_pooled, _d_idx):
        from .cuda.fused_sa import fused_sa_bwd_cuda

        nsample, layer_norm, n_per = ctx.level
        xyz, new_xyz, features, idx, pooled, *flat = ctx.saved_tensors
        params = [flat[i:i + n_per] for i in range(0, len(flat), n_per)]
        d_xyz, d_new, d_feat, d_params = fused_sa_bwd_cuda(
            nsample, layer_norm, xyz, new_xyz, features, params, idx, pooled,
            d_pooled.contiguous())
        return (None, None, None, d_xyz, d_new, d_feat, None,
                *(g for layer in d_params for g in layer))


def fused_sa_forward(radius: float, nsample: int, norm: str,
                     xyz: torch.Tensor, new_xyz: torch.Tensor,
                     features: torch.Tensor | None, params):
    """One SA level -> (pooled (B, S, C_last) f32, idx (B, S, K) int32),
    differentiable in xyz, new_xyz, features and params (the neighbour
    selection is piecewise constant, like every ball query).

    xyz (B, N, 3); new_xyz (B, S, 3), the FPS centroids; features (B, N, F)
    or None; params: per layer ``(w (C_out, C_in), b)``, plus
    ``(gamma, beta)`` when ``norm == "layer"``."""
    if norm not in ("layer", "none"):
        raise ValueError(f"the fused level takes norm 'layer' or 'none', "
                         f"got {norm!r}")
    if xyz.device.type == "cuda":
        n_per = 4 if norm == "layer" else 2
        flat = [a for layer in params for a in layer]
        if any(len(layer) != n_per for layer in params):
            raise ValueError("a layer is (w, b, gamma, beta) with LayerNorm, "
                             "(w, b) without")
        return FusedSALevel.apply(radius, nsample, norm == "layer", xyz,
                                  new_xyz, features, n_per, *flat)
    if xyz.device.type == "cpu":
        return fused_sa_forward_plain(radius, nsample, norm, xyz, new_xyz,
                                      features, params)
    raise ValueError(f"no fused SA level for device {xyz.device}")


def fold_pointmlp_params(mlp) -> list:
    """A BatchNorm ``PointMLP`` (``models.pointnet2``) in eval -> per layer
    ``(w (C_out, C_in), b (C_out,))`` with the running-statistics
    BatchNorm folded in, so that ``relu(h·wᵀ + b)`` is Dense -> BatchNorm
    (eval) -> ReLU: ``s = γ / sqrt(var + eps)``, ``w = W · s[:, None]``,
    ``b = (b_dense − mean) · s + β``
    (``maskplanner_tpu/ops/pallas/fused_sa.py::fold_pointmlp_params``)."""
    folded = []
    for conv, bn in zip(mlp.mlp_convs, mlp.mlp_bns):
        s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        folded.append((conv.weight * s[:, None],
                       (conv.bias - bn.running_mean) * s + bn.bias))
    return folded


def fused_set_abstraction(radius: float, nsample: int, xyz: torch.Tensor,
                          new_xyz: torch.Tensor,
                          features: torch.Tensor | None,
                          folded) -> torch.Tensor:
    """One eval-mode BatchNorm level on folded weights (``folded`` from
    :func:`fold_pointmlp_params`) -> pooled (B, S, C_last) f32: ball query,
    gather ``[x − q ; f]``, ``relu(h·wᵀ + b)`` per layer, max over K.
    Inference only: on the card the result carries no gradient, as the
    JAX kernel defines none.

    Layer 1 is formed as ``w·[x − q ; f] + b``, not as the TPU kernel's
    ``w·[x ; f] − w[:, :3]·q + b``: the two differ by the rounding of that
    reassociation, a few float32 ulps of the larger of |w·x| and |w·q|,
    and the two agree within 2e-5 · max|pooled| (with the TPU kernel's
    hi/lo gather; ``tests/test_torch_port_group.py``)."""
    if xyz.device.type == "cuda":
        from .cuda.fused_sa import folded_sa_cuda

        return folded_sa_cuda(radius, nsample, xyz, new_xyz, features,
                              folded)
    if xyz.device.type == "cpu":
        return fused_sa_forward_plain(radius, nsample, "none", xyz, new_xyz,
                                      features, folded)[0]
    raise ValueError(f"no fused SA level for device {xyz.device}")
