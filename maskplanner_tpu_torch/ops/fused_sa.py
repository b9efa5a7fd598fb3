"""One fused PointNet++ set-abstraction level, forward and backward.

Counterpart of ``maskplanner_tpu/ops/pallas/fused_sa_train.py``: first-K
ball query -> gather ``[x - q ; f]`` (offsets first) -> per-point MLP
(Dense, LayerNorm with eps 1e-6 or no norm, ReLU) -> max over K. A CUDA
tensor goes through :class:`FusedSALevel`, whose forward and backward are
the kernels of ``ops/cuda/fused_sa.py``; a CPU tensor goes to
:func:`fused_sa_forward_plain`, and autograd through it gives the gradient.
:func:`fused_sa_backward_plain` is the backward in the kernels'
decomposition, and :func:`tf32_split` / :func:`matmul_3xtf32` emulate
the 3xTF32 tensor-core products of both directions' kernels; the tests
hold both against the JAX package and against autograd.

``precision="bf16"`` is the JAX package's ``precision="default"`` mode,
which bf16 models serve with: the feature rows are gathered rounded to
bf16, and every layer product takes both operands rounded to bf16 (round
to nearest even) with f32 sums (:func:`matmul_bf16`); the offsets
``x − q``, the bias, the LayerNorm, the ReLU and the max stay f32. It is
forward only: bf16 training is not ported.

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


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even), kept in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the bf16 tensor cores form it: both operands rounded to
    bf16, the exact products summed in the inputs' dtype (f32 for the
    kernel's f32 accumulators)."""
    return bf16_round(a) @ bf16_round(b)


PRODUCTS = {"f32": torch.matmul, "bf16": matmul_bf16}


def _gather_plain(xyz, new_xyz, features, idx):
    """The neighbour rows ``[x - q ; f]`` (B, S, K, 3 + F)."""
    h = index_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is not None:
        h = torch.cat([h, index_points(features, idx)], dim=-1)
    return h


def _mlp_plain(h, params, norm: str, product=torch.matmul) -> list:
    """The per-point MLP on rows ``h`` -> per layer (input, xhat, inv,
    activation); xhat and inv (the LayerNorm's normalised value and inverse
    std) are None without a norm. ``product(h, wᵀ)`` forms each Dense
    layer's product; the tests pass :func:`matmul_3xtf32` to emulate the
    kernels' tensor-core product."""
    layers = []
    for layer in params:
        inp = h
        h = product(h, layer[0].t()) + layer[1]
        xhat = inv = None
        if norm == "layer":
            mu = h.mean(-1, keepdim=True)
            var = ((h - mu) ** 2).mean(-1, keepdim=True)
            inv = torch.rsqrt(var + LAYER_NORM_EPS)
            xhat = (h - mu) * inv
            h = xhat * layer[2] + layer[3]
        h = torch.relu(h)
        layers.append((inp, xhat, inv, h))
    return layers


def fused_sa_forward_plain(radius: float, nsample: int, norm: str,
                           xyz: torch.Tensor, new_xyz: torch.Tensor,
                           features: torch.Tensor | None, params,
                           precision: str = "f32"):
    """Plain version: the same level as separate PyTorch ops. In bf16 the
    feature rows are gathered rounded to bf16 and every product is
    :func:`matmul_bf16`."""
    idx = ball_query_plain(radius, nsample, xyz, new_xyz)        # (B, S, K)
    if precision == "bf16" and features is not None:
        features = bf16_round(features)
    layers = _mlp_plain(_gather_plain(xyz, new_xyz, features, idx), params,
                        norm, PRODUCTS[precision])
    return layers[-1][3].amax(dim=2), idx


def tf32_split(x: torch.Tensor):
    """``x`` -> (hi, lo), both TF32 values (10-bit mantissa) in float32:
    hi is ``x`` rounded to nearest (ties away from zero, as
    ``cvt.rna.tf32.f32``) on the int32 view, lo the rounded remainder. The
    3xTF32 product a·b ~ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi is what the
    kernels' ``mma.sync`` products compute (every layer product of the
    forward and of the backward's recompute, the backward's input and
    weight gradients)."""
    def rna(t):
        return ((t.contiguous().view(torch.int32) + 0x1000) & -0x2000) \
            .view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the tensor cores form it in 3xTF32: three products of
    the TF32 parts, each summed in float32."""
    a_hi, a_lo = tf32_split(a)
    b_hi, b_lo = tf32_split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def split_sum(parts) -> torch.Tensor:
    """Partial sums added one after another in the given order."""
    total = None
    for p in parts:
        total = p if total is None else total + p
    return total


def fused_sa_backward_plain(nsample: int, norm: str, xyz: torch.Tensor,
                            new_xyz: torch.Tensor,
                            features: torch.Tensor | None, params,
                            idx: torch.Tensor, pooled: torch.Tensor,
                            d_pooled: torch.Tensor,
                            needs=(True, True, True), splits: int = 1):
    """The level's backward in the kernels' decomposition
    (``csrc/fused_sa_bwd.cu`` then ``csrc/sa_weight_grad.cu``), from the
    forward's ``idx`` and ``pooled``:

    1. recompute every layer from the re-gathered rows;
    2. route ``d_pooled[c]`` to the FIRST neighbour whose last activation
       is >= ``pooled[c]`` (and > 0: the ReLU);
    3. per layer, last to first: the LayerNorm backward, then the rows the
       weight gradient needs, ``d_pre`` (rows, C_out) and the layer's input
       (rows, C_in), then the input gradient ``d_pre · W`` masked by the
       previous activation's ReLU;
    4. dW = Σ d_preᵀ · in, db = Σ d_pre, dgamma = Σ d_act · xhat,
       dbeta = Σ d_act, each over ``splits`` contiguous row ranges summed
       in range order;
    5. d_xyz, d_new_xyz and d_features from layer 0's input gradient, each
       only where ``needs`` (xyz, new_xyz, features) asks for it.

    -> (d_xyz or None, d_new_xyz or None, d_features or None, per-layer
    gradients shaped like ``params``). ``nsample`` is the K of ``idx``."""
    if idx.shape[-1] != nsample:
        raise ValueError(f"idx must hold {nsample} neighbours a query")
    x = _gather_plain(xyz, new_xyz, features, idx)
    layers = _mlp_plain(x, params, norm)
    act = layers[-1][3]
    hit = act >= pooled[:, :, None, :]
    first = hit & (hit.int().cumsum(2) == 1)
    d = torch.where(first & (act > 0), d_pooled[:, :, None, :], 0.0)
    rows = d.shape[0] * d.shape[1] * d.shape[2]
    step = -(-rows // splits)

    def fixed_order(fn, *ts):
        flat = [t.reshape(rows, t.shape[-1]) for t in ts]
        return split_sum(fn(*(t[r:r + step] for t in flat))
                         for r in range(0, rows, step))

    grads = [None] * len(params)
    need_in = any(needs)
    for l in range(len(params) - 1, -1, -1):
        inp, xhat, inv, _ = layers[l]
        w = params[l][0]
        extra = ()
        if norm == "layer":
            extra = (fixed_order(lambda a, b: (a * b).sum(0), d, xhat),
                     fixed_order(lambda a: a.sum(0), d))
            dx = d * params[l][2]
            d = inv * (dx - dx.mean(-1, keepdim=True)
                       - xhat * (dx * xhat).mean(-1, keepdim=True))
        grads[l] = (fixed_order(lambda a, b: a.t() @ b, d, inp),
                    fixed_order(lambda a: a.sum(0), d), *extra)
        if l > 0:
            d = torch.where(layers[l - 1][3] > 0, d @ w, 0.0)
        elif need_in:
            d = d @ w
    d_xyz = d_new = d_feat = None
    if need_in:
        B, N, _ = xyz.shape
        flat = (idx.long() + N * torch.arange(B, device=idx.device)
                [:, None, None]).reshape(-1)
        if needs[0]:
            d_xyz = torch.zeros(B * N, 3, dtype=d.dtype, device=d.device) \
                .index_add_(0, flat, d[..., :3].reshape(-1, 3)) \
                .view(B, N, 3)
        if needs[1]:
            d_new = -d[..., :3].sum(2)
        if needs[2] and features is not None:
            F = features.shape[-1]
            d_feat = torch.zeros(B * N, F, dtype=d.dtype, device=d.device) \
                .index_add_(0, flat, d[..., 3:].reshape(-1, F)) \
                .view(B, N, F)
    return d_xyz, d_new, d_feat, [tuple(g) for g in grads]


class FusedSALevel(torch.autograd.Function):
    """The level on the card with kernels for each direction. The forward
    saves the neighbour indices and the pooled output; the backward
    recomputes the activations from them (``csrc/fused_sa_bwd.cu``) and
    forms the weight gradients from the rows it writes
    (``csrc/sa_weight_grad.cu``).

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
        from .cuda.fused_sa import fused_sa_backward_cuda

        nsample, layer_norm, n_per = ctx.level
        xyz, new_xyz, features, idx, pooled, *flat = ctx.saved_tensors
        params = [flat[i:i + n_per] for i in range(0, len(flat), n_per)]
        # only the input gradients autograd asks for (the points and the
        # FPS centroids of a step carry none)
        d_xyz, d_new, d_feat, d_params = fused_sa_backward_cuda(
            nsample, layer_norm, xyz, new_xyz, features, params, idx, pooled,
            d_pooled.contiguous(), needs=ctx.needs_input_grad[3:6])
        return (None, None, None, d_xyz, d_new, d_feat, None,
                *(g for layer in d_params for g in layer))


def fused_sa_forward(radius: float, nsample: int, norm: str,
                     xyz: torch.Tensor, new_xyz: torch.Tensor,
                     features: torch.Tensor | None, params,
                     precision: str = "f32"):
    """One SA level -> (pooled (B, S, C_last) f32, idx (B, S, K) int32),
    differentiable in xyz, new_xyz, features and params (the neighbour
    selection is piecewise constant, like every ball query).

    xyz (B, N, 3); new_xyz (B, S, 3), the FPS centroids; features (B, N, F)
    or None; params: per layer ``(w (C_out, C_in), b)``, plus
    ``(gamma, beta)`` when ``norm == "layer"``. ``precision``: "f32" or
    "bf16" (the bf16 models' serving mode: on the card forward only, and a
    call that would need a gradient raises)."""
    if norm not in ("layer", "none"):
        raise ValueError(f"the fused level takes norm 'layer' or 'none', "
                         f"got {norm!r}")
    if precision not in PRODUCTS:
        raise ValueError(f"precision must be 'f32' or 'bf16', got "
                         f"{precision!r}")
    if xyz.device.type == "cuda":
        n_per = 4 if norm == "layer" else 2
        flat = [a for layer in params for a in layer]
        if any(len(layer) != n_per for layer in params):
            raise ValueError("a layer is (w, b, gamma, beta) with LayerNorm, "
                             "(w, b) without")
        if precision == "f32":
            return FusedSALevel.apply(radius, nsample, norm == "layer", xyz,
                                      new_xyz, features, n_per, *flat)
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (xyz, new_xyz, features, *flat)):
            raise NotImplementedError(
                "the bf16 fused SA level has no backward: bf16 training is "
                "not ported yet (ROADMAP.md, Queue 1)")
        from .cuda.fused_sa import fused_sa_bf16_cuda

        return fused_sa_bf16_cuda(radius, nsample, norm == "layer", xyz,
                                  new_xyz, features, params)
    if xyz.device.type == "cpu":
        return fused_sa_forward_plain(radius, nsample, norm, xyz, new_xyz,
                                      features, params, precision)
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
