"""PointNet++ (SSG) building blocks (``maskplanner_tpu/models/pointnet2.py``).

Channel-last like the JAX package: xyz (B, N, 3), features (B, N, C). The
modules are named as in the original PyTorch repository
(``sa{i}.mlp_convs.{j}``, ``sa{i}.mlp_bns.{j}``), with ``mlp_lns.{j}`` for
the LayerNorm levels it did not have.

Train mode follows Flax: BatchNorm normalizes with the batch's biased
variance and moves its running statistics as ``0.9 running + 0.1 batch``
(:class:`FlaxBatchNorm1d`), FPS starts each cloud at a random index drawn
from an explicit ``torch.Generator`` (index 0 without one), and the heads'
dropout draws its mask from that generator.

``dtype=torch.bfloat16`` is the JAX package's bf16 model, under the dtype
rules of its accelerator path (the parameters stay f32 and are rounded
where they are used):

- a ``layer``/``none`` level runs the fused level's bf16 mode
  (``ops.fused_sa``: bf16 products, f32 sums, f32 LayerNorm), with its
  own backward in train;
- a grouped ``batch`` level, sa1 included, groups single-pass
  (``ops.group_gather``); in train it runs each Dense in bf16
  (:func:`dense`) and each BatchNorm in f32, then the max in f32; in eval
  the Dense/ReLU chain on the folded weights in bf16 (bf16 products with a
  bf16 output, a bf16 bias), then the max in f32;
- the ``group_all`` level runs in bf16 (Dense) and f32 (BatchNorm) in
  train, in f32 in eval;
- a head's Dense takes bf16 inputs and weights and gives bf16
  (:func:`dense`), its BatchNorm f32.
"""
from __future__ import annotations

import os
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional

from ..ops.fused_sa import (LAYER_NORM_EPS, fold_pointmlp_params,
                            fused_sa_forward)
from ..ops.group_gather import ball_group
from ..ops.sampling import (farthest_point_sample, index_points, knn,
                            query_ball_point)
from ..parallel import global_rows, local_rows, mean_over_ranks

BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.9  # Flax's: running = 0.9 running + 0.1 batch


def algebraic_batch_norm() -> bool:
    """Whether a train-mode BatchNorm ``PointMLP`` takes the algebraic
    path (:meth:`PointMLP.folded_bn_layer`): ``MASKPLANNER_ALGEBRAIC_BN``
    set, read at each call as the JAX package reads it (opt-in; off by
    default)."""
    return bool(os.environ.get("MASKPLANNER_ALGEBRAIC_BN"))


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (same parameters and buffers) whose train mode is
    Flax's ``nn.BatchNorm``: mean and variance over the rows, the variance
    as ``E[x²] − E[x]²`` clipped at 0 (biased), the output
    ``(x − mean) · (rsqrt(var + eps) · scale) + bias``, and the running
    statistics moved with momentum 0.9 by the biased variance
    (``nn.BatchNorm1d`` would use the unbiased one). Eval mode is
    ``nn.BatchNorm1d``'s: the running statistics.

    It computes in its parameters' dtype (f32). An input of another dtype
    (a bf16 Dense's output) is cast to it twice, for the statistics and for
    the normalisation, as Flax's ``BatchNorm`` casts it: in train mode its
    gradient then arrives as two parts, each rounded to the input's dtype,
    summed in that dtype.

    In a data-parallel step (``parallel.sharded_batch``) the two means are
    the global batch's (``parallel.mean_over_ranks``: the ranks' means
    over their equal row counts, averaged by one all-reduce whose backward
    averages the ranks' cotangents), as Flax's reduction over a sharded axis
    lowers to a psum."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.weight.dtype
        if not self.training:
            return super().forward(x.to(dtype))
        stats = x.to(dtype)
        mean = stats.mean(0)
        mean_sq = (stats * stats).mean(0)
        mean, mean_sq = mean_over_ranks(mean, mean_sq)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        self._track(mean, var)
        return (x.to(dtype) - mean) * (torch.rsqrt(var + self.eps)
                                       * self.weight) + self.bias

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Move the running statistics by the batch's moments."""
        with torch.no_grad():
            m = BATCH_NORM_MOMENTUM
            self.running_mean.mul_(m).add_((1.0 - m) * mean)
            self.running_var.mul_(m).add_((1.0 - m) * var)
            self.num_batches_tracked += 1

    def fold(self, mean: torch.Tensor, var: torch.Tensor) -> tuple:
        """Train mode on given batch moments (the algebraic path,
        ``maskplanner_tpu/models/pointnet2.py::_AlgebraicBatchNorm``): the
        running statistics moved as :meth:`forward` moves them -> the
        normalisation as a scale and a shift, ``(rsqrt(var + eps) · scale,
        bias − mean · that)``."""
        self._track(mean, var)
        inv = torch.rsqrt(var + self.eps) * self.weight
        return inv, self.bias - mean * inv


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout whose keep mask comes from ``generator`` (the
    global generator when None), drawn in f32 whatever ``x``'s dtype, over
    the global batch in a data-parallel step (``parallel.global_rows``),
    of which this rank keeps its rows; the identity in eval or at rate
    0."""
    if not training or rate == 0.0:
        return x
    shape = (global_rows(x.shape[0]), *x.shape[1:])
    keep = local_rows(torch.bernoulli(torch.full(shape, 1.0 - rate,
                                                 device=x.device),
                                      generator=generator))
    return x * keep.to(x.dtype) / (1.0 - rate)


def random_starts(xyz: torch.Tensor,
                  generator: torch.Generator | None) -> torch.Tensor | None:
    """(B,) random FPS start indices drawn from ``generator`` (over the
    global batch in a data-parallel step, of which this rank keeps its
    rows); None (start 0) without one."""
    if generator is None:
        return None
    B, N, _ = xyz.shape
    return local_rows(torch.randint(0, N, (global_rows(B),),
                                    generator=generator,
                                    device=generator.device)).to(xyz.device)


def batch_norm_rows(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` over the last axis of ``x`` (..., C), every other axis a row
    (Flax's ``BatchNorm`` on a channel-last tensor)."""
    return bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


def dense(linear: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``linear(x)`` computed in ``dtype``, as Flax's ``nn.Dense(dtype=...)``:
    in bf16 the input and the weight are rounded to bf16, the product (f32
    sums) gives bf16, and the bias is added in bf16."""
    if dtype == torch.float32:
        return linear(x)
    return functional.linear(x.to(dtype), linear.weight.to(dtype)) \
        + linear.bias.to(dtype)


class PointMLP(nn.Module):
    """Shared per-point MLP: Linear -> norm -> ReLU per layer, over the last
    axis. ``norm``: "batch" (:class:`FlaxBatchNorm1d` over all rows),
    "layer" (LayerNorm over channels, eps 1e-6 as in Flax) or "none".
    ``dtype``: the compute dtype of the Dense layers (:meth:`run_mlp`), of
    the folded chain (:meth:`run_folded`) and of a set-abstraction level's
    own path. Under ``MASKPLANNER_ALGEBRAIC_BN`` a train-mode BatchNorm MLP
    runs each layer as :meth:`folded_bn_layer`."""

    def __init__(self, in_channel: int, channels: Sequence[int], norm: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm not in ("batch", "layer", "none"):
            raise ValueError(f"unknown norm: {norm!r}")
        self.norm = norm
        self.dtype = dtype
        widths = [in_channel, *channels]
        self.mlp_convs = nn.ModuleList(
            nn.Linear(ci, co) for ci, co in zip(widths[:-1], widths[1:]))
        if norm == "batch":
            self.mlp_bns = nn.ModuleList(
                FlaxBatchNorm1d(c, eps=BATCH_NORM_EPS) for c in channels)
        elif norm == "layer":
            self.mlp_lns = nn.ModuleList(
                nn.LayerNorm(c, eps=LAYER_NORM_EPS) for c in channels)

    def run_mlp(self, x: torch.Tensor,
                dtype: torch.dtype | None = None) -> torch.Tensor:
        """Each layer's Dense in ``dtype`` (default: the module's;
        :func:`dense`), its norm in the parameters' dtype (f32), then the
        ReLU."""
        dtype = self.dtype if dtype is None else dtype
        algebraic = (self.norm == "batch" and self.training
                     and algebraic_batch_norm())
        for j, conv in enumerate(self.mlp_convs):
            if algebraic:
                x = self.folded_bn_layer(j, x, dtype)
                continue
            x = dense(conv, x, dtype)
            if self.norm == "batch":
                x = batch_norm_rows(self.mlp_bns[j], x)
            elif self.norm == "layer":
                ln = self.mlp_lns[j]
                x = ln(x.to(ln.weight.dtype))
            x = torch.relu(x)
        return x

    def folded_bn_layer(self, j: int, x: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
        """Layer ``j`` in train mode with algebraic batch statistics
        (``maskplanner_tpu/models/pointnet2.py::PointMLP._folded_bn_layer``):
        the moments of ``y = xW + b`` over the rows from the input's mean
        and Gram matrix (``mean_y = x̄W + b``, ``var_c = w_cᵀ Cov(x) w_c``,
        in the parameters' dtype, f32), the BatchNorm's scale and shift
        folded into the Dense weights (:meth:`FlaxBatchNorm1d.fold`), then
        one product in ``dtype`` and the ReLU: the pre-BatchNorm tensor is
        never formed, and the gradients flow through the moments. In a
        data-parallel step the mean and the Gram matrix are the global
        batch's (``parallel.mean_over_ranks``). The Gram product is a plain
        matmul, as the JAX package leaves it to XLA."""
        conv, bn = self.mlp_convs[j], self.mlp_bns[j]
        # f32: the parameters' dtype (a float64 twin computes in float64)
        stats = conv.weight.dtype
        dtype = stats if dtype == torch.float32 else dtype
        xl = x.to(dtype)
        w = conv.weight.t()                                 # (Cin, C)
        b = conv.bias
        # bf16 inputs multiply exactly into f32
        x2 = xl.reshape(-1, xl.shape[-1]).to(stats)         # (M, Cin)
        xbar = x2.mean(0)
        gram = torch.matmul(x2.t(), x2) / x2.shape[0]
        xbar, gram = mean_over_ranks(xbar, gram)
        cov = gram - torch.outer(xbar, xbar)
        mean_y = torch.matmul(xbar, w) + b
        var_y = torch.clamp((torch.matmul(cov, w) * w).sum(0), min=0.0)
        inv, shift = bn.fold(mean_y, var_y)
        wf = (w * inv[None, :]).to(dtype)
        # the Dense bias rides the shift; its gradient is 0 (it cancels
        # against its part of mean_y), as in the JAX package
        return torch.relu((torch.matmul(xl, wf) + (b * inv + shift))
                          .to(dtype))

    def pool(self, h: torch.Tensor) -> torch.Tensor:
        """The max over K of grouped rows, in the parameters' dtype (f32;
        the max of bf16 values is exact, so it is taken before the cast)."""
        return h.amax(dim=2).to(self.mlp_convs[0].weight.dtype)

    forward = run_mlp

    def run_folded(self, h: torch.Tensor) -> torch.Tensor:
        """The eval-mode BatchNorm MLP on grouped rows h (B, S, K, C) as a
        Dense/ReLU chain on the folded weights
        (``ops.fused_sa.fold_pointmlp_params``, f32) in ``dtype`` (bf16:
        bf16 products with a bf16 output, a bf16 bias), then the max over K
        -> (B, S, C_last) f32 (the max of bf16 values is exact, so it is
        taken before the cast)."""
        h = h.to(self.dtype)
        for w, b in fold_pointmlp_params(self):
            h = torch.relu(torch.matmul(h, w.t().to(self.dtype))
                           + b.to(self.dtype))
        return self.pool(h)

    def layer_params(self):
        """Per-layer ``(w (C_out, C_in), b[, gamma, beta])`` for the fused
        level."""
        layers = []
        for j, conv in enumerate(self.mlp_convs):
            layer = (conv.weight, conv.bias)
            if self.norm == "layer":
                layer += (self.mlp_lns[j].weight, self.mlp_lns[j].bias)
            layers.append(layer)
        return tuple(layers)


class SetAbstraction(PointMLP):
    """PointNet++ set-abstraction level, single-scale grouping.

    Grouped ``layer``/``none`` levels run as one fused level
    (``ops.fused_sa.fused_sa_forward``: the CUDA kernels on the card), in
    both modes. A grouped ``batch`` level groups with
    ``ops.group_gather.ball_group`` (the ball-group kernel on the card),
    then, as ``maskplanner_tpu/models/pointnet2.py`` does: in train, the MLP
    with batch statistics and the max over K; in eval with features (sa2),
    the Dense/ReLU chain with the BatchNorm folded into its weights
    (``ops.fused_sa.fold_pointmlp_params``) and the max; in eval without
    features (sa1), the MLP with running statistics and the max. The
    ``group_all`` level runs as plain ops. In bf16 see the module's
    docstring.

    With ``full_points`` (B, N, D) (``ball_in_xyz_space`` of
    ``models.pointnet2_seg``), FPS and the ball query (``query_ball_point``:
    the ball query kernel on the card) run on ``xyz`` in R³ and the grouped
    rows are the full vectors of those neighbours, as the JAX package
    groups them: not centred on their query. The MLP then runs as it is
    (its BatchNorm in eval on the running statistics, never folded), in
    any norm, and the max over K follows."""

    def __init__(self, npoint: int | None, radius: float | None,
                 nsample: int | None, in_channel: int,
                 mlp: Sequence[int], group_all: bool, norm: str,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channel, mlp, norm, dtype)
        self.npoint = npoint
        self.radius = radius
        self.nsample = nsample
        self.group_all = group_all

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None,
                generator: torch.Generator | None = None,
                full_points: torch.Tensor | None = None):
        """``generator``: the random FPS starts in train mode;
        ``full_points``: the rows to group in place of ``[x − q ; f]``."""
        bf16 = self.dtype == torch.bfloat16
        if self.group_all:
            new_xyz = xyz.new_zeros((xyz.shape[0], 1, 3))
            grouped = xyz[:, None]                              # (B, 1, N, 3)
            if features is not None:
                grouped = torch.cat([grouped, features[:, None]], dim=-1)
            # a bf16 model's global level computes in f32 in eval
            dtype = self.dtype if self.training else torch.float32
            return new_xyz, self.pool(self.run_mlp(grouped, dtype))
        start = random_starts(xyz, generator) if self.training else None
        fps_idx = farthest_point_sample(xyz, self.npoint, start)
        new_xyz = index_points(xyz, fps_idx)                    # (B, S, 3)
        if full_points is not None:
            idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
            grouped = index_points(full_points, idx)            # (B, S, K, D)
            return new_xyz, self.pool(self.run_mlp(grouped))
        if self.norm in ("layer", "none"):
            pooled, _ = fused_sa_forward(
                self.radius, self.nsample, self.norm, xyz, new_xyz, features,
                self.layer_params(), "bf16" if bf16 else "f32")
            return new_xyz, pooled
        grouped, _ = ball_group(self.radius, self.nsample, xyz, new_xyz,
                                features, single_pass=bf16)  # (B, S, K, C)
        if self.training or (features is None and not bf16):
            return new_xyz, self.pool(self.run_mlp(grouped))
        return new_xyz, self.run_folded(grouped)


class SetAbstractionMsg(nn.Module):
    """PointNet++ set-abstraction level with multi-scale grouping
    (``maskplanner_tpu/models/pointnet2.py::SetAbstractionMsg``, the
    original repository's ``PointNetSetAbstractionMsg``; no model of
    either package builds it). One FPS draw of ``npoint`` centres (a random
    start from ``generator`` in train) serves every scale; scale ``i``
    queries the ball of ``radii[i]`` for ``nsamples[i]`` neighbours
    (``query_ball_point``: the ball query kernel on the card), gathers
    their features before their xyz relative to the centre, runs its own
    ``PointMLP`` (``mlps.{i}``) and takes the max over the neighbours in
    f32; the scales' descriptors are concatenated on the channels."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], in_channel: int,
                 mlps: Sequence[Sequence[int]], norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps differ in length")
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = nn.ModuleList(PointMLP(in_channel + 3, mlp, norm, dtype)
                                  for mlp in mlps)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None,
                generator: torch.Generator | None = None):
        start = random_starts(xyz, generator) if self.training else None
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint,
                                                          start))
        pooled = []
        for radius, nsample, mlp in zip(self.radii, self.nsamples, self.mlps):
            idx = query_ball_point(radius, nsample, xyz, new_xyz)
            grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
            if features is not None:
                grouped = torch.cat([index_points(features, idx), grouped],
                                    dim=-1)
            pooled.append(mlp.pool(mlp.run_mlp(grouped)))
        return new_xyz, torch.cat(pooled, dim=-1)


class FeaturePropagation(PointMLP):
    """Inverse-distance 3-NN feature upsampling
    (``maskplanner_tpu/models/pointnet2.py::FeaturePropagation``, the
    original repository's ``PointNetFeaturePropagation``): the features of
    the S points ``xyz2`` carried to the N points ``xyz1`` (broadcast when
    S is 1, else weighted 1 / (d² + 1e-8) over the 3 nearest, normalised),
    after ``feat1`` when given, then the MLP over the rows. No model of
    the JAX package calls it."""

    def __init__(self, in_channel: int, mlp: Sequence[int],
                 norm: str = "batch"):
        super().__init__(in_channel, mlp, norm)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                feat1: torch.Tensor | None,
                feat2: torch.Tensor) -> torch.Tensor:
        B, N, _ = xyz1.shape
        if xyz2.shape[1] == 1:
            interpolated = feat2.expand(B, N, feat2.shape[-1])
        else:
            dists, idx = knn(3, xyz1, xyz2)
            w = 1.0 / (dists + 1e-8)
            w = w / w.sum(-1, keepdim=True)
            interpolated = (index_points(feat2, idx) * w[..., None]).sum(-2)
        x = (interpolated if feat1 is None
             else torch.cat([feat1, interpolated], dim=-1))
        return self.run_mlp(x)


def level_norms(norm: str) -> list[str]:
    """``"batch"`` or a per-level spec ``"a+b+c"`` -> the three levels'
    norms."""
    norms = norm.split("+")
    if len(norms) == 1:
        norms = norms * 3
    if len(norms) != 3:
        raise ValueError(f"per-level norm spec needs 3 entries: {norm!r}")
    return norms


class PointNet2Encoder(nn.Module):
    """sa1 -> sa2 -> sa3 (group_all) -> (B, 1024) global feature, f32.
    ``dtype``: the levels' compute dtype (sa3's in train only)."""

    def __init__(self, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n1, n2, n3 = level_norms(norm)
        self.dtype = dtype
        self.sa1 = SetAbstraction(512, 0.2, 32, 3, (64, 64, 128), False, n1,
                                  dtype)
        self.sa2 = SetAbstraction(128, 0.4, 64, 128 + 3, (128, 128, 256),
                                  False, n2, dtype)
        self.sa3 = SetAbstraction(None, None, None, 256 + 3, (256, 512, 1024),
                                  True, n3, dtype)

    def forward(self, xyz: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        l1_xyz, l1_f = self.sa1(xyz, None, generator)
        l2_xyz, l2_f = self.sa2(l1_xyz, l1_f, generator)
        _, l3_f = self.sa3(l2_xyz, l2_f)
        return l3_f[:, 0, :]


def regression_head(x: torch.Tensor, layers, rate: float = 0.0,
                    training: bool = False,
                    generator: torch.Generator | None = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The fc -> BatchNorm -> ReLU -> dropout trunk of every regressor head;
    ``layers`` is ``[(linear, batchnorm or None)]``. A function, so that the
    layers keep the original repo's names on the model (``fc1``, ``bn1``,
    ``sm_fc1``, ...). ``dtype``: each fc's (:func:`dense`); a BatchNorm
    runs in its parameters' dtype (f32)."""
    for linear, bn in layers:
        x = dense(linear, x, dtype)
        if bn is not None:
            x = bn(x)
        x = dropout(torch.relu(x), rate, training, generator)
    return x


def assemble_pose_output(positions: torch.Tensor, normals: torch.Tensor,
                         out_vectors: int,
                         weight_orient: float) -> torch.Tensor:
    """(B, V·λ·3) positions and raw orientations -> (B, V, λ·6) segments of
    [x, y, z, nx, ny, nz] poses with unit orientations scaled by
    ``weight_orient``."""
    B = positions.shape[0]
    p = positions.reshape(B, -1, 3)
    n = torch.tanh(normals).reshape(B, -1, 3)
    n = n * torch.rsqrt((n * n).sum(-1, keepdim=True) + 1e-12)
    n = n * weight_orient
    return torch.cat([p, n], dim=-1).reshape(B, out_vectors, -1)
