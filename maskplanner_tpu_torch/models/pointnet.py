"""The PointNet family (``maskplanner_tpu/models/pointnet.py``): the
spatial and feature transform nets, the shared-MLP feature extractor, the
trajectory regressor (``pointnet``, ``pointnet_deeper``) and the two
segmenters (``pointnet_segmenter``, ``pointnet_segmenter_conv1d``).

Channel-last like the JAX package: the original repository's Conv1d(k=1)
layers are ``nn.Linear`` layers over the last axis, under its names
(``conv{i}``, ``bn{i}``, ``fc{i}``, ``feat.stn``, ``feat.fstn``). Every
BatchNorm is a :class:`FlaxBatchNorm1d` over all rows, so that train mode
moves the statistics as Flax's does. Plain PyTorch: none of these reaches
a kernel of the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .pointnet2 import (BATCH_NORM_EPS, FlaxBatchNorm1d, batch_norm_rows,
                        dropout)


def _bn(c: int) -> FlaxBatchNorm1d:
    return FlaxBatchNorm1d(c, eps=BATCH_NORM_EPS)


def _layers(module: nn.Module, kind: str, first: int, widths,
            bn_first: int | None = None) -> list:
    """Adds ``{kind}{first + j}`` (Linear) and ``bn{bn_first + j}`` (default
    ``bn_first = first``) for each step of ``widths`` -> their names."""
    bn_first = first if bn_first is None else bn_first
    names = []
    for j, (ci, co) in enumerate(zip(widths[:-1], widths[1:])):
        names.append((f"{kind}{first + j}", f"bn{bn_first + j}"))
        setattr(module, names[-1][0], nn.Linear(ci, co))
        setattr(module, names[-1][1], _bn(co))
    return names


def _run(module: nn.Module, x: torch.Tensor, names) -> torch.Tensor:
    """Linear -> BatchNorm over the rows -> ReLU, for each named pair."""
    for linear, bn in names:
        x = torch.relu(batch_norm_rows(getattr(module, bn),
                                       getattr(module, linear)(x)))
    return x


class STNkd(nn.Module):
    """The k x k alignment net (STN3d is k = 3): conv1..conv3 (64, 128,
    1024) with bn1..bn3, the max over the points, fc1, fc2 (512, 256) with
    bn4, bn5, then ``fc3``, which starts at zero (``zero_init``: weights
    and bias), plus the identity. (B, N, in_channels) -> (B, k, k)."""

    def __init__(self, k: int = 3, in_channels: int | None = None):
        super().__init__()
        self.k = k
        self.convs = _layers(self, "conv", 1,
                             [in_channels or k, 64, 128, 1024])
        self.fcs = _layers(self, "fc", 1, [1024, 512, 256], bn_first=4)
        self.fc3 = nn.Linear(256, k * k)
        self.fc3.zero_init = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _run(self, x, self.convs).amax(dim=1)
        h = _run(self, h, self.fcs)
        eye = torch.eye(self.k, dtype=h.dtype, device=h.device).reshape(-1)
        return (self.fc3(h) + eye).reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    """The shared-MLP feature extractor: optionally ``stn`` (the input
    alignment), conv1 (64), optionally ``fstn`` (the 64-d feature
    alignment), the middle convs (128; ``deeper``: 128, 128, 512) and the
    last conv (1024) with its BatchNorm and no ReLU, then the max over the
    points. -> the (B, 1024) global feature (``global_feat``) or per point
    the global feature ++ conv1's features (B, N, 1088)."""

    def __init__(self, global_feat: bool = True,
                 feature_transform: bool = False, affinetrans: bool = True,
                 deeper: bool = False, inputdim: int = 3):
        super().__init__()
        self.global_feat = global_feat
        self.feature_transform = feature_transform
        self.affinetrans = affinetrans
        if affinetrans:
            self.stn = STNkd(3, inputdim)
        mid = [128, 128, 512] if deeper else [128]
        self.first = _layers(self, "conv", 1, [inputdim, 64])
        if feature_transform:
            self.fstn = STNkd(64)
        self.mid = _layers(self, "conv", 2, [64, *mid])
        # the last conv and its BatchNorm, without the ReLU
        (self.last,) = _layers(self, "conv", 2 + len(mid), [mid[-1], 1024])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.affinetrans:
            x = torch.einsum("bnc,bcd->bnd", x, self.stn(x))
        x = _run(self, x, self.first)
        if self.feature_transform:
            x = torch.einsum("bnc,bcd->bnd", x, self.fstn(x))
        point_feat = x
        conv, bn = (getattr(self, n) for n in self.last)
        g = batch_norm_rows(bn, conv(_run(self, x, self.mid))).amax(dim=1)
        if self.global_feat:
            return g
        B, N, _ = point_feat.shape
        return torch.cat([g[:, None, :].expand(B, N, g.shape[-1]),
                          point_feat], dim=-1)


class PointNetRegressor(nn.Module):
    """(B, N, 3) -> (B, out_vectors, outdim) on the global feature: fc1 ->
    bn1 -> ReLU -> fc2 -> dropout -> bn2 -> ReLU -> fc3. At batch 1 the two
    BatchNorms are left out (the original repository's bypass; the JAX
    package calls them in running-average mode and drops what they give,
    so nothing moves their statistics there either). ``dropout``: its rate
    in train mode, the mask drawn from the caller's generator."""

    def __init__(self, out_vectors: int, outdim: int = 3,
                 feature_transform: bool = False, affinetrans: bool = False,
                 hidden_size: Sequence[int] = (1024, 1024),
                 deeper: bool = False, dropout: float = 0.3):
        super().__init__()
        self.out_vectors = out_vectors
        self.outdim = outdim
        self.rate = dropout
        self.feat = PointNetFeat(True, feature_transform, affinetrans, deeper)
        h0, h1 = hidden_size
        self.fc1, self.bn1 = nn.Linear(1024, h0), _bn(h0)
        self.fc2, self.bn2 = nn.Linear(h0, h1), _bn(h1)
        self.fc3 = nn.Linear(h1, out_vectors * outdim)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        bypass = x.shape[0] == 1

        def bn(norm, h):
            return h if bypass else norm(h)

        h = torch.relu(bn(self.bn1, self.fc1(self.feat(x))))
        h = dropout(self.fc2(h), self.rate, self.training, generator)
        h = torch.relu(bn(self.bn2, h))
        return self.fc3(h).reshape(-1, self.out_vectors, self.outdim)


class PointNetSegmenter(nn.Module):
    """(B, N, inputdim) -> (B, N, outdim) per-point latents: the per-point
    features (1088), with ``augment_point_features_by`` > 0 a one-hot
    conditioning of that width per sample appended, then conv1..conv3
    (512, 256, 128) with bn1..bn3 and conv4."""

    def __init__(self, outdim: int = 2, feature_transform: bool = False,
                 affinetrans: bool = False, augment_point_features_by: int = 0,
                 inputdim: int = 3):
        super().__init__()
        self.feat = PointNetFeat(False, feature_transform, affinetrans,
                                 inputdim=inputdim)
        self.head = _layers(self, "conv", 1,
                            [1088 + augment_point_features_by, 512, 256, 128])
        self.conv4 = nn.Linear(128, outdim)

    def forward(self, x: torch.Tensor,
                one_hot_encoding_sample: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator       # no random draw
        feat = self.feat(x)
        if one_hot_encoding_sample is not None:
            B, N, _ = feat.shape
            one_hot = one_hot_encoding_sample[:, None, :].expand(
                B, N, one_hot_encoding_sample.shape[-1])
            feat = torch.cat([feat, one_hot], dim=-1)
        return self.conv4(_run(self, feat, self.head))


class PointNetSegmenterConv1d(nn.Module):
    """Point-wise segmenter with no exchange between points: conv1..conv3
    (32, 64, 64) with ReLU, then conv4. With ``input_normals_only`` it
    reads only each pose's orientation (values 3..5 of each 6 in a
    λ-segment)."""

    def __init__(self, outdim: int = 2, lambda_points: int = 1,
                 input_normals_only: bool = False, inputdim: int = 6):
        super().__init__()
        self.lambda_points = lambda_points
        self.input_normals_only = input_normals_only
        cin = 3 * lambda_points if input_normals_only else inputdim
        widths = [cin, 32, 64, 64, outdim]
        for j, (ci, co) in enumerate(zip(widths[:-1], widths[1:]), 1):
            setattr(self, f"conv{j}", nn.Linear(ci, co))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        del generator       # no random draw
        if self.input_normals_only:
            idx = [l * 6 + 3 + i for l in range(self.lambda_points)
                   for i in range(3)]
            x = x[:, :, idx]
        for j in (1, 2, 3):
            x = torch.relu(getattr(self, f"conv{j}")(x))
        return self.conv4(x)
