"""The DGCNN critic of the adversarial losses (``maskplanner_tpu/models/
dgcnn.py``, the ``dgcnn`` backbone).

Four edge convolutions, each on a kNN graph rebuilt in the feature space
of its input (``get_graph_feature``), then a 1x1 conv to ``emb_dims``, the
max and the mean over the points, and three linear layers to one logit.
Channel-last, with the original repository's names: ``conv1``..``conv5``
(bias-free Linear layers over the last axis) with ``bn1``..``bn5``,
``linear1`` (bias-free) with ``bn6``, ``linear2`` with ``bn7``,
``linear3``. LeakyReLU at slope 0.2; dropout 0.5 after ``bn6`` and
``bn7`` in train mode. Plain PyTorch: the JAX critic reaches no kernel.

The kNN (``ops.sampling.knn``) takes its squared distances in the matmul
expansion, the JAX package's default form: in a 64- or 128-d feature
space the port's fixed-order form would make one pass over the (B, N, N)
distances per channel. The neighbour indices carry no gradient; the
gathered features do.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional

from ..ops.sampling import index_points, knn
from ..parallel import global_rows, local_rows
from .pointnet2 import BATCH_NORM_EPS, FlaxBatchNorm1d, batch_norm_rows

SLOPE = 0.2
EDGE_CHANNELS = (64, 64, 128, 256)


def get_graph_feature(x: torch.Tensor, k: int = 20) -> torch.Tensor:
    """Edge features (B, N, C) -> (B, N, k, 2C): for each point, over its
    k nearest points in feature space (itself among them),
    ``[neighbour − point, point]``."""
    with torch.no_grad():
        _, idx = knn(k, x, x, expanded=True)
    neighbors = index_points(x, idx)                            # (B, N, k, C)
    center = x[:, :, None, :].expand_as(neighbors)
    return torch.cat([neighbors - center, center], dim=-1)


def _bn(c: int) -> FlaxBatchNorm1d:
    return FlaxBatchNorm1d(c, eps=BATCH_NORM_EPS)


class DGCNNDiscriminator(nn.Module):
    """(B, N, in_channels) -> (B, 1) realness logits. ``k``: the graph's
    neighbours (``knn_gcn``); ``dropout_rate``: the two dropouts' rate in
    train mode."""

    def __init__(self, in_channels: int, k: int = 40, emb_dims: int = 1024,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.k = k
        self.dropout_rate = dropout_rate
        c = in_channels
        for i, co in enumerate(EDGE_CHANNELS, 1):
            setattr(self, f"conv{i}", nn.Linear(2 * c, co, bias=False))
            setattr(self, f"bn{i}", _bn(co))
            c = co
        self.conv5 = nn.Linear(sum(EDGE_CHANNELS), emb_dims, bias=False)
        self.bn5 = _bn(emb_dims)
        self.linear1 = nn.Linear(2 * emb_dims, 512, bias=False)
        self.bn6 = _bn(512)
        self.linear2 = nn.Linear(512, 256)
        self.bn7 = _bn(256)
        self.linear3 = nn.Linear(256, 1)

    def dropout_masks(self, batch: int, generator: torch.Generator | None,
                      device) -> tuple | None:
        """The two dropouts' scaled keep masks ((B, 512), (B, 256)) for one
        critic step, drawn from ``generator`` (over the global batch in a
        data-parallel step, of which this rank keeps its B rows); None at
        rate 0."""
        if self.dropout_rate == 0.0:
            return None
        keep = 1.0 - self.dropout_rate
        return tuple(local_rows(torch.bernoulli(
            torch.full((global_rows(batch), w), keep, device=device),
            generator=generator)) / keep for w in (512, 256))

    def forward(self, x: torch.Tensor, masks: tuple | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``masks``: the dropouts' masks (:meth:`dropout_masks`), drawn
        here from ``generator`` when not given; unused in eval."""
        feats = []
        for i in range(1, len(EDGE_CHANNELS) + 1):
            h = getattr(self, f"conv{i}")(get_graph_feature(x, self.k))
            h = functional.leaky_relu(
                batch_norm_rows(getattr(self, f"bn{i}"), h), SLOPE)
            x = h.amax(dim=2)                                   # (B, N, C)
            feats.append(x)
        h = self.conv5(torch.cat(feats, dim=-1))
        h = functional.leaky_relu(batch_norm_rows(self.bn5, h), SLOPE)
        h = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        if self.training and masks is None:
            masks = self.dropout_masks(h.shape[0], generator, h.device)
        h = functional.leaky_relu(self.bn6(self.linear1(h)), SLOPE)
        if self.training and masks is not None:
            h = h * masks[0]
        h = functional.leaky_relu(self.bn7(self.linear2(h)), SLOPE)
        if self.training and masks is not None:
            h = h * masks[1]
        return self.linear3(h)
