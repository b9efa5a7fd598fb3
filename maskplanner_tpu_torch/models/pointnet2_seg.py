"""The PointNet++ segmenters (``maskplanner_tpu/models/pointnet2_seg.py``).

Both run the SSG encoder with BatchNorm levels (sa1 -> sa2 -> sa3), tile
its 1024-d global feature over the N inputs, append each input and run a
per-point head (``conv1``/``bn1`` .. ``conv3``/``bn3``, the original
repository's names) before their own outputs:

- :class:`PointNet2Segmenter` (``pointnet2_segmenter_v1``): a latent
  vector per input (``conv4``), the contrastive task's features. Its
  inputs are λ-segments (B, N, D). With ``ball_in_xyz_space`` sa1 samples
  and balls on each segment's centroid in R³ (the mean of its poses'
  first 3 values) and groups the full D-dim segments
  (``SetAbstraction``'s ``full_points``: the ball query kernel, #7, on the
  card); without it the segments themselves are sa1's points, which the
  card's kernels take only in R³ (D = 3).
- :class:`PointNet2SegmenterPaintNet` (``pointnet2_segmenter_paintnet_v1``):
  per input point a λ-segment of poses (``conv4_trasl``, and
  ``conv4_orient`` through tanh, unit length, times ``weight_orient``).

On the card the levels run the ball-group kernel (#6) and FPS (#1) as the
BatchNorm recipe's encoder does (the backward of #6 is ``index_add_``).
In train mode FPS starts at random indices drawn from the caller's
generator, and the BatchNorms move their statistics as Flax's do.
"""
from __future__ import annotations

import torch
from torch import nn

from .pointnet2 import (BATCH_NORM_EPS, FlaxBatchNorm1d, SetAbstraction,
                        batch_norm_rows)

HEAD = (512, 256, 128)


class _SegmenterBase(nn.Module):
    """The encoder on ``xyz`` and the per-point head on the tiled global
    feature ++ each input."""

    def __init__(self, inputdim: int, xyz_dim: int):
        super().__init__()
        self.sa1 = SetAbstraction(512, 0.2, 32, inputdim, (64, 64, 128),
                                  False, "batch")
        self.sa2 = SetAbstraction(128, 0.4, 64, xyz_dim + 128,
                                  (128, 128, 256), False, "batch")
        self.sa3 = SetAbstraction(None, None, None, xyz_dim + 256,
                                  (256, 512, 1024), True, "batch")
        widths = [1024 + inputdim, *HEAD]
        for j, (ci, co) in enumerate(zip(widths[:-1], widths[1:]), 1):
            setattr(self, f"conv{j}", nn.Linear(ci, co))
            setattr(self, f"bn{j}", FlaxBatchNorm1d(co, eps=BATCH_NORM_EPS))

    def features(self, input_set: torch.Tensor, xyz: torch.Tensor,
                 full_points: torch.Tensor | None,
                 generator: torch.Generator | None) -> torch.Tensor:
        """-> the head's last features (B, N, 128)."""
        B, N, _ = input_set.shape
        l1_xyz, l1_f = self.sa1(xyz, None, generator, full_points)
        l2_xyz, l2_f = self.sa2(l1_xyz, l1_f, generator)
        _, l3_f = self.sa3(l2_xyz, l2_f)
        tiled = l3_f[:, :1, :].expand(B, N, l3_f.shape[-1])
        h = torch.cat([tiled, input_set], dim=-1)
        for j in range(1, len(HEAD) + 1):
            conv, bn = getattr(self, f"conv{j}"), getattr(self, f"bn{j}")
            h = torch.relu(batch_norm_rows(bn, conv(h)))
        return h


class PointNet2Segmenter(_SegmenterBase):
    """(B, N, D) λ-segments -> (B, N, outdim) latents. ``inputdim`` is D
    (``get_io_info("ContrastiveClustering")``)."""

    def __init__(self, inputdim: int, outdim: int = 2,
                 lambda_points: int = 1, ball_in_xyz_space: bool = False):
        super().__init__(inputdim, 3 if ball_in_xyz_space else inputdim)
        self.lambda_points = lambda_points
        self.ball_in_xyz_space = ball_in_xyz_space
        self.conv4 = nn.Linear(HEAD[-1], outdim)

    def forward(self, input_set: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, D = input_set.shape
        if self.ball_in_xyz_space:
            poses = input_set.reshape(B, N, self.lambda_points,
                                      D // self.lambda_points)
            xyz, full = poses[..., :3].mean(dim=-2), input_set
        else:
            xyz, full = input_set, None
        return self.conv4(self.features(input_set, xyz, full, generator))


class PointNet2SegmenterPaintNet(_SegmenterBase):
    """(B, N, 3) points -> (B, N, λ·(outdim_trasl + outdim_orient)): per
    point a λ-segment of poses."""

    def __init__(self, outdim_trasl: int = 3, outdim_orient: int = 3,
                 weight_orient: float = 1.0, lambda_points: int = 1):
        super().__init__(3, 3)
        self.lambda_points = lambda_points
        self.weight_orient = weight_orient
        self.conv4_trasl = nn.Linear(HEAD[-1], outdim_trasl * lambda_points)
        self.conv4_orient = nn.Linear(HEAD[-1],
                                      outdim_orient * lambda_points)

    def forward(self, input_set: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        B, N, _ = input_set.shape
        last = self.features(input_set, input_set, None, generator)
        lam = self.lambda_points
        normals = torch.tanh(self.conv4_orient(last)).reshape(B, N, lam, -1)
        normals = normals / torch.clamp(
            torch.linalg.vector_norm(normals, dim=-1, keepdim=True),
            min=1e-12) * self.weight_orient
        trasl = self.conv4_trasl(last).reshape(B, N, lam, -1)
        return torch.cat([trasl, normals], dim=-1).reshape(B, N, -1)
