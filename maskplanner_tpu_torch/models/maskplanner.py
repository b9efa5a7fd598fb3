"""The MaskPlanner network (``maskplanner_tpu/models/maskplanner.py``).

The SSG encoder gives a 1024-d global feature; parallel heads regress the
unordered segment set with per-pose orientations, the stroke masks, the
mask confidence scores and, optionally, per-segment confidences.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from .pointnet2 import (BATCH_NORM_EPS, PointNet2Encoder,
                        assemble_pose_output, regression_head)


class MaskPlannerOutput(NamedTuple):
    traj: torch.Tensor                   # (B, out_vectors, λ·outdim) segments
    stroke_masks: torch.Tensor           # (B, n_stroke_masks, out_vectors) logits
    mask_scores: torch.Tensor            # (B, n_stroke_masks) confidence logits
    seg_conf: torch.Tensor | None        # (B, out_vectors) sigmoid confidences


class PointNet2StrokeMasks(PointNet2Encoder):
    """The flagship MaskPlanner model, eval forward.

    The encoder levels are this module's own ``sa1``..``sa3`` and the heads
    carry the original repo's names, so the ``state_dict`` reads like the
    original model's."""

    def __init__(self, out_vectors: int, outdim: int = 3,
                 outdim_orient: int = 3, weight_orient: float = 1.0,
                 lambda_points: int = 4,
                 hidden_size: Sequence[int] = (1024, 1024),
                 n_stroke_masks: int = 1,
                 segment_confidence_scores: bool = False,
                 encoder_norm: str = "batch"):
        super().__init__(encoder_norm)
        self.out_vectors = out_vectors
        self.outdim_orient = outdim_orient
        self.weight_orient = weight_orient
        self.n_stroke_masks = n_stroke_masks
        h1, h2 = hidden_size
        n_pose = out_vectors * lambda_points

        def bn(c):
            return nn.BatchNorm1d(c, eps=BATCH_NORM_EPS)

        self.fc1, self.bn1 = nn.Linear(1024, h1), bn(h1)
        self.fc2, self.bn2 = nn.Linear(h1, h2), bn(h2)
        self.fc3 = nn.Linear(h2, n_pose * outdim)
        if outdim_orient > 0:
            self.fc_normals = nn.Linear(h2, n_pose * outdim_orient)
        if segment_confidence_scores:
            self.seg_conf_fc1 = nn.Linear(1024, h1)
            self.seg_conf_fc2 = nn.Linear(h1, h2)
            self.seg_conf_out = nn.Linear(h2, out_vectors)
        self.segment_confidence_scores = segment_confidence_scores
        self.sm_fc1, self.sm_bn1 = nn.Linear(1024, h1), bn(h1)
        self.sm_fc2, self.sm_bn2 = nn.Linear(h1, h2), bn(h2)
        self.sm_fc3 = nn.Linear(h2, out_vectors * n_stroke_masks)
        self.mask_conf_out = nn.Linear(h2, n_stroke_masks)

    def forward(self, xyz: torch.Tensor) -> MaskPlannerOutput:
        """xyz: (B, N, 3) normalized point clouds."""
        feat = super().forward(xyz)
        B = feat.shape[0]
        trunk = regression_head(feat, [(self.fc1, self.bn1),
                                       (self.fc2, self.bn2)])
        positions = self.fc3(trunk)
        if self.outdim_orient > 0:
            traj = assemble_pose_output(positions, self.fc_normals(trunk),
                                        self.out_vectors, self.weight_orient)
        else:
            traj = positions.reshape(B, self.out_vectors, -1)

        seg_conf = None
        if self.segment_confidence_scores:
            sc = regression_head(feat, [(self.seg_conf_fc1, None),
                                        (self.seg_conf_fc2, None)])
            seg_conf = torch.sigmoid(self.seg_conf_out(sc))

        sm = regression_head(feat, [(self.sm_fc1, self.sm_bn1),
                                    (self.sm_fc2, self.sm_bn2)])
        stroke_masks = self.sm_fc3(sm).reshape(B, self.n_stroke_masks,
                                               self.out_vectors)
        return MaskPlannerOutput(traj, stroke_masks, self.mask_conf_out(sm),
                                 seg_conf)
