"""The MaskPlanner network (``maskplanner_tpu/models/maskplanner.py``).

The SSG encoder gives a 1024-d global feature; parallel heads regress the
unordered segment set with per-pose orientations, the stroke masks, the
mask confidence scores and, optionally, per-segment confidences.

In bf16 the heads follow the JAX package's, in train and in eval: each
Dense gives bf16, each BatchNorm f32, the dropout of the BatchNorm-less
segment-confidence head runs on bf16 activations, the pose assembly runs
in bf16, and every output is cast to f32 at the model's boundary. The
bf16 products on the card sum in f32 throughout, as the JAX reference does
(:func:`f32_accumulation`; ``train.train_step`` runs the backward under
it too).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import torch
from torch import nn

from .pointnet2 import (BATCH_NORM_EPS, FlaxBatchNorm1d, PointNet2Encoder,
                        assemble_pose_output, dense, regression_head)


@contextlib.contextmanager
def f32_accumulation():
    """bf16 matrix products on the card sum in f32 throughout: cuBLAS may
    otherwise reduce split-K partial sums in bf16
    (``allow_bf16_reduced_precision_reduction``, on by default)."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


class MaskPlannerOutput(NamedTuple):
    traj: torch.Tensor                   # (B, out_vectors, λ·outdim) segments
    stroke_masks: torch.Tensor           # (B, n_stroke_masks, out_vectors) logits
    mask_scores: torch.Tensor            # (B, n_stroke_masks) confidence logits
    seg_conf: torch.Tensor | None        # (B, out_vectors) sigmoid confidences


class PointNet2StrokeMasks(PointNet2Encoder):
    """The flagship MaskPlanner model.

    The encoder levels are this module's own ``sa1``..``sa3`` and the heads
    carry the original repo's names, so the ``state_dict`` reads like the
    original model's. ``dropout``: the heads' dropout rate in train mode
    (0.3 as in the JAX package's ``RegressionHead``). ``dtype``: the
    compute dtype, float32 or bfloat16; the parameters are float32 either
    way."""

    def __init__(self, out_vectors: int, outdim: int = 3,
                 outdim_orient: int = 3, weight_orient: float = 1.0,
                 lambda_points: int = 4,
                 hidden_size: Sequence[int] = (1024, 1024),
                 n_stroke_masks: int = 1,
                 segment_confidence_scores: bool = False,
                 encoder_norm: str = "batch", dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(encoder_norm, dtype)
        self.dropout = dropout
        self.out_vectors = out_vectors
        self.outdim_orient = outdim_orient
        self.weight_orient = weight_orient
        self.n_stroke_masks = n_stroke_masks
        h1, h2 = hidden_size
        n_pose = out_vectors * lambda_points

        def bn(c):
            return FlaxBatchNorm1d(c, eps=BATCH_NORM_EPS)

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

    def forward(self, xyz: torch.Tensor,
                generator: torch.Generator | None = None) -> MaskPlannerOutput:
        """xyz: (B, N, 3) normalized point clouds. ``generator``: in train
        mode, the random FPS starts and the dropout masks. The outputs are
        in the parameters' dtype (float32)."""
        if self.dtype == torch.float32:
            return self._forward(xyz, generator)
        with f32_accumulation():
            out = self._forward(xyz, generator)
        return MaskPlannerOutput(*(None if t is None
                                   else t.to(self.fc1.weight.dtype)
                                   for t in out))

    def _forward(self, xyz, generator):
        feat = super().forward(xyz, generator)
        B = feat.shape[0]
        dt = self.dtype
        drop = dict(rate=self.dropout, training=self.training,
                    generator=generator, dtype=dt)
        trunk = regression_head(feat, [(self.fc1, self.bn1),
                                       (self.fc2, self.bn2)], **drop)
        positions = dense(self.fc3, trunk, dt)
        if self.outdim_orient > 0:
            traj = assemble_pose_output(positions,
                                        dense(self.fc_normals, trunk, dt),
                                        self.out_vectors, self.weight_orient)
        else:
            traj = positions.reshape(B, self.out_vectors, -1)

        seg_conf = None
        if self.segment_confidence_scores:
            sc = regression_head(feat, [(self.seg_conf_fc1, None),
                                        (self.seg_conf_fc2, None)], **drop)
            seg_conf = torch.sigmoid(dense(self.seg_conf_out, sc, dt))

        sm = regression_head(feat, [(self.sm_fc1, self.sm_bn1),
                                    (self.sm_fc2, self.sm_bn2)], **drop)
        stroke_masks = dense(self.sm_fc3, sm, dt).reshape(
            B, self.n_stroke_masks, self.out_vectors)
        return MaskPlannerOutput(traj, stroke_masks,
                                 dense(self.mask_conf_out, sm, dt), seg_conf)
