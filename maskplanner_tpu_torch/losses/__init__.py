"""Loss handler (``maskplanner_tpu/losses/__init__.py``).

The weighted sum of the configured terms, each ``weight_<name>`` times its
value. Loss weights are a plain dict of floats that the PSACD curriculum and
the delayed activations change between epochs, or the same weights as 0-d
tensors on the model's device (:class:`DeviceWeights`, the JAX step's
"weights as a traced dict"), which a captured CUDA graph reads and the driver
fills in place from the float dict after each change. Only the flagship's term,
``asymm_v6_chamfer_with_stroke_masks``, is ported; the other names of the
JAX package's registry raise.
"""
from __future__ import annotations

import torch

from ..data.pointcloud import get_dim_traj_points
from . import mask_losses as M

PORTED = ("asymm_v6_chamfer_with_stroke_masks",)

# weights consumed inside the loss terms (beyond weight_<name>)
_EXPLICIT_WEIGHT_KEYS = [
    "weight_asymm_segment_chamfer",
    "weight_reverse_asymm_point_chamfer",
    "weight_reverse_asymm_segment_chamfer",
    "weight_symm_segment_chamfer",
    "weight_symm_point_chamfer",
    "explicit_weight_stroke_masks",
    "explicit_weight_stroke_masks_confidence",
    "explicit_no_stroke_weight",
    "explicit_weight_segments_confidence",
    "explicit_weight_endofpath_confidence_loss",
    "explicit_no_sop_weight",
    "explicit_weight_sop_confidence_loss",
    "explicit_weight_masked_mse_loss",
    "explicit_weight_point_confidence_loss",
    "explicit_weight_stroke_confidence_loss",
]


class DeviceWeights(dict):
    """The loss weights as 0-d float32 tensors on ``device``.

    The loss uses a weight only as a factor, so a tensor weight gives the
    float weight's result bit for bit. A CUDA graph captured on these
    tensors reads whatever they hold at replay: :meth:`load` writes the
    values of a dict of float weights into them in place (``fill_``)."""

    def __init__(self, weights: dict, device):
        super().__init__({k: torch.tensor(float(v), dtype=torch.float32,
                                          device=device)
                          for k, v in weights.items()})

    def load(self, weights: dict) -> None:
        """Each float weight of ``weights`` into its tensor, in place."""
        for key, value in weights.items():
            self[key].fill_(float(value))


class LossHandler:
    """Builds and evaluates the weighted sum of the configured loss terms."""

    def __init__(self, loss, config):
        unported = [name for name in loss if name not in PORTED]
        if unported:
            raise NotImplementedError(
                f"loss terms {unported} are not ported yet (ROADMAP.md, "
                f"Queue 1); ported: {list(PORTED)}")
        for name in loss:
            assert f"weight_{name}" in config, \
                f"missing weight_{name} in config"
        self.loss = list(loss)
        self.config = config
        self.outdim = get_dim_traj_points(config["extra_data"])

    def init_weights(self) -> dict[str, float]:
        """Flat dict of the dynamic loss weights."""
        w: dict[str, float] = {}
        for name in self.loss:
            w[f"weight_{name}"] = float(self.config.get(f"weight_{name}", 1.0))
        for key in _EXPLICIT_WEIGHT_KEYS:
            if key in self.config and self.config[key] is not None:
                w[key] = float(self.config[key])
        return w

    def compute(self, weights, return_list=True, **batch):
        """Weighted total + per-term values."""
        cfg = self.config
        total = 0.0
        terms = {}
        for name in self.loss:
            value = M.asymm_v6_chamfer_with_stroke_masks(
                y_pred=batch["y_pred"], y=batch["y"],
                y_mask=batch.get("y_mask"), traj_as_pc=batch["traj_as_pc"],
                pc_mask=batch.get("pc_mask"), outdim=self.outdim,
                pred_stroke_masks=batch["pred_stroke_masks"],
                mask_scores=batch["mask_scores"],
                seg_logits=batch.get("seg_logits"),
                stroke_ids=batch["stroke_ids"], weights=weights,
                per_segment_confidence=bool(cfg.get("per_segment_confidence")),
                smooth_targets=bool(cfg.get("smooth_target_stroke_masks")))
            total = total + weights[f"weight_{name}"] * value
            terms[name] = value
        if return_list:
            return total, terms
        return total
