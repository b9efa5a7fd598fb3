"""LR milestones and the PSACD loss-weight curriculum
(``maskplanner_tpu/train/schedulers.py``).

The JAX package builds an optax schedule indexed by step, with boundaries at
``milestone · steps_per_epoch``. The port gives the same milestones, in
epochs, to a ``torch.optim.lr_scheduler.MultiStepLR`` that is stepped once
per epoch: after ``m`` epochs both apply ``gamma`` per milestone passed. The
PSACD curriculum and the delayed activations change the loss-weight dict
between epochs, as in the JAX package.
"""
from __future__ import annotations

import torch


def lr_milestones(config) -> tuple[list[int], float]:
    """``config.lr_sched`` -> (milestone epochs, gamma). A repeated
    milestone applies gamma twice, as ``MultiStepLR`` counts it."""
    sched = config["lr_sched"]
    gamma = float(sched.get("gamma") or 0.5)
    step_size = sched.get("step_size")
    step_sizes = sched.get("step_sizes")
    step_n_times = sched.get("step_n_times")
    step_after_epoch = sched.get("step_after_epoch")
    epochs = int(config["epochs"])

    # the deprecated `steplr` stands for lr_sched.step_size when no other
    # schedule is set (as the JAX package reads it)
    if (config.get("steplr") is not None and step_size is None
            and step_sizes is None and step_n_times is None):
        print(f"WARNING: `steplr` is deprecated; treating as "
              f"lr_sched.step_size={config['steplr']}")
        step_size = config["steplr"]
    elif config.get("steplr") is not None:
        print("WARNING: `steplr` is deprecated and an lr_sched.* schedule "
              "is configured; ignoring steplr")
    set_count = sum(x is not None for x in (step_size, step_sizes, step_n_times))
    assert set_count <= 1, "configure at most one of step_size/step_sizes/step_n_times"

    milestones: list[int] = []
    if step_size is not None:
        milestones = list(range(int(step_size), epochs, int(step_size)))
    elif step_sizes is not None:
        milestones = [int(m) for m in step_sizes]
    elif step_n_times is not None:
        tot = epochs if step_after_epoch is None else epochs - int(step_after_epoch)
        base = 0 if step_after_epoch is None else int(step_after_epoch)
        milestones = [
            (i + 1) * (tot // (int(step_n_times) + 1)) + base
            for i in range(int(step_n_times))
        ]
    return milestones, gamma


def make_lr_scheduler(optimizer: torch.optim.Optimizer, config):
    """A ``MultiStepLR`` over the configured milestones (stepped once per
    epoch), or None for a constant rate."""
    milestones, gamma = lr_milestones(config)
    if not milestones:
        return None
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, milestones,
                                                gamma=gamma)


class PSACDScheduler:
    """Point-to-Segment Asymmetric Chamfer Distance curriculum
    (reference train_maskplanner.py:455-503)."""

    POINT_KEYS = ["weight_reverse_asymm_point_chamfer",
                  "weight_symm_point_chamfer"]
    SEGMENT_KEYS = ["weight_reverse_asymm_segment_chamfer",
                    "weight_symm_segment_chamfer",
                    "weight_rich_attraction_chamfer"]

    def __init__(self, psacd_config):
        self.milestones = psacd_config.get("milestones")
        self.step_freq = psacd_config.get("freq")
        self.factor = psacd_config.get("factor")
        assert not (self.milestones is not None and self.step_freq is not None)
        assert self.milestones is not None or self.step_freq is not None
        assert self.factor is not None and self.factor > 0
        if self.milestones is not None:
            self.milestones = [int(m) for m in self.milestones]

    def is_time_to_step(self, epoch: int, total_epochs: int) -> bool:
        if (epoch + 1) == total_epochs:
            return False  # keep final-eval loss comparable (reference :476)
        if self.step_freq is not None:
            return (epoch + 1) % int(self.step_freq) == 0
        return (epoch + 1) in self.milestones

    def step_loss_weights(self, weights: dict) -> dict:
        """×factor the point-wise weights, ÷factor the segment-wise ones."""
        for k in self.POINT_KEYS:
            if k in weights:
                weights[k] = weights[k] * self.factor
        for k in self.SEGMENT_KEYS:
            if k in weights:
                weights[k] = weights[k] / self.factor
        return weights


def apply_delayed_activations(config, weights: dict, epoch: int) -> dict:
    """Activate stroke-mask / segment-confidence losses at their scheduled
    epoch (reference train_maskplanner.py:293-306)."""
    if (config.get("delay_stroke_masks_loss")
            and int(config.get("start_stroke_masks_loss_at") or 0) <= epoch + 1):
        weights["explicit_weight_stroke_masks"] = float(
            config.get("target_explicit_weight_stroke_masks", 1.0))
        weights["explicit_weight_stroke_masks_confidence"] = float(
            config.get("target_explicit_weight_stroke_masks_confidence", 100.0))
    if (config.get("delay_segment_conf_loss")
            and int(config.get("start_segment_conf_loss_at") or 0) <= epoch + 1):
        weights["explicit_weight_segments_confidence"] = float(
            config.get("target_explicit_weight_segments_confidence", 10.0))
    return weights
