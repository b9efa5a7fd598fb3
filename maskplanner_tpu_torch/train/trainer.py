"""The training and eval steps (``maskplanner_tpu/train/trainer.py``).

One step: the train forward (random FPS starts and dropout masks from an
explicit generator), the loss, the backward, ``torch.optim.Adam`` (β 0.9 /
0.999, eps 1e-8, as ``optax.adam``) on the f32 parameters, and the
BatchNorm running statistics, which the forward moves in place. A bf16
model's forward and backward both sum their bf16 products in f32
(``models.maskplanner.f32_accumulation``), as the JAX reference does.
"""
from __future__ import annotations

import torch

from ..losses import LossHandler
from ..losses.common import at_least_f32
from ..models import MaskPlannerOutput
from ..models.maskplanner import f32_accumulation


def make_optimizer(model: torch.nn.Module, config) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=float(config["lr"]),
                            betas=(0.9, 0.999), eps=1e-8)


def build_loss_batch(out, batch, config=None) -> dict:
    """Model outputs + a data batch -> the loss handler's keyword arguments.
    ``config`` is unused (kept for the JAX package's signature)."""
    del config
    lb = dict(
        y=batch["traj"],
        y_mask=batch["stroke_ids"] >= 0,
        traj_as_pc=batch["traj_as_pc"],
        pc_mask=batch["stroke_ids_as_pc"] >= 0,
        stroke_ids=batch["stroke_ids"],
    )
    if isinstance(out, MaskPlannerOutput):
        lb.update(y_pred=at_least_f32(out.traj),
                  pred_stroke_masks=at_least_f32(out.stroke_masks),
                  mask_scores=at_least_f32(out.mask_scores),
                  seg_logits=(None if out.seg_conf is None
                              else at_least_f32(out.seg_conf)))
    else:
        lb["y_pred"] = at_least_f32(out)
    return lb


def batch_to_device(batch: dict, device) -> dict:
    """numpy batch (``data.collate``) -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_step(model, optimizer, handler: LossHandler, batch, weights,
               generator: torch.Generator | None = None):
    """One step on a batch already on the model's device -> (loss, terms),
    detached tensors (no host sync)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with f32_accumulation():
        out = model(batch["point_cloud"], generator=generator)
        total, terms = handler.compute(weights, **build_loss_batch(out, batch))
        total.backward()
    optimizer.step()
    return total.detach(), {k: v.detach() for k, v in terms.items()}


def eval_step(model, handler: LossHandler, batch, weights):
    """The loss in eval mode (running BatchNorm statistics, no dropout) ->
    (loss, terms, outputs)."""
    model.eval()
    with torch.no_grad():
        out = model(batch["point_cloud"])
        total, terms = handler.compute(weights, **build_loss_batch(out, batch))
    return total, terms, out
