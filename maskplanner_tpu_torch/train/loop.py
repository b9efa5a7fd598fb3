"""The eval loop and its prediction dumps (``maskplanner_tpu/train/loop.py``).

Per batch: the eval loss (one host sync for the loss and its terms), the
metrics, optionally the single-sample latency, and a ``.npy`` dump in the
format that ``render_results.py`` and ``standalone/`` read with
``np.load(..., allow_pickle=True).item()``: a dict of numpy arrays on the
host (float32 outputs), ``None`` where an output is absent: a model with
a plain segment output (``models.PointNet2Regressor``) has no masks, mask
scores or segment confidences, and its metrics get none.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..metrics import MetricsHandler
from ..models import MaskPlannerOutput
from .trainer import batch_to_device, eval_step


def _batch_names(loader, split: str, count: int, B: int) -> list[str]:
    """The items' names (the dataset's ``item_name``, mesh-dir names for
    disk data: the reference's ``dirnames``); positional names when the
    loader carries no indices."""
    dataset = getattr(loader, "dataset", None)
    indices = getattr(loader, "last_indices", None)
    if dataset is not None and indices is not None \
            and hasattr(dataset, "item_name") and len(indices) == B:
        return [dataset.item_name(int(j)) for j in indices]
    return [f"{split}_{int(j)}" for j in range(count, count + B)]


def _output(t: torch.Tensor | None) -> np.ndarray | None:
    return None if t is None else t.float().cpu().numpy()


def _outputs(out) -> MaskPlannerOutput:
    """The model's outputs as a ``MaskPlannerOutput``: a plain segment
    tensor becomes its ``traj``, with no masks."""
    if isinstance(out, MaskPlannerOutput):
        return out
    return MaskPlannerOutput(out, None, None, None)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _single_sample_ms(model, point_cloud: np.ndarray, device,
                      forward) -> float:
    """One warm call, then one timed call of ``forward`` on one host cloud
    (its copy to the device included), the device synchronized before both
    ends of the clock."""
    x = point_cloud[:1]
    forward(model, torch.from_numpy(x).to(device))
    _sync(device)
    start = time.perf_counter()
    forward(model, torch.from_numpy(x).to(device))
    _sync(device)
    return (time.perf_counter() - start) * 1000


def evaluate(model, loader, handler, weights, metrics_handler: MetricsHandler,
             device, save=False, save_dir=None, split="test",
             eval_ckpt="last", forward=None):
    """Run the eval loop -> (avg_loss, avg_terms, avg_metrics, ms): averages
    weighted by the batches' sizes; ``ms`` the mean single-sample latency
    when ``forward`` is given, else None. With ``save``, every batch (the
    train split: its first only) is dumped to
    ``{save_dir}/{eval_ckpt}_{split}_batch{i}.npy``. The stochastic loss
    term draws from a generator seeded with 0 at every call, so that an
    eval's loss depends on the weights only."""
    device = torch.device(device)
    generator = torch.Generator(device=device).manual_seed(0)
    tot_loss, count = 0.0, 0
    tot_terms: dict[str, float] = {}
    tot_metrics: dict[str, float] = {}
    all_ms = []

    for i, batch in enumerate(loader.epoch(0)):
        B = batch["point_cloud"].shape[0]
        b = batch_to_device(batch, device)
        loss, terms, out = eval_step(model, handler, b, weights, generator)
        out = _outputs(out)

        if forward is not None:
            all_ms.append(_single_sample_ms(model, batch["point_cloud"],
                                            device, forward))

        values = torch.stack([loss, *terms.values()]).tolist()
        tot_loss += values[0] * B
        for k, v in zip(terms, values[1:]):
            tot_terms[k] = tot_terms.get(k, 0.0) + v * B

        if metrics_handler is not None and metrics_handler.metrics:
            m = metrics_handler.compute(
                y_pred=out.traj,
                traj_as_pc=b["traj_as_pc"],
                traj_pc=b["traj_as_pc"],
                stroke_ids=batch["stroke_ids"],
                pc_mask=b["stroke_ids_as_pc"] >= 0,
                n_strokes=batch["n_strokes"],
                pred_stroke_masks=out.stroke_masks,
                mask_scores=out.mask_scores,
            )
            for k, v in m.items():
                tot_metrics[k] = tot_metrics.get(k, 0.0) + v * B

        if save and (split != "train" or i == 0):
            dump = {
                "dirnames": _batch_names(loader, split, count, B),
                "traj": np.asarray(batch["traj"]),
                "stroke_ids": np.asarray(batch["stroke_ids"]),
                "stroke_ids_as_pc": np.asarray(batch["stroke_ids_as_pc"]),
                "traj_as_pc": np.asarray(batch["traj_as_pc"]),
                "traj_pred": _output(out.traj),
                "pred_stroke_masks": _output(out.stroke_masks),
                "stroke_masks_scores": _output(out.mask_scores),
                "seg_logits": _output(out.seg_conf),
                "n_strokes": np.asarray(batch["n_strokes"]),
                "point_cloud": np.asarray(batch["point_cloud"]),
                "batch": i,
                "suffix": split,
            }
            np.save(os.path.join(save_dir,
                                 f"{eval_ckpt}_{split}_batch{i}.npy"), dump)
        count += B

    avg_terms = {k: v / count for k, v in tot_terms.items()}
    avg_metrics = {k: v / count for k, v in tot_metrics.items()}
    ms = float(np.mean(all_ms)) if all_ms else None
    if ms is not None:
        print(f"Elapsed: {round(ms, 1)}ms | FPS: {round(1000 / ms, 1)}")
    return tot_loss / count, avg_terms, avg_metrics, ms
