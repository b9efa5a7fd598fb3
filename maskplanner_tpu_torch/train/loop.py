"""The eval loop and its prediction dumps (``maskplanner_tpu/train/loop.py``).

Per batch: the eval loss (one host sync for the loss and its terms), the
metrics, optionally the single-sample latency, and a ``.npy`` dump in the
format that ``render_results.py`` and ``standalone/`` read with
``np.load(..., allow_pickle=True).item()``: a dict of numpy arrays on the
host (float32 outputs), ``None`` where an output is absent: a model with
a plain segment output (``models.PointNet2Regressor``) has no masks, mask
scores or segment confidences, and its metrics get none.

In a process group every rank evaluates, as the JAX loop does under its
mesh: a batch whose row count divides over the ranks is sharded, and any
other batch (a trailing partial one) runs whole (``evaluate``).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..metrics import MetricsHandler
from ..models import MaskPlannerOutput
from ..parallel import (gather_rows, global_values, rank_and_world,
                        shard_rows, sharded_batch, sum_over_ranks)
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
    """An output of this rank's rows -> the batch's rows on the host, f32
    (:func:`parallel.gather_rows` inside a sharded batch)."""
    return None if t is None else gather_rows(t.float()).cpu().numpy()


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
    eval's loss depends on the weights only.

    In a process group every rank calls it with the same loader (the
    global batches) and gets the same averages, the single process's up
    to the order of float sums. A batch whose row count divides over the
    ranks is sharded (``parallel.shard_rows``): each rank runs the loss on
    its rows inside ``parallel.sharded_batch``, so that the loss's
    batch-spanning normalisers and its draws are the global batch's, and
    ``parallel.global_values`` gives every rank the global loss and terms.
    Any other batch every rank runs whole, so that the ranks' generators
    draw alike, and rank 0 alone counts it. Each rank sums its metrics by
    its row count; one all-reduce adds the ranks' sums at the end (every
    metric is a mean over rows). Rank 0 alone writes the dumps, of every
    row (``parallel.gather_rows``), and times the latency (``ms`` is None
    on the other ranks)."""
    device = torch.device(device)
    rank, world = rank_and_world()
    generator = torch.Generator(device=device).manual_seed(0)
    tot_loss, count = 0.0, 0
    tot_terms: dict[str, float] = {}
    tot_metrics: dict[str, float] = {}
    all_ms = []
    scored = metrics_handler is not None and bool(metrics_handler.metrics)

    for i, batch in enumerate(loader.epoch(0)):
        B = batch["point_cloud"].shape[0]
        sharded = B % world == 0
        own = ({k: shard_rows(v, rank, world) for k, v in batch.items()}
               if sharded else batch)
        # the loss is the global batch's on every rank: rank 0 counts it
        share = B if rank == 0 else 0
        rows = B // world if sharded else share
        b = batch_to_device(own, device)
        dumped = save and (split != "train" or i == 0)
        with sharded_batch() if sharded else contextlib.nullcontext():
            loss, terms, out = eval_step(model, handler, b, weights,
                                         generator)
            loss, terms = global_values(loss, terms)
            out = _outputs(out)
            # a sharded batch's gather needs every rank; a whole one only
            # rank 0's copy
            if dumped and (sharded or rank == 0):
                outputs = {name: _output(t) for name, t in (
                    ("traj_pred", out.traj),
                    ("pred_stroke_masks", out.stroke_masks),
                    ("stroke_masks_scores", out.mask_scores),
                    ("seg_logits", out.seg_conf))}

        if forward is not None and rank == 0:
            all_ms.append(_single_sample_ms(model, batch["point_cloud"],
                                            device, forward))

        values = torch.stack([loss, *terms.values()]).tolist()
        tot_loss += values[0] * share
        for k, v in zip(terms, values[1:]):
            tot_terms[k] = tot_terms.get(k, 0.0) + v * share

        if scored and rows:
            m = metrics_handler.compute(
                y_pred=out.traj,
                traj_as_pc=b["traj_as_pc"],
                traj_pc=b["traj_as_pc"],
                stroke_ids=own["stroke_ids"],
                pc_mask=b["stroke_ids_as_pc"] >= 0,
                n_strokes=own["n_strokes"],
                pred_stroke_masks=out.stroke_masks,
                mask_scores=out.mask_scores,
            )
            for k, v in m.items():
                tot_metrics[k] = tot_metrics.get(k, 0.0) + v * rows

        if dumped and rank == 0:
            dump = {
                "dirnames": _batch_names(loader, split, count, B),
                "traj": np.asarray(batch["traj"]),
                "stroke_ids": np.asarray(batch["stroke_ids"]),
                "stroke_ids_as_pc": np.asarray(batch["stroke_ids_as_pc"]),
                "traj_as_pc": np.asarray(batch["traj_as_pc"]),
                **outputs,
                "n_strokes": np.asarray(batch["n_strokes"]),
                "point_cloud": np.asarray(batch["point_cloud"]),
                "batch": i,
                "suffix": split,
            }
            np.save(os.path.join(save_dir,
                                 f"{eval_ckpt}_{split}_batch{i}.npy"), dump)
        count += B

    if world > 1:
        names = metrics_handler.output_names() if scored else []
        summed = sum_over_ranks(
            [tot_loss, *tot_terms.values(),
             *(tot_metrics.get(k, 0.0) for k in names)])
        tot_loss = summed[0]
        tot_terms = dict(zip(tot_terms, summed[1:]))
        tot_metrics = dict(zip(names, summed[1 + len(tot_terms):]))
    avg_terms = {k: v / count for k, v in tot_terms.items()}
    avg_metrics = {k: v / count for k, v in tot_metrics.items()}
    ms = float(np.mean(all_ms)) if all_ms else None
    if ms is not None:
        print(f"Elapsed: {round(ms, 1)}ms | FPS: {round(1000 / ms, 1)}")
    return tot_loss / count, avg_terms, avg_metrics, ms
