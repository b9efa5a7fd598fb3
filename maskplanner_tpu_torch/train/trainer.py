"""The training and eval steps and the training epochs
(``maskplanner_tpu/train/trainer.py``).

One step: the train forward (random FPS starts and dropout masks from an
explicit generator), the loss (whose stochastic term draws from the same
generator), the backward, ``torch.optim.Adam`` (β 0.9 /
0.999, eps 1e-8, as ``optax.adam``) on the f32 parameters, and the
BatchNorm running statistics, which the forward moves in place. A bf16
model's forward and backward both sum their bf16 products in f32
(``models.maskplanner.f32_accumulation``), as the JAX reference does.

:func:`gan_train_step` is the step of a recipe with an adversarial term
(``make_gan_train_step``): the same step against the current critic, then
the critic's update on the detached prediction, in a process group too.

An epoch runs the step over the host loader's batches (:func:`host_epoch`)
or over a split staged on the device (:class:`DeviceEpoch`, the JAX
package's ``make_scan_train_epoch``): there each step gathers its batch on
the device, and on the card the whole step is one CUDA graph replay.

In a process group (``parallel``: one process a card, each with its rows
of the global batch) :func:`train_step` is the single-process step at the
global batch: the forward, the loss and the backward run inside
``parallel.sharded_batch`` (global BatchNorm statistics, draws and loss
normalisers), each rank's loss is its share of the global loss, the
gradients are summed over the ranks in one all-reduce before Adam, and the
loss and terms it returns are the global values. :class:`DeviceEpoch`'s
ranks each hold the whole staged split and gather their rows of each
step's batch.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from ..losses import LossHandler
from ..losses.common import at_least_f32
from ..models import MaskPlannerOutput
from ..models.maskplanner import f32_accumulation
from ..parallel import (all_reduce_grads, collective_warm_up, global_rows,
                        global_values, local_rows, loss_share, sharded_batch)


def make_optimizer(model: torch.nn.Module, config) -> torch.optim.Adam:
    """Adam on the model's parameters. On the card it is ``capturable``,
    with the LR a 0-d tensor on the card, so that a CUDA graph of the step
    reads the step count and the LR that the LR scheduler writes in place
    between epochs; on the CPU the LR is a float."""
    lr = float(config["lr"])
    device = next(model.parameters()).device
    if device.type == "cuda":
        return torch.optim.Adam(model.parameters(),
                                lr=torch.tensor(lr, device=device),
                                betas=(0.9, 0.999), eps=1e-8,
                                capturable=True)
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


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
    detached tensors (no host sync). In a process group ``batch`` is this
    rank's rows of the global batch, and the step is the global batch's
    (the module's docstring)."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with f32_accumulation(), sharded_batch():
        out = model(batch["point_cloud"], generator=generator)
        total, terms = handler.compute(weights, generator=generator,
                                       **build_loss_batch(out, batch))
        loss_share(total).backward()
        all_reduce_grads(model.parameters())
        loss, terms = global_values(
            total.detach(), {k: v.detach() for k, v in terms.items()})
    optimizer.step()
    return loss, terms


def gan_train_step(model, optimizer, handler: LossHandler, batch, weights,
                   generator: torch.Generator | None = None, *, adv,
                   critic, step: int):
    """One step with an adversarial term (``make_gan_train_step``) -> (loss,
    terms), detached; ``adv``: the ``losses.gan.AdversarialLoss``,
    ``critic``: its ``CriticState``, updated in place; ``step``: the steps
    the run has taken before this one (the JAX step's ``state.step``).

    One train forward; the loss, its adversarial term against the current
    critic (eval mode, no gradient on the critic); the backward and Adam's
    step; then, when ``step`` is a multiple of ``discr_train_freq``, the
    critic's update on the detached prediction
    and the GT (``discriminator_update``). ``terms["d_internal"]`` is the
    update's loss, 0 on a step without one.

    In a process group, as :func:`train_step`: ``batch`` is this rank's
    rows, the generator's gradients are summed over the ranks before Adam,
    and the critic, replicated on every rank, takes the single process's
    update at the global batch (``losses.gan``); the loss and terms
    returned are the global values."""
    model.train()
    optimizer.zero_grad(set_to_none=True)
    with f32_accumulation(), sharded_batch():
        out = model(batch["point_cloud"], generator=generator)
        lb = build_loss_batch(out, batch)
        total, terms = handler.compute(weights, generator=generator,
                                       gan_module=adv, gan_state=critic,
                                       **lb)
        loss_share(total).backward()
        all_reduce_grads(model.parameters())
        loss, terms = global_values(
            total.detach(), {k: v.detach() for k, v in terms.items()})
    optimizer.step()
    with sharded_batch():
        if step % adv.train_freq == 0:
            terms["d_internal"] = adv.discriminator_update(
                critic, lb["y_pred"].detach(), lb["y"], generator)
        else:
            terms["d_internal"] = torch.zeros((), device=total.device)
    return loss, terms


def forward(model, point_cloud: torch.Tensor):
    """The eval forward (``make_forward``): eval mode (running BatchNorm
    statistics, FPS from index 0, no dropout), no autograd, bf16 products
    summed in f32."""
    model.eval()
    with torch.no_grad(), f32_accumulation():
        return model(point_cloud)


def eval_step(model, handler: LossHandler, batch, weights,
              generator: torch.Generator | None = None):
    """The loss on the eval forward -> (loss, terms, outputs).
    ``generator``: the stochastic loss term's draw."""
    out = forward(model, batch["point_cloud"])
    with torch.no_grad():
        total, terms = handler.compute(weights, generator=generator,
                                       **build_loss_batch(out, batch))
    return total, terms, out


def host_epoch(model, optimizer, handler: LossHandler, batches, weights,
               generator: torch.Generator | None = None,
               step_fn=train_step):
    """One epoch over ``batches`` (on the model's device) -> (the per-step
    losses (steps,), {term: per-step values (steps,)}), on the device."""
    losses, terms = [], []
    for batch in batches:
        loss, t = step_fn(model, optimizer, handler, batch, weights,
                          generator)
        losses.append(loss)
        terms.append(t)
    return torch.stack(losses), {k: torch.stack([t[k] for t in terms])
                                 for k in terms[0]}


def subsample_points(pc: torch.Tensor, n: int,
                     generator: torch.Generator | None) -> torch.Tensor:
    """(B, N, 3) clouds -> (B, n, 3): a fresh subset of ``n`` points of each
    cloud, without replacement, drawn on the clouds' device from
    ``generator`` (the on-device ``pc_online_subsampling``; over the
    global batch in a data-parallel step, of which this rank keeps its
    rows)."""
    keys = local_rows(torch.rand((global_rows(pc.shape[0]), pc.shape[1]),
                                 generator=generator, device=pc.device))
    pick = keys.argsort(dim=-1)[:, :n]
    return torch.take_along_dim(pc, pick[..., None], dim=1)


def gather_batch(data: dict, idx: torch.Tensor, pc_points: int,
                 generator: torch.Generator | None) -> dict:
    """The rows ``idx`` of the staged split; clouds staged wider than
    ``pc_points`` are subsampled (:func:`subsample_points`)."""
    batch = {k: v.index_select(0, idx) for k, v in data.items()}
    if batch["point_cloud"].shape[1] > pc_points:
        batch["point_cloud"] = subsample_points(batch["point_cloud"],
                                                pc_points, generator)
    return batch


class DeviceEpoch:
    """Epochs over a split staged on the model's device
    (``data.device_dataset``): the JAX package's ``make_scan_train_epoch``.

    :meth:`run` takes an epoch's (steps, batch) index matrix
    (``data.device_dataset.epoch_perm``), copies it to the device once and
    runs its steps; each step gathers its batch by a row of it on the
    device (:func:`gather_batch`), runs ``step_fn`` (:func:`train_step`)
    and writes its loss and terms into device buffers, so the host syncs
    once an epoch, when it reads them.

    On the CPU, or with ``graphed=False``, the steps run eagerly. On the
    card they run as one CUDA graph: the first step ever runs eagerly on a
    side stream (the warm-up, a real step), then the step is captured, with
    the run's generator registered with the graph (a replay draws what the
    eager step would draw from the generator's state, and advances it
    alike), and every later step is a replay. The batch, the step index,
    the loss weights (``losses.DeviceWeights``), Adam's step count and LR
    (``make_optimizer``) are tensors that the graph reads at replay. A
    capture that fails raises: there is no eager fallback. A replay runs
    no Python, so the kernel wrappers' ``launches`` counts see the warm-up
    and the capture and no replay.

    In a process group every rank holds the whole split (the JAX package
    replicates it) and each step gathers this rank's rows of its row of
    ``perm`` (``parallel.local_rows``); the step's collectives are in the
    graph, after one collective outside it (``collective_warm_up``)."""

    def __init__(self, model, optimizer, handler: LossHandler, data: dict,
                 weights, generator: torch.Generator | None,
                 pc_points: int, graphed: bool | None = None,
                 step_fn=train_step):
        device = data["point_cloud"].device
        if graphed is None:
            graphed = device.type == "cuda"
        if graphed and device.type != "cuda":
            raise ValueError("a CUDA graph needs the split on a card")
        self.model, self.optimizer, self.handler = model, optimizer, handler
        self.data, self.weights, self.generator = data, weights, generator
        self.pc_points = int(pc_points)
        self.graphed = graphed
        self.step_fn = step_fn
        self.device = device
        self.perm = None
        self.counter = torch.zeros((), dtype=torch.int64, device=device)
        self.losses = self.terms = None
        self.graph = None
        self.pool_bytes = 0

    def _step(self) -> None:
        """The step at ``counter``, its loss and terms into the buffers."""
        at = self.counter.view(1)
        with sharded_batch():
            idx = local_rows(self.perm.index_select(0, at).view(-1))
            batch = gather_batch(self.data, idx, self.pc_points,
                                 self.generator)
        loss, terms = self.step_fn(self.model, self.optimizer, self.handler,
                                   batch, self.weights, self.generator)
        if self.losses is None:
            steps = self.perm.shape[0]
            self.losses = torch.zeros(steps, dtype=loss.dtype,
                                      device=self.device)
            self.terms = {k: torch.zeros(steps, dtype=v.dtype,
                                         device=self.device)
                          for k, v in terms.items()}
        self.losses.index_copy_(0, at, loss.view(1))
        for k, v in terms.items():
            self.terms[k].index_copy_(0, at, v.view(1))
        self.counter += 1

    def _warm_up_and_capture(self) -> None:
        collective_warm_up(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)

        # what the capture allocates comes from the graph's private pool:
        # its size is the memory reserved after less before, once the
        # cache is emptied (as the capture itself empties it)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        try:
            with torch.cuda.graph(graph):
                self._step()
        except Exception as exc:
            raise RuntimeError("capturing the training step as a CUDA graph "
                               "failed") from exc
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph = graph
        print(f"training step captured as a CUDA graph: private pool "
              f"{self.pool_bytes / 2**20:.1f} MiB")

    def close(self) -> None:
        """Drop the captured graph (a later :meth:`run` captures anew). A
        graph that holds a collective of a group of several ranks keeps
        NCCL's resources, and destroying the group waits for every such
        graph to go: a grouped epoch is closed before its group is
        destroyed."""
        if self.graph is not None:
            torch.cuda.synchronize(self.device)
            self.graph = None

    def run(self, perm: np.ndarray):
        """One epoch over the (steps, batch) index matrix ``perm`` -> (the
        per-step losses (steps,), {term: per-step values (steps,)}), on
        the device."""
        perm = torch.from_numpy(np.asarray(perm, dtype=np.int64))
        if self.perm is None:
            self.perm = torch.empty(perm.shape, dtype=torch.int64,
                                    device=self.device)
        elif self.perm.shape != perm.shape:
            raise ValueError(f"an epoch of {tuple(perm.shape)} steps x batch "
                             f"after {tuple(self.perm.shape)}")
        self.perm.copy_(perm)
        self.counter.zero_()
        for _ in range(perm.shape[0]):
            if not self.graphed:
                self._step()
            elif self.graph is None:
                self._warm_up_and_capture()
            else:
                self.graph.replay()
        return self.losses.clone(), {k: v.clone()
                                     for k, v in self.terms.items()}
