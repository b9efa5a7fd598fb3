"""The adversarial losses (``maskplanner_tpu/losses/gan.py``): minimax
(``discriminator``) and WGAN-GP (``wdiscriminator``).

The critic is state of its own, beside the model: :class:`CriticState`
holds its module (parameters and BatchNorm statistics) and its own Adam
(lr 1e-4, β 0.9 / 0.999, as ``optax.adam``). :class:`AdversarialLoss`
builds it (:meth:`AdversarialLoss.init_state`), updates it on a detached
prediction (:meth:`AdversarialLoss.discriminator_update`, ``discr_train_iter``
Adam steps) and gives the generator's term against it
(:meth:`AdversarialLoss.generator_loss`), whose gradient reaches the
prediction only. ``train.trainer.gan_train_step`` calls them in the JAX
step's order.

What the JAX package's functional state gives for free, made explicit:

- each train-mode pass of the update moves the BatchNorm statistics, the
  real pass and then the fake one; the penalty's pass runs in train mode
  too (batch statistics) but moves nothing (:func:`frozen_statistics`),
  as JAX drops the statistics it mutates;
- the generator's term runs the critic in eval mode on detached
  parameters (``torch.func.functional_call``), so it leaves no gradient on
  the critic, and the update's backward sees only the critic's own loss;
- the real, fake and interpolated passes of one critic step share one pair
  of dropout masks, as the JAX passes share one dropout key.

The update runs each part's backward as soon as its pass ends, so that
one critic graph is alive at a time; the gradients sum to those of the
whole loss.

In a data-parallel step (``parallel.sharded_batch``: each rank holds its
rows of the global batch, the critic replicated) the update is the single
process's at the global batch: the critic's train-mode BatchNorms take the
global moments (``parallel.mean_over_ranks``, twice differentiable, so the
penalty's double backward sums over the ranks too), the dropout masks and
the penalty's mixing weights are drawn at the global row count and each
rank keeps its rows, each part of the loss is the rank's share of the
global mean (``parallel.loss_share``), and the critic's gradients are
summed over the ranks before its Adam (``parallel.all_reduce_grads``).
"""
from __future__ import annotations

import contextlib

import torch

from ..data.pointcloud import get_dim_traj_points
from ..models import init_parameters
from ..models.dgcnn import DGCNNDiscriminator
from ..models.mlp import MLP
from ..parallel import (all_reduce_grads, global_mean, global_rows,
                        local_rows, loss_share)
from .common import bce_with_logits

LR = 1e-4
BETAS = (0.9, 0.999)
MLP_HIDDEN = (512, 256, 128)


class CriticState:
    """The critic's module and its own Adam, saved and restored as one
    (:meth:`state_dict`, :meth:`load_state_dict`)."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self.optimizer = torch.optim.Adam(module.parameters(), lr=LR,
                                          betas=BETAS, eps=1e-8)

    def state_dict(self) -> dict:
        """The parameters, the BatchNorm statistics and Adam's state, on
        the CPU."""
        from ..convert import optimizer_state

        return {"module": {k: v.detach().cpu()
                           for k, v in self.module.state_dict().items()},
                "optimizer": optimizer_state(self.optimizer)}

    def load_state_dict(self, state: dict) -> None:
        from ..convert import load_optimizer_state

        self.module.load_state_dict(state["module"], strict=True)
        load_optimizer_state(self.optimizer, state["optimizer"])


@contextlib.contextmanager
def frozen_statistics(module: torch.nn.Module):
    """Train-mode passes inside the block leave the BatchNorm statistics
    (every buffer) as they were."""
    saved = [(b, b.detach().clone()) for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for buf, value in saved:
                buf.copy_(value)


class AdversarialLoss:
    """The configured critic and its loss and update.

    ``kind``: ``discriminator`` (minimax BCE; its critic is always DGCNN)
    or ``wdiscriminator`` (WGAN-GP; DGCNN, or the MLP with
    ``discr_backbone=mlp``). ``discr_input_type``: ``pointcloud`` (the
    poses as points), ``strokecloud`` (the rows as they are) or
    ``singlestrokes`` (each of ``n_strokes`` strokes a row, centred with
    ``singlestrokes_norm``; the MLP critic and WGAN-GP only)."""

    def __init__(self, config, kind: str = "wdiscriminator"):
        self.kind = kind
        self.config = config
        self.outdim = get_dim_traj_points(config["extra_data"])
        self.input_type = config.get("discr_input_type", "pointcloud")
        self.backbone = config.get("discr_backbone", "pointnet2")
        self.lambda_gp = float(config.get("discr_lambdaGP", 10))
        self.weight_discr_training = float(
            config.get("weight_discr_training", 1.0))
        self.train_iter = int(config.get("discr_train_iter", 1))
        self.train_freq = int(config.get("discr_train_freq", 1))
        self.singlestrokes_norm = bool(config.get("singlestrokes_norm"))
        assert not (self.input_type == "singlestrokes"
                    and (self.backbone != "mlp" or kind != "wdiscriminator")), (
            'discr_input_type "singlestrokes" only supports '
            'discr_backbone "mlp" with the wdiscriminator loss')
        self.uses_mlp = kind == "wdiscriminator" and self.backbone == "mlp"

    def prepare(self, y: torch.Tensor) -> torch.Tensor:
        """The critic's input for predictions or GT ``y`` (B, S, ·)."""
        B = y.shape[0]
        if self.input_type == "pointcloud":
            return y.reshape(B, -1, self.outdim)
        if self.input_type == "strokecloud":
            return y
        if self.input_type == "singlestrokes":
            flat = y.reshape(B * self.config["n_strokes"], -1)
            if self.singlestrokes_norm:
                pts = flat.reshape(flat.shape[0], -1, self.outdim)
                flat = (pts - pts.mean(dim=1, keepdim=True)).reshape(
                    flat.shape[0], -1)
            return flat
        raise ValueError(self.input_type)

    def init_state(self, y_example: torch.Tensor, device,
                   generator: torch.Generator | None = None) -> CriticState:
        """A fresh critic for inputs like ``y_example`` on ``device``, its
        weights drawn from ``generator`` (PyTorch's default init)."""
        width = self.prepare(torch.as_tensor(y_example)).shape[-1]
        if self.uses_mlp:
            module = MLP(width, MLP_HIDDEN, 1)
        else:
            module = DGCNNDiscriminator(width,
                                        k=int(self.config.get("knn_gcn", 20)))
        init_parameters(module, generator or torch.Generator().manual_seed(0))
        return CriticState(module.to(device))

    def _critic(self, critic: CriticState, x: torch.Tensor, masks):
        if self.uses_mlp:
            return critic.module(x)
        return critic.module(x, masks)

    def gradient_penalty(self, critic: CriticState, real: torch.Tensor,
                         fake: torch.Tensor, eps: torch.Tensor,
                         masks=None) -> torch.Tensor:
        """``discr_lambdaGP`` · mean (‖∇ critic(x̂)‖ − 1)² at x̂ = eps · real
        + (1 − eps) · fake, the critic in train mode on the whole batch
        (batch statistics, its statistics left as they are), the gradient
        taken with ``create_graph`` so that the penalty's own gradient
        reaches the critic's parameters."""
        interp = (eps * real + (1 - eps) * fake).detach().requires_grad_(True)
        with frozen_statistics(critic.module):
            out = self._critic(critic, interp, masks)
        (grads,) = torch.autograd.grad(out.sum(), interp, create_graph=True)
        gnorm = torch.sqrt((grads.reshape(grads.shape[0], -1) ** 2).sum(-1)
                           + 1e-12)
        return self.lambda_gp * ((gnorm - 1.0) ** 2).mean()

    def discriminator_update(self, critic: CriticState, y_pred: torch.Tensor,
                             y: torch.Tensor,
                             generator: torch.Generator | None = None,
                             eps: torch.Tensor | None = None) -> torch.Tensor:
        """``discr_train_iter`` Adam steps of the critic on the detached
        prediction and GT -> the last step's loss (detached). Each step
        draws its dropout masks and, for WGAN-GP, the penalty's mixing
        weights (B, 1, ...) from ``generator``; ``eps`` (train_iter, B, 1,
        ...) gives the weights instead. In a data-parallel step (the
        module's docstring) ``y_pred`` and ``y`` are this rank's rows, the
        draws and ``eps`` the global batch's, and the loss the global
        value."""
        real = self.prepare(y.detach())
        fake = self.prepare(y_pred.detach())
        module = critic.module
        module.train()
        w = self.weight_discr_training
        eps_shape = (global_rows(real.shape[0]),) + (1,) * (real.dim() - 1)
        for it in range(self.train_iter):
            critic.optimizer.zero_grad(set_to_none=True)
            masks = (None if self.uses_mlp else module.dropout_masks(
                real.shape[0], generator, real.device))
            out_r = self._critic(critic, real, masks)
            if self.kind == "discriminator":
                part_r = w * bce_with_logits(out_r, torch.ones_like(out_r)
                                             ).mean()
            else:
                part_r = -w * out_r.mean()
            loss_share(part_r).backward()
            out_f = self._critic(critic, fake, masks)
            if self.kind == "discriminator":
                part_f = w * bce_with_logits(out_f, torch.zeros_like(out_f)
                                             ).mean()
            else:
                part_f = w * out_f.mean()
            loss_share(part_f).backward()
            loss = part_r.detach() + part_f.detach()
            if self.kind != "discriminator":
                mix = local_rows(eps[it] if eps is not None else torch.rand(
                    eps_shape, generator=generator, device=real.device))
                gp = self.gradient_penalty(critic, real, fake, mix, masks)
                loss_share(gp).backward()
                loss = loss + gp.detach()
            all_reduce_grads(module.parameters())
            critic.optimizer.step()
        return global_mean(loss)

    def generator_loss(self, critic: CriticState,
                       y_pred: torch.Tensor) -> torch.Tensor:
        """The generator's term: the critic in eval mode on its detached
        parameters (the gradient reaches ``y_pred`` only): BCE against
        "real" for minimax, −mean(critic) for WGAN-GP."""
        module = critic.module
        module.eval()
        params = {n: p.detach() for n, p in module.named_parameters()}
        buffers = dict(module.named_buffers())
        out = torch.func.functional_call(module, (params, buffers),
                                         (self.prepare(y_pred),))
        if self.kind == "discriminator":
            return bce_with_logits(out, torch.ones_like(out)).mean()
        return -out.mean()
