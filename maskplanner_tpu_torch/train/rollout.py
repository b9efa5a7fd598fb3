"""Autoregressive stroke rollout from start-of-path tokens
(``maskplanner_tpu/train/rollout.py``).

The JAX package runs the rollout as one ``lax.scan``; here it is a loop of
``max_rollout_steps`` eval-mode calls of the rollout head
(``models.MLPRegressor`` with its confidence output, the ``mlp_rollout``
backbone). Each call takes every stroke's token and its history of the
last ``history_length`` predictions, a (n_strokes, H, D) window that
shifts by one each step, and all of a sample's strokes roll out side by
side.
"""
from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def sample_autoregressive_inference_sop(
        model: nn.Module, sops: torch.Tensor, history_length: int,
        output_length: int, max_rollout_steps: int,
        object_features: torch.Tensor | None = None):
    """Roll out strokes from start-of-path tokens.

    ``model(x)`` in eval mode must return ``(next_token (n, 1, D),
    eop_logits (n, 1, 1))``. ``sops``: (n_strokes, prototype_dim) on the
    model's device; ``object_features``: an optional (latent,) vector
    appended to every stroke's input.

    Returns (paths (n_strokes, steps, D), eop_logits (n_strokes, steps,
    1))."""
    if model.training:
        raise ValueError("the rollout runs the model in eval mode")
    n_strokes = sops.shape[0]
    H, D = history_length, output_length
    sops = sops.to(torch.float32)
    tail = [] if object_features is None else [
        object_features.to(sops)[None, :].expand(n_strokes, -1)]
    history = sops.new_zeros((n_strokes, H, D))
    paths, eops = [], []
    for _ in range(max_rollout_steps):
        x = torch.cat([sops, history.reshape(n_strokes, -1), *tail], dim=1)
        nxt, eop = model(x)
        nxt = nxt.reshape(n_strokes, 1, D)
        history = torch.cat([history[:, 1:], nxt], dim=1)
        paths.append(nxt[:, 0])
        eops.append(eop.reshape(n_strokes))
    return torch.stack(paths, dim=1), torch.stack(eops, dim=1)[..., None]
