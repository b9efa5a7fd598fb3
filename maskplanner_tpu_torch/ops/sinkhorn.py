"""Entropic optimal transport for the EMD of large sets
(``maskplanner_tpu/ops/sinkhorn.py``).

Log-domain Sinkhorn with a fixed number of iterations, batched, in plain
PyTorch: no host sync and no data-dependent control flow, so a CUDA graph
captures it. The potentials and the transport plan are constants of the
backward (the envelope gradient, exact at convergence): only the
transport-weighted cost is differentiated.
"""
from __future__ import annotations

import math

import torch

from ..parallel import global_sum

_NEG_INF = -1e30


def log_sinkhorn_potentials(cost, log_a, log_b, eps: float, iters: int):
    """cost (B, N, M); log_a (B, N), log_b (B, M) log marginals (the
    −1e30 sentinel where masked) -> the potentials f (B, N), g (B, M)
    after ``iters`` alternating updates."""
    B, N, M = cost.shape
    f = cost.new_zeros((B, N))
    g = cost.new_zeros((B, M))
    for _ in range(iters):
        f = -eps * torch.logsumexp((g[:, None, :] - cost) / eps
                                   + log_b[:, None, :], dim=-1)
        f = torch.where(log_a > _NEG_INF / 2, f, 0.0)
        g = -eps * torch.logsumexp((f[:, :, None] - cost) / eps
                                   + log_a[:, :, None], dim=-2)
        g = torch.where(log_b > _NEG_INF / 2, g, 0.0)
    return f, g


def transport_plan(cost, log_a, log_b, f, g, eps: float):
    """P_ij = exp((f_i + g_j − C_ij) / eps + log a_i + log b_j)."""
    logits = ((f[:, :, None] + g[:, None, :] - cost) / eps
              + log_a[:, :, None] + log_b[:, None, :])
    return torch.exp(torch.clamp(logits, _NEG_INF, 30.0))


def masked_log_marginals(mask, n: int, batch: int, device):
    """Uniform log marginals over the valid entries (the sentinel on the
    masked ones)."""
    if mask is None:
        return torch.full((batch, n), -math.log(float(n)), device=device)
    count = torch.clamp(mask.sum(-1, keepdim=True), min=1).float()
    return torch.where(mask, -torch.log(count), _NEG_INF)


def sinkhorn_emd(y_pred, y, y_mask=None, x_mask=None, eps: float = 0.005,
                 iters: int = 60):
    """Soft EMD between batched sets: per sample the transport-weighted
    squared distance (the mean matched squared distance as eps -> 0),
    averaged over the batch. The cost is normalised by its mean over the
    valid pairs before the iterations, so that ``eps`` is relative."""
    B, N, _ = y_pred.shape
    M = y.shape[1]
    y_valid = y if y_mask is None else torch.where(y_mask[..., None], y, 0.0)
    cost = ((y_pred[:, :, None, :] - y_valid[:, None, :, :]) ** 2).sum(-1)
    if y_mask is not None:
        cost = torch.where(y_mask[:, None, :], cost, 1e6)
    if x_mask is not None:
        cost = torch.where(x_mask[:, :, None], cost, 1e6)
    log_a = masked_log_marginals(x_mask, N, B, cost.device)
    log_b = masked_log_marginals(y_mask, M, B, cost.device)

    c0 = cost.detach()
    valid = torch.ones_like(c0, dtype=torch.bool)
    if y_mask is not None:
        valid = valid & y_mask[:, None, :]
    if x_mask is not None:
        valid = valid & x_mask[:, :, None]
    scale = torch.clamp(global_sum(torch.where(valid, c0, 0.0).sum())
                        / torch.clamp(global_sum(valid.sum()), min=1),
                        min=1e-8)
    f, g = log_sinkhorn_potentials(c0 / scale, log_a, log_b, eps, iters)
    plan = transport_plan(c0 / scale, log_a, log_b, f, g, eps)
    return (plan * cost).sum((-1, -2)).mean()
