"""Batched linear assignment (``maskplanner_tpu/ops/hungarian.py`` and the
Pallas kernel ``ops/pallas/lap.py``).

:func:`lap_plain` is the Jonker-Volgenant shortest-augmenting-path solver
with the update rules of the JAX package's ``_solve_square`` (scipy's
``rectangular_lsap`` scheme), vectorised over the batch: every problem
advances in lockstep, a finished one is masked out, as the Pallas kernel
does. A CUDA tensor goes to the kernel (``ops/cuda/lap.py``), a CPU tensor
to :func:`lap_plain`. :func:`hungarian` pads rectangular or masked problems
to square with one large constant and inverts the permutation.

The assignment is cost-optimal; on exact ties it may be another
equal-cost permutation than scipy's.
"""
from __future__ import annotations

import torch

_INF = 1e18


def lap_plain(cost: torch.Tensor, stats: dict | None = None) -> torch.Tensor:
    """(B, n, n) float32 costs -> col4row (B, n) int32, the column assigned
    to each row. ``stats``: if given, ``stats["steps"]`` counts the Dijkstra
    steps the problems took (the work this data needs)."""
    B, n, _ = cost.shape
    dev = cost.device
    cost = cost.detach().float()
    rows = torch.arange(B, device=dev)
    cols = torch.arange(n, device=dev)
    u = torch.zeros(B, n, device=dev)
    v = torch.zeros(B, n, device=dev)
    col4row = torch.full((B, n), -1, dtype=torch.long, device=dev)
    row4col = torch.full((B, n), -1, dtype=torch.long, device=dev)
    for cur in range(n):
        shortest = torch.full((B, n), _INF, device=dev)
        path = torch.full((B, n), -1, dtype=torch.long, device=dev)
        s_cols = torch.zeros(B, n, dtype=torch.bool, device=dev)
        s_rows = torch.zeros(B, n, dtype=torch.bool, device=dev)
        i = torch.full((B,), cur, dtype=torch.long, device=dev)
        sink = torch.full((B,), -1, dtype=torch.long, device=dev)
        minval = torch.zeros(B, device=dev)
        # Dijkstra over the columns from row `cur`, every problem in step
        for _ in range(n):
            live = sink < 0
            n_live = int(live.sum())
            if n_live == 0:
                break
            if stats is not None:
                stats["steps"] = stats.get("steps", 0) + n_live
            s_rows[rows, i] |= live
            d = ((minval[:, None] + cost[rows, i]) - u[rows, i][:, None]) - v
            better = (d < shortest) & ~s_cols & live[:, None]
            shortest = torch.where(better, d, shortest)
            path = torch.where(better, i[:, None], path)
            cand = torch.where(s_cols, _INF, shortest)
            j = torch.argmin(cand, dim=-1)             # ties: lowest column
            minval = torch.where(live, cand[rows, j], minval)
            s_cols[rows, j] |= live
            nxt = row4col[rows, j]
            sink = torch.where(live & (nxt < 0), j, sink)
            i = torch.where(live & (nxt >= 0), nxt, i)
        # potentials
        u[:, cur] += minval
        other = s_rows & (cols != cur)[None, :]
        delta = minval[:, None] - shortest.gather(1, col4row.clamp(min=0))
        u = torch.where(other, u + delta, u)
        v = torch.where(s_cols, (v + shortest) - minval[:, None], v)
        # augment along the alternating path that ends at the sink
        j = sink
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        for _ in range(n):
            i = path[rows, j]
            go = ~done
            row4col[rows, j] = torch.where(go, i, row4col[rows, j])
            prev = col4row[rows, i]
            col4row[rows, i] = torch.where(go, j, col4row[rows, i])
            done = done | (i == cur)
            if bool(done.all()):
                break
            j = torch.where(done, j, prev)
    return col4row.to(torch.int32)


def lap(cost: torch.Tensor) -> torch.Tensor:
    """(B, n, n) square costs -> col4row (B, n) int32."""
    if cost.device.type == "cuda":
        from .cuda.lap import lap_cuda

        return lap_cuda(cost.detach())
    if cost.device.type == "cpu":
        return lap_plain(cost)
    raise ValueError(f"no LAP solver for device {cost.device}")


def hungarian(cost: torch.Tensor, col_mask: torch.Tensor | None = None):
    """(..., n_rows, n_cols) costs (n_rows >= n_cols after masking), optional
    (..., n_cols) column validity -> (row4col (..., n_cols) int64, matched
    (..., n_cols) bool). With k valid columns, the k best rows are matched
    to them at minimal total cost."""
    *batch, n_rows, n_cols = cost.shape
    n = max(n_rows, n_cols)
    flat = cost.detach().reshape(-1, n_rows, n_cols).float()
    bf = flat.shape[0]
    # fake rows and columns cost the same `big` everywhere, so the real
    # columns' optimal assignment is unchanged; big > n * max|cost|
    finite = torch.where(torch.isfinite(flat), flat, 0.0)
    big = finite.abs().amax(dim=(-1, -2), keepdim=True) * (2.0 * n) + 1.0
    sq = big.expand(bf, n, n).clone()
    real = flat
    mask = None
    if col_mask is not None:
        mask = col_mask.reshape(-1, n_cols)
        real = torch.where(mask[:, None, :], real, big)
    sq[:, :n_rows, :n_cols] = real
    col4row = lap(sq).long()                                    # (bf, n)
    row4col = torch.empty_like(col4row)
    row4col.scatter_(1, col4row, torch.arange(n, device=cost.device)
                     .expand(bf, n).contiguous())
    row4col = row4col[:, :n_cols]
    matched = (mask if mask is not None
               else torch.ones(bf, n_cols, dtype=torch.bool,
                               device=cost.device))
    return (row4col.reshape(*batch, n_cols), matched.reshape(*batch, n_cols))
