"""Process groups and the collectives of data-parallel training
(``maskplanner_tpu/parallel/mesh.py``).

One process a card (``torchrun --nproc_per_node=N``), each holding
``batch_size / N`` rows of the global batch. The JAX package's step is one
program over the global batch; here each process runs the step on its own
rows, and these functions make the result that program's:

- BatchNorm statistics over the global batch (:func:`mean_over_ranks`
  through :func:`all_reduce_mean`, whose forward and backward are each one
  all-reduce, so that every rank's cotangents reach every rank's rows);
- random draws over the global batch: inside :func:`sharded_batch` a draw
  is made at :func:`global_rows` on every rank from the same seeded
  generator, and :func:`local_rows` keeps the rank's own rows;
- the loss's normalisers that span the batch (:func:`batch_count`,
  :func:`global_sum`, :func:`global_mean`): each rank's loss is its share
  of the global loss (:func:`loss_share`), whose sum over the ranks is the
  global loss, and the gradients are summed (:func:`all_reduce_grads`).

The eval (``train.loop.evaluate``) shards each batch that divides over
the ranks the same way, inside :func:`sharded_batch`: the loss takes the
same normalisers, and :func:`gather_rows` collects the rows' outputs for
rank 0's dumps; :func:`sum_over_ranks` adds the ranks' row-weighted
metric sums at its end.

Outside :func:`sharded_batch` (no process group, or a batch that does not
divide) every function is the identity, so an ungrouped run computes what
it did before, bit for bit; a group of one process runs the collectives
on unchanged values.

``make_multislice_mesh`` and its sharding helpers
(``maskplanner_tpu/parallel/mesh.py:135-169``) have no counterpart: one
NCCL communicator spans the nodes of a multi-node launch, and NCCL routes
its all-reduce in a hierarchy (within a node over NVLink, across nodes
over the network) without a second mesh axis.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

# (rank, world) while a sharded batch is being processed, else None
_SHARDED: tuple[int, int] | None = None


def distributed_init(init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None,
                     device: torch.device | str | None = None,
                     backend: str | None = None) -> tuple[int, int]:
    """Join the process group -> (rank, world size).

    With ``world_size`` given, a group of that size is made at
    ``init_method`` (a ``file://`` or ``tcp://localhost:PORT`` store) with
    ``rank``. Otherwise torchrun's environment is read (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR``/``MASTER_PORT``
    through ``env://``): with ``WORLD_SIZE`` unset or 1 nothing is done and
    ``(0, 1)`` returned. ``device``: the process's device (on a card its
    index defaults to ``LOCAL_RANK``); NCCL on a card, gloo on the CPU,
    unless ``backend`` says otherwise (gloo also reduces CUDA tensors). A
    process already in a group gets that group's (rank, world size)."""
    if grouped():
        return rank_and_world()
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size <= 1:
            return 0, 1
        rank = int(os.environ["RANK"])
        init_method = init_method or "env://"
    if rank is None:
        raise ValueError("a group of a given world size needs a rank")
    device = torch.device(device or "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            # the communicator is made now, never inside a graph's capture
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def grouped() -> bool:
    """Whether this process is in a process group."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the group, (0, 1) without one."""
    if not grouped():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_shard_bounds(n: int, process_index: int | None = None,
                      process_count: int | None = None) -> tuple[int, int]:
    """Contiguous ``[start, stop)`` of this process's shard of ``n`` items
    (``maskplanner_tpu/parallel/mesh.py:110-134``): equal shards (floor
    division), the at most ``process_count - 1`` trailing items dropped;
    this rank's of the group by default."""
    r, w = rank_and_world()
    pi = r if process_index is None else process_index
    pc = w if process_count is None else process_count
    per = n // pc
    return pi * per, (pi + 1) * per


@contextlib.contextmanager
def sharded_batch():
    """The block processes this rank's rows of a global batch (a training
    step, the gather of its batch): inside it the functions below act
    over the group. Yields the world size (1 without a group)."""
    global _SHARDED
    previous = _SHARDED
    if grouped():
        _SHARDED = rank_and_world()
    try:
        yield 1 if _SHARDED is None else _SHARDED[1]
    finally:
        _SHARDED = previous


def global_rows(rows: int) -> int:
    """A rank's row count -> the global batch's (the size a draw is made
    at); the same outside :func:`sharded_batch`."""
    return rows if _SHARDED is None else rows * _SHARDED[1]


def shard_rows(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous ``len(x) / world`` leading rows of ``x``
    (the JAX package's batch sharding on the leading axis)."""
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not divide over {world} "
                         f"ranks")
    per = x.shape[0] // world
    return x[rank * per:(rank + 1) * per]


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global tensor (``shard_batch``,
    ``shard_batch_global``); ``x`` outside :func:`sharded_batch`."""
    return x if _SHARDED is None else shard_rows(x, *_SHARDED)


def replicate(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers onto every rank, in place."""
    if not grouped():
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)


def from_rank_0(value):
    """Rank 0's ``value`` (any picklable object) on every rank; ``value``
    itself without a group."""
    if not grouped():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _reduced(x: torch.Tensor, mean: bool) -> torch.Tensor:
    """A copy of ``x`` summed (or averaged: the sum over the world size)
    over the ranks."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out / dist.get_world_size() if mean else out


class _AllReduce(torch.autograd.Function):
    """A sum (or mean) over the ranks whose backward is itself this
    function: under ``create_graph`` the backward's all-reduce is recorded
    and differentiated in turn, so that a double backward (a gradient
    penalty through a global BatchNorm) also sums over the ranks."""

    @staticmethod
    def forward(ctx, x, mean):
        ctx.mean = mean
        return _reduced(x, mean)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.mean), None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: its backward sums
    the ranks' cotangents (one SUM all-reduce each way)."""
    return _AllReduce.apply(x, False)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable: its backward
    averages the ranks' cotangents (one all-reduce each way)."""
    return _AllReduce.apply(x, True)


def mean_over_ranks(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Per-rank means over equal row counts -> the means over the global
    batch, with their gradient (one all-reduce of their concatenation);
    the tensors themselves outside :func:`sharded_batch`."""
    if _SHARDED is None:
        return tensors
    sizes = [t.numel() for t in tensors]
    both = all_reduce_mean(torch.cat([t.reshape(-1) for t in tensors]))
    return tuple(p.view_as(t) for p, t in zip(both.split(sizes), tensors))


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A value summed over this rank's rows (a count) -> over the global
    batch, without a gradient; ``x`` outside :func:`sharded_batch`."""
    return x if _SHARDED is None else _reduced(x.detach(), False)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """A mean over this rank's rows -> over the global batch (equal row
    counts), without a gradient; ``x`` outside :func:`sharded_batch`."""
    return x if _SHARDED is None else _reduced(x.detach(), True)


def batch_count(count: torch.Tensor, minimum) -> torch.Tensor:
    """The normaliser of a loss that divides a sum over the batch by a
    count over it: ``count`` over the global batch, clamped at
    ``minimum``, over the world size. A rank that divides its own sum by
    it and whose loss :func:`loss_share` then divides by the world size
    gets its share of the global value. Outside :func:`sharded_batch`
    the clamped count."""
    if _SHARDED is None:
        return torch.clamp(count, min=minimum)
    return torch.clamp(global_sum(count), min=minimum) / _SHARDED[1]


def loss_share(total: torch.Tensor) -> torch.Tensor:
    """A rank's loss, computed as the mean over its rows -> its share of
    the global loss (the ranks' shares sum to it); ``total`` outside
    :func:`sharded_batch`."""
    return total if _SHARDED is None else total / _SHARDED[1]


def global_values(loss: torch.Tensor, terms: dict) -> tuple:
    """The detached per-rank loss and terms -> their values over the
    global batch (one all-reduce); themselves outside
    :func:`sharded_batch`."""
    if _SHARDED is None:
        return loss, terms
    values = global_mean(torch.stack([loss, *terms.values()]))
    return values[0], dict(zip(terms, values[1:]))


def all_reduce_grads(params) -> None:
    """Sum every parameter's gradient over the ranks, in place, through one
    flat buffer; nothing outside :func:`sharded_batch`. Parameters
    without a gradient (the same on every rank) are left out."""
    if _SHARDED is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def collective_warm_up(device) -> None:
    """One all-reduce on ``device``, so that NCCL makes what it makes at
    its first collective before a CUDA graph captures the step."""
    if grouped():
        t = torch.zeros(1, device=device)
        dist.all_reduce(t)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


def _collective_device() -> torch.device:
    """Where the group's collectives run: NCCL on this process's card,
    gloo on the host."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree(flag: bool) -> bool:
    """Whether any rank's ``flag`` is set (a MAX all-reduce): every rank
    gets the same answer. ``flag`` itself without a group."""
    if not grouped():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                     device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def sum_over_ranks(values: list[float]) -> list[float]:
    """Host floats -> their sums over the ranks (one float64 all-reduce);
    ``values`` themselves without a group. Every rank passes as many."""
    if not grouped():
        return list(values)
    t = torch.tensor(values, dtype=torch.float64,
                     device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.tolist()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a sharded batch's tensor -> the global batch's
    rows in rank order (:func:`shard_rows`'s inverse; one all-gather), on
    ``x``'s device; ``x`` outside :func:`sharded_batch`. Every rank holds
    as many rows."""
    if _SHARDED is None:
        return x
    part = x.detach().contiguous().to(_collective_device())
    parts = [torch.empty_like(part) for _ in range(_SHARDED[1])]
    dist.all_gather(parts, part)
    return torch.cat(parts).to(x.device)


def destroy() -> None:
    """Leave the process group, if any."""
    if grouped():
        dist.destroy_process_group()
