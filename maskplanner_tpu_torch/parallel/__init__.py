"""Data-parallel training over several processes
(``maskplanner_tpu/parallel``), as ``torch.distributed`` with one process a
card.

The JAX package runs one program over the global batch, sharded on its
leading axis, with the parameters replicated; XLA inserts the gradient
all-reduce, and a BatchNorm's reduction over the sharded axis lowers to a
psum, so its statistics are the global batch's. Here each process runs
the step on its ``batch_size / N`` rows and ``mesh.py`` supplies what the
one program got for free: BatchNorm statistics, random draws and loss
normalisers over the global batch, then one SUM all-reduce of the
gradients, so that the step's result is the single-process step's at the
global batch, up to the order of reductions.
"""
from .mesh import (agree, all_reduce_grads, all_reduce_mean, all_reduce_sum,
                   batch_count, collective_warm_up, destroy,
                   distributed_init, from_rank_0, gather_rows, global_mean,
                   global_rows, global_sum, global_values, grouped,
                   host_shard_bounds, local_rows, loss_share,
                   mean_over_ranks, rank_and_world, replicate, shard_rows,
                   sharded_batch, sum_over_ranks)

__all__ = ["agree", "all_reduce_grads", "all_reduce_mean", "all_reduce_sum",
           "batch_count", "collective_warm_up", "destroy",
           "distributed_init", "from_rank_0", "gather_rows", "global_mean",
           "global_rows", "global_sum", "global_values", "grouped",
           "host_shard_bounds", "local_rows", "loss_share",
           "mean_over_ranks", "rank_and_world", "replicate", "shard_rows",
           "sharded_batch", "sum_over_ranks"]
