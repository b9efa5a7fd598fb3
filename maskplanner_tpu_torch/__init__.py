"""maskplanner_tpu_torch — the PyTorch/CUDA port of ``maskplanner_tpu``.

Module names mirror the JAX package's, so each module's counterpart is easy
to find. The package imports ``torch`` and nothing of ``maskplanner_tpu``,
``jax`` or ``flax``: it keeps its own copies of the numpy-only host modules
(``utils``, ``data``, ``postprocess``, ``configs``).

- ``ops``      : distances, FPS, ball query, the fused set-abstraction level
                 (forward and backward), nearest-neighbour argmin, chamfer,
                 the batched LAP; ``ops/cuda`` builds and wraps the
                 hand-written kernels of ``csrc/`` (CUDA C++ for sm_90a).
- ``models``   : the MaskPlanner network (PointNet++ SSG encoder + heads).
- ``losses``   : the MaskPlanner v6 loss and its handler.
- ``train``    : the training step, LR milestones, the PSACD curriculum;
                 ``train_maskplanner`` is the training entry point.
- ``convert``  : Flax variables <-> ``state_dict``; the port's checkpoints.
- ``serve``    : mesh -> robot program inference (``predict`` is its CLI).
"""

__version__ = "0.1.0"
