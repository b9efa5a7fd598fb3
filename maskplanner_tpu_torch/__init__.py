"""maskplanner_tpu_torch — the PyTorch/CUDA port of ``maskplanner_tpu``.

Module names mirror the JAX package's, so each module's counterpart is easy
to find. The package imports ``torch`` and never ``jax`` or ``flax``; for
data I/O, config loading and the postprocess it imports the JAX package's
host modules, which need neither.

- ``ops``    : distances, FPS, ball query, the fused set-abstraction level;
               ``ops/cuda`` builds and wraps the hand-written kernels of
               ``csrc/`` (CUDA C++ for sm_90a).
- ``models`` : the MaskPlanner network (PointNet++ SSG encoder + heads).
- ``convert``: Flax variables -> ``state_dict``; the port's checkpoints.
- ``serve``  : mesh -> robot program inference (``predict`` is its CLI).
"""

__version__ = "0.1.0"
