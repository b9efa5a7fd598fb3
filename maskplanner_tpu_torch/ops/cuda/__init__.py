"""Build (``build``) and wrappers of the hand-written CUDA kernels in
``maskplanner_tpu_torch/csrc``. Nothing is compiled at import."""
