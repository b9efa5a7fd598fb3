"""Build (``build``) and wrappers of the hand-written CUDA kernels in
``maskplanner_tpu_torch/csrc``. Nothing is compiled at import."""
from __future__ import annotations


def launch_counters() -> dict:
    """Every kernel's wrapper by kernel name; each wrapper's ``launches``
    counts the calls that launch its kernel, or record it into a CUDA
    graph being captured; a graph's replays run no Python and count
    nothing. ``fps_large``, ``nn_argmin_chunked`` and ``lap_large`` count
    the launches of those kernels' paths for large shapes, and
    ``fps_masked`` those of FPS's masked mode, which their wrappers' own
    counts include."""
    from .fps import fps_cuda
    from .fused_sa import (folded_sa_cuda, fused_sa_bf16_cuda,
                           fused_sa_bwd_bf16_cuda, fused_sa_bwd_cuda,
                           fused_sa_cuda, sa_weight_grad_bf16_cuda,
                           sa_weight_grad_cuda)
    from .group_gather import (ball_group_cuda, ball_group_single_cuda,
                               ball_query_cuda)
    from .lap import lap_cuda
    from .nn_argmin import nn_argmin_cuda

    return {"fps": fps_cuda, "fused_sa_fwd": fused_sa_cuda,
            "fused_sa_bwd": fused_sa_bwd_cuda,
            "sa_weight_grad": sa_weight_grad_cuda, "nn_argmin": nn_argmin_cuda,
            "lap": lap_cuda, "ball_group": ball_group_cuda,
            "ball_query": ball_query_cuda, "fused_sa_folded": folded_sa_cuda,
            "fused_sa_fwd_bf16": fused_sa_bf16_cuda,
            "ball_group_single": ball_group_single_cuda,
            "fused_sa_bwd_bf16": fused_sa_bwd_bf16_cuda,
            "sa_weight_grad_bf16": sa_weight_grad_bf16_cuda,
            "fps_large": fps_cuda.large, "fps_masked": fps_cuda.masked,
            "nn_argmin_chunked": nn_argmin_cuda.chunked,
            "lap_large": lap_cuda.large}
