"""The inference kernels as ``torch.library`` custom ops (namespace
``maskplanner``), so that ``torch.export`` traces a forward through them:

- ``maskplanner::fps`` (#1, ``csrc/fps.cu``);
- ``maskplanner::fused_sa_fwd`` (#2) and ``maskplanner::fused_sa_fwd_bf16``
  (its bf16 mode, 2b; ``csrc/fused_sa_fwd.cu``);
- ``maskplanner::ball_group`` (#6) and ``maskplanner::ball_group_single``
  (its single pass, 6b; ``csrc/group_gather.cu``).

Each op's CUDA kernel is the ``ctypes`` wrapper of ``ops/cuda`` (which
counts its launches, so an exported program's launches are counted too),
its CPU kernel the plain version, and its fake kernel the exact shapes and
dtypes of every output, so that tracing never reaches a ``data_ptr()``.
The eval (no-grad) forward calls the ops; a training forward keeps the
``autograd.Function``s of ``ops.fused_sa`` and ``ops.group_gather``.

A level's layers travel as one flat tensor list, ``(w, b)`` a layer, or
``(w, b, gamma, beta)`` with ``layer_norm``. Nothing is built at import:
a CUDA kernel is compiled at its first launch.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

NAMESPACE = "maskplanner"


def split_layers(flat, n_per: int) -> list:
    """A level's flat tensor list -> per layer the ``n_per`` tensors."""
    return [flat[i:i + n_per] for i in range(0, len(flat), n_per)]


def _layers(flat, layer_norm: bool) -> list:
    return split_layers(flat, 4 if layer_norm else 2)


# -- #1 farthest point sampling --

@torch.library.custom_op(f"{NAMESPACE}::fps", mutates_args=(),
                         device_types="cuda")
def fps(xyz: Tensor, npoint: int, start: Tensor) -> Tensor:
    """(B, N, 3) f32 points, (B,) int32 start indices -> (B, npoint) int32
    (``ops.sampling.farthest_point_sample``)."""
    from .cuda.fps import fps_cuda

    return fps_cuda(xyz, npoint, start)


@fps.register_kernel("cpu")
def _fps_cpu(xyz: Tensor, npoint: int, start: Tensor) -> Tensor:
    from .sampling import fps_plain

    n = xyz.shape[1]
    if bool(((start < 0) | (start >= n)).any()):
        raise ValueError(f"FPS start indices must lie in [0, {n})")
    return fps_plain(xyz, npoint, start)


@fps.register_fake
def _fps_fake(xyz, npoint, start):
    return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)


# -- #2 and 2b: the fused set-abstraction level --

def _sa_fake(xyz, new_xyz, features, params, radius, nsample, layer_norm):
    B, S = new_xyz.shape[:2]
    c_last = params[-(4 if layer_norm else 2)].shape[0]
    return (xyz.new_empty((B, S, c_last), dtype=torch.float32),
            xyz.new_empty((B, S, nsample), dtype=torch.int32))


def _sa_cpu(xyz, new_xyz, features, params, radius, nsample, layer_norm,
            precision):
    from .fused_sa import fused_sa_forward_plain

    return fused_sa_forward_plain(radius, nsample,
                                  "layer" if layer_norm else "none", xyz,
                                  new_xyz, features,
                                  _layers(params, layer_norm), precision)


@torch.library.custom_op(f"{NAMESPACE}::fused_sa_fwd", mutates_args=(),
                         device_types="cuda")
def fused_sa_fwd(xyz: Tensor, new_xyz: Tensor, features: Optional[Tensor],
                 params: list[Tensor], radius: float, nsample: int,
                 layer_norm: bool) -> tuple[Tensor, Tensor]:
    """One SA level in f32 -> (pooled (B, S, C_last) f32, idx (B, S,
    nsample) int32) (``ops.fused_sa.fused_sa_forward``)."""
    from .cuda.fused_sa import fused_sa_cuda

    return fused_sa_cuda(radius, nsample, layer_norm, xyz, new_xyz,
                         features, _layers(params, layer_norm))


@fused_sa_fwd.register_kernel("cpu")
def _fused_sa_fwd_cpu(xyz, new_xyz, features, params, radius, nsample,
                      layer_norm):
    return _sa_cpu(xyz, new_xyz, features, params, radius, nsample,
                   layer_norm, "f32")


fused_sa_fwd.register_fake(_sa_fake)


@torch.library.custom_op(f"{NAMESPACE}::fused_sa_fwd_bf16", mutates_args=(),
                         device_types="cuda")
def fused_sa_fwd_bf16(xyz: Tensor, new_xyz: Tensor,
                      features: Optional[Tensor], params: list[Tensor],
                      radius: float, nsample: int,
                      layer_norm: bool) -> tuple[Tensor, Tensor]:
    """The level's bf16 mode (bf16 products, f32 sums) -> as
    :func:`fused_sa_fwd`."""
    from .cuda.fused_sa import fused_sa_bf16_cuda

    return fused_sa_bf16_cuda(radius, nsample, layer_norm, xyz, new_xyz,
                              features, _layers(params, layer_norm))


@fused_sa_fwd_bf16.register_kernel("cpu")
def _fused_sa_fwd_bf16_cpu(xyz, new_xyz, features, params, radius, nsample,
                           layer_norm):
    return _sa_cpu(xyz, new_xyz, features, params, radius, nsample,
                   layer_norm, "bf16")


fused_sa_fwd_bf16.register_fake(_sa_fake)


# -- #6 and 6b: the ball-group gather --

def _group_fake(xyz, new_xyz, features, radius, nsample, dtype):
    B, S = new_xyz.shape[:2]
    width = 3 + (0 if features is None else features.shape[-1])
    return (xyz.new_empty((B, S, nsample, width), dtype=dtype),
            xyz.new_empty((B, S, nsample), dtype=torch.int32))


@torch.library.custom_op(f"{NAMESPACE}::ball_group", mutates_args=(),
                         device_types="cuda")
def ball_group(xyz: Tensor, new_xyz: Tensor, features: Optional[Tensor],
               radius: float, nsample: int) -> tuple[Tensor, Tensor]:
    """First-K in-radius grouping -> (grouped (B, S, K, 3 + F) f32,
    idx (B, S, K) int32) (``ops.group_gather.ball_group``)."""
    from .cuda.group_gather import ball_group_cuda

    return ball_group_cuda(radius, nsample, xyz, new_xyz, features)


@ball_group.register_kernel("cpu")
def _ball_group_cpu(xyz, new_xyz, features, radius, nsample):
    from .group_gather import ball_group_plain

    return ball_group_plain(radius, nsample, xyz, new_xyz, features)


@ball_group.register_fake
def _ball_group_fake(xyz, new_xyz, features, radius, nsample):
    return _group_fake(xyz, new_xyz, features, radius, nsample,
                       torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::ball_group_single", mutates_args=(),
                         device_types="cuda")
def ball_group_single(xyz: Tensor, new_xyz: Tensor,
                      features: Optional[Tensor], radius: float,
                      nsample: int) -> tuple[Tensor, Tensor]:
    """The single-pass grouping -> (grouped bf16, idx int32), as
    :func:`ball_group`."""
    from .cuda.group_gather import ball_group_single_cuda

    return ball_group_single_cuda(radius, nsample, xyz, new_xyz, features)


@ball_group_single.register_kernel("cpu")
def _ball_group_single_cpu(xyz, new_xyz, features, radius, nsample):
    from .group_gather import ball_group_plain

    return ball_group_plain(radius, nsample, xyz, new_xyz, features,
                            single_pass=True)


@ball_group_single.register_fake
def _ball_group_single_fake(xyz, new_xyz, features, radius, nsample):
    return _group_fake(xyz, new_xyz, features, radius, nsample,
                       torch.bfloat16)


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a function of ``tensors`` (None
    skipped): the training forward's test for its ``autograd.Function``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
