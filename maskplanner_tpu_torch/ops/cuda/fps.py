"""Wrapper of the farthest-point-sampling kernel (``csrc/fps.cu``).

``fps_cuda.launches`` counts the kernel's launches (a run that should go
through the kernel reads it after resetting it to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_MAX_POINTS = 8 * 1024  # csrc/fps.cu: kMaxPoints


@functools.cache
def _bind():
    lib = build.library("fps")
    fn = lib.fps_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def fps_cuda(xyz: torch.Tensor, npoint: int,
             start: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) f32 CUDA points, (B,) int32 start indices in [0, N) ->
    (B, npoint) int32 indices. A start index outside [0, N) is caught on
    the card, without a host sync: the kernel traps, and the next
    synchronize raises."""
    if not xyz.is_cuda or xyz.dtype != torch.float32 or xyz.dim() != 3 \
            or xyz.shape[-1] != 3:
        raise ValueError(f"fps_cuda takes (B, N, 3) float32 CUDA points, got "
                         f"{tuple(xyz.shape)} {xyz.dtype} on {xyz.device}")
    B, N, _ = xyz.shape
    if not 0 < N <= _MAX_POINTS:
        raise ValueError(f"fps_cuda supports 1..{_MAX_POINTS} points, got {N}")
    if start.shape != (B,) or start.device != xyz.device:
        raise ValueError("start must be a (B,) tensor on the points' device")
    xyz = xyz.contiguous()
    start = start.to(torch.int32).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    err = _bind()(xyz.data_ptr(), start.data_ptr(), B, N, npoint,
                  out.data_ptr(), build.stream_ptr(xyz.device))
    build.check(err, "fps_forward")
    fps_cuda.launches += 1
    return out


fps_cuda.launches = 0
