"""Wrapper of the batched linear-assignment kernel (``csrc/lap.cu``).

``lap_cuda.launches`` counts the kernel's launches (a run that should go
through the kernel reads it after resetting it to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_MAX_N = 128


@functools.cache
def _bind():
    fn = build.library("lap").lap_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def lap_cuda(cost: torch.Tensor) -> torch.Tensor:
    """(B, n, n) float32 CUDA costs, n <= 128 -> col4row (B, n) int32, a
    cost-optimal permutation per problem."""
    if not cost.is_cuda or cost.dtype != torch.float32 or cost.dim() != 3 \
            or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"lap_cuda takes (B, n, n) float32 CUDA costs, got "
                         f"{tuple(cost.shape)} {cost.dtype} on {cost.device}")
    B, n, _ = cost.shape
    if not 0 < n <= _MAX_N or B == 0:
        raise ValueError(f"lap_cuda takes 1..{_MAX_N} rows and a non-empty "
                         f"batch, got {tuple(cost.shape)}")
    cost = cost.contiguous()
    out = torch.empty((B, n), dtype=torch.int32, device=cost.device)
    err = _bind()(cost.data_ptr(), B, n, out.data_ptr(),
                  build.stream_ptr(cost.device))
    build.check(err, "lap_forward")
    lap_cuda.launches += 1
    return out


lap_cuda.launches = 0
