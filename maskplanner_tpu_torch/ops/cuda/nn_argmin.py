"""Wrapper of the nearest-neighbour argmin kernel (``csrc/nn_argmin.cu``).

``nn_argmin_cuda.launches`` counts the kernel's launches (a run that should
go through the kernel reads it after resetting it to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_MAX_DIM = 128


@functools.cache
def _bind():
    fn = build.library("nn_argmin").nn_argmin_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def nn_argmin_cuda(x: torch.Tensor, y: torch.Tensor,
                   y_mask: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, P1, D), y (B, P2, D) float32 CUDA, y_mask optional (B, P2) bool
    -> (B, P1) int32 index of the nearest valid y row (ties: lowest index;
    no valid row: 0). D <= 128."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"nn_argmin_cuda takes (B, P1, D) float32 CUDA "
                         f"rows, got {tuple(x.shape)} {x.dtype} on {x.device}")
    B, P1, D = x.shape
    if y.device != x.device or y.dtype != torch.float32 or y.dim() != 3 \
            or y.shape[0] != B or y.shape[2] != D:
        raise ValueError(f"y must be (B, P2, {D}) float32 on {x.device}, got "
                         f"{tuple(y.shape)} {y.dtype} on {y.device}")
    if not 0 < D <= _MAX_DIM or y.shape[1] == 0 or P1 == 0:
        raise ValueError(f"nn_argmin_cuda takes 1..{_MAX_DIM} coordinates "
                         f"and non-empty sets, got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    P2 = y.shape[1]
    mask_ptr = None
    if y_mask is not None:
        if y_mask.shape != (B, P2) or y_mask.dtype != torch.bool \
                or y_mask.device != x.device:
            raise ValueError(f"y_mask must be ({B}, {P2}) bool on {x.device}")
        y_mask = y_mask.contiguous()
        mask_ptr = y_mask.data_ptr()
    x = x.contiguous()
    y = y.contiguous()
    out = torch.empty((B, P1), dtype=torch.int32, device=x.device)
    err = _bind()(x.data_ptr(), y.data_ptr(), mask_ptr, B, P1, P2, D,
                  out.data_ptr(), build.stream_ptr(x.device))
    build.check(err, "nn_argmin_forward")
    nn_argmin_cuda.launches += 1
    return out


nn_argmin_cuda.launches = 0
