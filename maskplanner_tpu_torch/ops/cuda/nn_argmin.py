"""Wrapper of the nearest-neighbour argmin kernel (``csrc/nn_argmin.cu``).

Up to 128 coordinates (``_REGISTER_DIM``) the kernel keeps a thread's query
rows in registers; above, its chunked path walks the coordinates in chunks
of 32 with no limit on D. ``nn_argmin_cuda.launches`` counts the kernel's
launches on either path, ``nn_argmin_cuda.chunked.launches`` those on the
chunked path alone (a run that should go through the kernel reads them
after resetting them to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_REGISTER_DIM = 128  # csrc/nn_argmin.cu: the register paths' largest d


@functools.cache
def _bind():
    lib = build.library("nn_argmin")
    fns = (lib.nn_argmin_forward, lib.nn_argmin_chunked_forward)
    for fn in fns:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return fns


def nn_argmin_cuda(x: torch.Tensor, y: torch.Tensor,
                   y_mask: torch.Tensor | None = None,
                   chunked: bool | None = None) -> torch.Tensor:
    """x (B, P1, D), y (B, P2, D) float32 CUDA, y_mask optional (B, P2) bool
    -> (B, P1) int32 index of the nearest valid y row (ties: lowest index;
    no valid row: 0). ``chunked``: the kernel's path, by default the
    chunked one above 128 coordinates; ``True`` takes it at any D (its
    checks)."""
    if not x.is_cuda or x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError(f"nn_argmin_cuda takes (B, P1, D) float32 CUDA "
                         f"rows, got {tuple(x.shape)} {x.dtype} on {x.device}")
    B, P1, D = x.shape
    if y.device != x.device or y.dtype != torch.float32 or y.dim() != 3 \
            or y.shape[0] != B or y.shape[2] != D:
        raise ValueError(f"y must be (B, P2, {D}) float32 on {x.device}, got "
                         f"{tuple(y.shape)} {y.dtype} on {y.device}")
    if D == 0 or y.shape[1] == 0 or P1 == 0:
        raise ValueError(f"nn_argmin_cuda takes coordinates and non-empty "
                         f"sets, got {tuple(x.shape)}, {tuple(y.shape)}")
    if chunked is None:
        chunked = D > _REGISTER_DIM
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
    fn = _bind()[1 if chunked else 0]
    err = fn(x.data_ptr(), y.data_ptr(), mask_ptr, B, P1, P2, D,
             out.data_ptr(), build.stream_ptr(x.device))
    build.check(err, "nn_argmin_chunked_forward" if chunked
                else "nn_argmin_forward")
    if chunked:
        nn_argmin_cuda.chunked.launches += 1
    nn_argmin_cuda.launches += 1
    return out


nn_argmin_cuda.launches = 0
nn_argmin_cuda.chunked = build.PathLaunches()
