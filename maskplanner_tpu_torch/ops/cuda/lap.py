"""Wrapper of the batched linear-assignment kernel (``csrc/lap.cu``).

Up to 128 rows (``_SMALL_N``) the kernel runs a problem a warp (n <= 32) or
a block of one thread a column; above, its large path (a block of up to
1024 threads a problem, its state in shared memory up to about 8900
columns, in a scratch buffer allocated here beyond), with n bounded only by
the card's memory. ``lap_cuda.launches`` counts the kernel's launches on
any path, ``lap_cuda.large.launches`` those on the large path alone (a run
that should go through the kernel reads them after resetting them to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_SMALL_N = 128  # csrc/lap.cu: kMaxN


@functools.cache
def _bind():
    lib = build.library("lap")
    small = lib.lap_forward
    small.restype = ctypes.c_int
    small.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p]
    large = lib.lap_large_forward
    large.restype = ctypes.c_int
    large.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p]
    scratch = lib.lap_large_scratch_bytes
    scratch.restype = ctypes.c_longlong
    scratch.argtypes = [ctypes.c_int]
    return small, large, scratch


def lap_step_cycles() -> int:
    """Cycles of one dependent Dijkstra step of the kernel's warp path, the
    chain floor stated in ``csrc/lap.cu``'s note."""
    fn = build.library("lap").lap_step_cycles
    fn.restype = ctypes.c_int
    fn.argtypes = []
    return int(fn())


def lap_block_step_cycles(n: int) -> int:
    """Cycles of one dependent Dijkstra step of the kernel's block path
    (33 to 128 rows) at ``n`` rows, the chain floor stated in
    ``csrc/lap.cu``'s note."""
    fn = build.library("lap").lap_block_step_cycles
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return int(fn(n))


def lap_large_step_cycles(n: int) -> int:
    """Cycles of one dependent Dijkstra step of the kernel's large path at
    ``n`` rows, the chain floor stated in ``csrc/lap.cu``'s note."""
    fn = build.library("lap").lap_large_step_cycles
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return int(fn(n))


def lap_cuda(cost: torch.Tensor, large: bool | None = None,
             steps: torch.Tensor | None = None) -> torch.Tensor:
    """(B, n, n) float32 CUDA costs -> col4row (B, n) int32, a cost-optimal
    permutation per problem. ``large``: the kernel's path, by default the
    large one above 128 rows; ``True`` takes it at any n (its checks).
    ``steps``: a (B,) int32 CUDA tensor that the large path fills with each
    problem's Dijkstra steps."""
    if not cost.is_cuda or cost.dtype != torch.float32 or cost.dim() != 3 \
            or cost.shape[1] != cost.shape[2]:
        raise ValueError(f"lap_cuda takes (B, n, n) float32 CUDA costs, got "
                         f"{tuple(cost.shape)} {cost.dtype} on {cost.device}")
    B, n, _ = cost.shape
    if n == 0 or B == 0:
        raise ValueError(f"lap_cuda takes rows and a non-empty batch, got "
                         f"{tuple(cost.shape)}")
    if large is None:
        large = n > _SMALL_N
    elif not large and n > _SMALL_N:
        raise ValueError(f"the warp and block paths take 1..{_SMALL_N} rows, "
                         f"got {n}")
    if steps is not None and (not large or steps.shape != (B,)
                              or steps.dtype != torch.int32
                              or steps.device != cost.device):
        raise ValueError(f"steps must be ({B},) int32 on {cost.device}, "
                         f"and only the large path fills it")
    cost = cost.contiguous()
    out = torch.empty((B, n), dtype=torch.int32, device=cost.device)
    small_fn, large_fn, scratch_bytes = _bind()
    stream = build.stream_ptr(cost.device)
    if large:
        per_problem = int(scratch_bytes(n))
        # torch's allocator aligns every block to 512 bytes, and each
        # problem's share is a multiple of 16
        scratch = (torch.empty((B, per_problem), dtype=torch.uint8,
                               device=cost.device) if per_problem else None)
        err = large_fn(cost.data_ptr(), B, n, out.data_ptr(),
                       None if scratch is None else scratch.data_ptr(),
                       None if steps is None else steps.data_ptr(), stream)
        build.check(err, "lap_large_forward")
        lap_cuda.large.launches += 1
    else:
        err = small_fn(cost.data_ptr(), B, n, out.data_ptr(), stream)
        build.check(err, "lap_forward")
    lap_cuda.launches += 1
    return out


lap_cuda.launches = 0
lap_cuda.large = build.PathLaunches()
