"""Wrapper of the farthest-point-sampling kernel (``csrc/fps.cu``).

Clouds of up to 8192 points (``_SMALL_POINTS``, ``csrc/fps.cu``'s
``kMaxPoints``) take the kernel's register path; larger ones its large path
(one block of 1024 threads a cloud, the running distances in shared memory
up to about 57k points, in a scratch buffer allocated here beyond), with no
size limit. Either path has a masked mode (``mask``: the kernel's
``kMasked`` instantiation). ``fps_cuda.launches`` counts the kernel's
launches on either path and in either mode, ``fps_cuda.large.launches``
those on the large path alone and ``fps_cuda.masked.launches`` those in
the masked mode alone (a run that should go through the kernel reads them
after resetting them to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_SMALL_POINTS = 8 * 1024  # csrc/fps.cu: kMaxPoints


@functools.cache
def _bind():
    lib = build.library("fps")
    small = lib.fps_forward
    small.restype = ctypes.c_int
    small.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p]
    large = lib.fps_large_forward
    large.restype = ctypes.c_int
    large.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    scratch = lib.fps_large_scratch_floats
    scratch.restype = ctypes.c_longlong
    scratch.argtypes = [ctypes.c_int, ctypes.c_int]
    return small, large, scratch


def fps_cuda(xyz: torch.Tensor, npoint: int, start: torch.Tensor,
             large: bool | None = None,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 3) f32 CUDA points, (B,) int32 start indices in [0, N) ->
    (B, npoint) int32 indices. A start index outside [0, N) is caught on
    the card, without a host sync: the kernel traps, and the next
    synchronize raises. ``large``: the kernel's path, by default the large
    one above 8192 points; ``True`` takes it at any N (its checks).
    ``mask``: (B, N) bool, the valid points (the masked mode:
    ``ops.sampling.fps_plain``'s semantics)."""
    if not xyz.is_cuda or xyz.dtype != torch.float32 or xyz.dim() != 3 \
            or xyz.shape[-1] != 3:
        raise ValueError(f"fps_cuda takes (B, N, 3) float32 CUDA points, got "
                         f"{tuple(xyz.shape)} {xyz.dtype} on {xyz.device}")
    B, N, _ = xyz.shape
    if N == 0:
        raise ValueError("fps_cuda takes non-empty clouds")
    if large is None:
        large = N > _SMALL_POINTS
    elif not large and N > _SMALL_POINTS:
        raise ValueError(f"the register path takes 1..{_SMALL_POINTS} "
                         f"points, got {N}")
    if start.shape != (B,) or start.device != xyz.device:
        raise ValueError("start must be a (B,) tensor on the points' device")
    if mask is not None:
        if mask.shape != (B, N) or mask.dtype != torch.bool \
                or mask.device != xyz.device:
            raise ValueError(f"mask must be a (B, N) bool tensor on the "
                             f"points' device, got {tuple(mask.shape)} "
                             f"{mask.dtype} on {mask.device}")
        mask = mask.contiguous()
    mask_ptr = None if mask is None else mask.data_ptr()
    xyz = xyz.contiguous()
    start = start.to(torch.int32).contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    small_fn, large_fn, scratch_floats = _bind()
    stream = build.stream_ptr(xyz.device)
    if large:
        per_cloud = int(scratch_floats(N, npoint))
        scratch = (torch.empty((B, per_cloud), dtype=torch.float32,
                               device=xyz.device) if per_cloud else None)
        err = large_fn(xyz.data_ptr(), start.data_ptr(), mask_ptr, B, N,
                       npoint,
                       None if scratch is None else scratch.data_ptr(),
                       out.data_ptr(), stream)
        build.check(err, "fps_large_forward")
        fps_cuda.large.launches += 1
    else:
        err = small_fn(xyz.data_ptr(), start.data_ptr(), mask_ptr, B, N,
                       npoint, out.data_ptr(), stream)
        build.check(err, "fps_forward")
    if mask is not None:
        fps_cuda.masked.launches += 1
    fps_cuda.launches += 1
    return out


fps_cuda.launches = 0
fps_cuda.large = build.PathLaunches()
fps_cuda.masked = build.PathLaunches()
