"""Wrappers of the ball-group gather and the ball query
(``csrc/group_gather.cu``).

``ball_group_cuda.launches`` and ``ball_query_cuda.launches`` count the
kernels' launches (a run that should go through a kernel reads its count
after resetting it to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build


@functools.cache
def _bind_group():
    fn = build.library("group_gather").ball_group_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


@functools.cache
def _bind_query():
    fn = build.library("group_gather").ball_query_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _check_points(xyz: torch.Tensor, new_xyz: torch.Tensor, nsample: int):
    """(B, N, 3) and (B, S, 3) float32 CUDA points -> both contiguous."""
    if not xyz.is_cuda or xyz.dtype != torch.float32 or xyz.dim() != 3 \
            or xyz.shape[-1] != 3 or xyz.shape[1] == 0:
        raise ValueError(f"the ball kernels take (B, N, 3) float32 CUDA "
                         f"points, got {tuple(xyz.shape)} {xyz.dtype} on "
                         f"{xyz.device}")
    B = xyz.shape[0]
    if new_xyz.device != xyz.device or new_xyz.dtype != torch.float32 \
            or new_xyz.dim() != 3 or new_xyz.shape[0] != B \
            or new_xyz.shape[-1] != 3:
        raise ValueError(f"new_xyz must be ({B}, S, 3) float32 on "
                         f"{xyz.device}, got {tuple(new_xyz.shape)} "
                         f"{new_xyz.dtype} on {new_xyz.device}")
    if nsample <= 0:
        raise ValueError(f"nsample must be positive, got {nsample}")
    return xyz.contiguous(), new_xyz.contiguous()


def ball_group_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor,
                    features: torch.Tensor | None = None):
    """First-``nsample`` in-radius grouping on the card -> (grouped
    (B, S, nsample, 3 + F) f32 rows ``[x − q ; f]``, idx (B, S, nsample)
    int32). Arguments as ``ops.group_gather.ball_group``."""
    xyz, new_xyz = _check_points(xyz, new_xyz, nsample)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    F = 0
    if features is not None:
        if features.device != xyz.device or features.dtype != torch.float32 \
                or features.dim() != 3 or features.shape[:2] != (B, N):
            raise ValueError(f"features must be ({B}, {N}, F) float32 on "
                             f"{xyz.device}, got {tuple(features.shape)} "
                             f"{features.dtype} on {features.device}")
        features = features.contiguous()
        F = features.shape[-1]
    grouped = torch.empty((B, S, nsample, 3 + F), dtype=torch.float32,
                          device=xyz.device)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    err = _bind_group()(xyz.data_ptr(), new_xyz.data_ptr(),
                        None if features is None else features.data_ptr(),
                        B, N, S, F, nsample, float(radius) ** 2,
                        grouped.data_ptr(), idx.data_ptr(),
                        build.stream_ptr(xyz.device))
    build.check(err, "ball_group_forward")
    ball_group_cuda.launches += 1
    return grouped, idx


ball_group_cuda.launches = 0


def ball_query_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor) -> torch.Tensor:
    """First-``nsample`` in-radius indices on the card -> (B, S, nsample)
    int32, the same as :func:`ball_group_cuda`'s."""
    xyz, new_xyz = _check_points(xyz, new_xyz, nsample)
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    err = _bind_query()(xyz.data_ptr(), new_xyz.data_ptr(), B, N, S, nsample,
                        float(radius) ** 2, idx.data_ptr(),
                        build.stream_ptr(xyz.device))
    build.check(err, "ball_query_forward")
    ball_query_cuda.launches += 1
    return idx


ball_query_cuda.launches = 0
