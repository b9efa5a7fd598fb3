"""Wrapper of the fused set-abstraction forward kernel
(``csrc/fused_sa_fwd.cu``).

``fused_sa_cuda.launches`` counts the kernel's launches (a run that should
go through the kernel reads it after resetting it to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_MAX_LAYERS = 4


@functools.cache
def _bind():
    lib = build.library("fused_sa_fwd")
    fn = lib.fused_sa_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


def _f32(t: torch.Tensor, device: torch.device, what: str) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(f"{what} must be float32 on {device}, got "
                         f"{t.dtype} on {t.device}")
    return t.contiguous()


def fused_sa_cuda(radius: float, nsample: int, layer_norm: bool,
                  xyz: torch.Tensor, new_xyz: torch.Tensor,
                  features: torch.Tensor | None, params):
    """One SA level on the card -> (pooled (B, S, C_last) f32,
    idx (B, S, nsample) int32). Arguments as ``ops.fused_sa.fused_sa_forward``;
    every layer width must be a multiple of 4."""
    device = xyz.device
    if device.type != "cuda" or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fused_sa_cuda takes (B, N, 3) CUDA points, got "
                         f"{tuple(xyz.shape)} on {device}")
    xyz = _f32(xyz, device, "xyz")
    new_xyz = _f32(new_xyz, device, "new_xyz")
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if new_xyz.shape != (B, S, 3):
        raise ValueError(f"new_xyz must be (B, S, 3), got {tuple(new_xyz.shape)}")
    F = 0
    if features is not None:
        features = _f32(features, device, "features")
        if features.shape[:2] != (B, N):
            raise ValueError("features must be (B, N, F)")
        F = features.shape[-1]
    if not 0 < len(params) <= _MAX_LAYERS:
        raise ValueError(f"fused_sa_cuda takes 1..{_MAX_LAYERS} layers")

    chans = [3 + F]
    ptrs, keep = [], []  # keep: the operands stay alive through the launch
    for layer in params:
        w = _f32(layer[0], device, "weight")
        co, ci = w.shape
        if ci != chans[-1] or co % 4:
            raise ValueError(f"layer weight {tuple(w.shape)} does not follow "
                             f"{chans[-1]} input channels, or its width is "
                             f"not a multiple of 4")
        if len(layer) != (4 if layer_norm else 2):
            raise ValueError("a layer is (w, b, gamma, beta) with LayerNorm, "
                             "(w, b) without")
        wt = w.t().contiguous()  # (ci, co): one float4 per input channel
        rest = [_f32(a, device, "bias/gamma/beta") for a in layer[1:]]
        if any(a.shape != (co,) for a in rest):
            raise ValueError("bias, gamma and beta must be (C_out,)")
        keep += [wt, *rest]
        ptrs += [wt.data_ptr(), *(a.data_ptr() for a in rest)]
        if not layer_norm:
            ptrs += [None, None]
        chans.append(co)

    pooled = torch.empty((B, S, chans[-1]), dtype=torch.float32, device=device)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=device)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    err = _bind()(xyz.data_ptr(), new_xyz.data_ptr(),
                  None if features is None else features.data_ptr(),
                  B, N, S, F, nsample, float(radius) ** 2, len(params),
                  c_chans, c_ptrs, int(layer_norm), pooled.data_ptr(),
                  idx.data_ptr(), build.stream_ptr(device))
    build.check(err, "fused_sa_forward")
    fused_sa_cuda.launches += 1
    return pooled, idx


fused_sa_cuda.launches = 0
