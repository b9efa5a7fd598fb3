"""Wrappers of the fused set-abstraction kernels: the forward
(``csrc/fused_sa_fwd.cu``) and the backward (``csrc/fused_sa_bwd.cu``).

``fused_sa_cuda.launches``, ``folded_sa_cuda.launches`` (the forward on
BatchNorm-folded weights) and ``fused_sa_bwd_cuda.launches`` count the
kernels' launches (a run that should go through a kernel reads its count
after resetting it to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_MAX_LAYERS = 4


@functools.cache
def _bind_bwd():
    fn = build.library("fused_sa_bwd").fused_sa_backward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


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


def _check_level(xyz, new_xyz, features, params, layer_norm: bool):
    """Device, type and shape checks shared by the two kernels; returns
    (xyz, new_xyz, features) contiguous, F, and the channel list."""
    device = xyz.device
    if device.type != "cuda" or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"the fused SA kernels take (B, N, 3) CUDA points, "
                         f"got {tuple(xyz.shape)} on {device}")
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
        raise ValueError(f"the fused SA kernels take 1..{_MAX_LAYERS} layers")
    chans = [3 + F]
    for layer in params:
        co, ci = layer[0].shape
        if ci != chans[-1] or co % 4:
            raise ValueError(f"layer weight {tuple(layer[0].shape)} does not "
                             f"follow {chans[-1]} input channels, or its width "
                             f"is not a multiple of 4")
        if len(layer) != (4 if layer_norm else 2):
            raise ValueError("a layer is (w, b, gamma, beta) with LayerNorm, "
                             "(w, b) without")
        if any(a.shape != (co,) for a in layer[1:]):
            raise ValueError("bias, gamma and beta must be (C_out,)")
        chans.append(co)
    return xyz, new_xyz, features, F, chans


def fused_sa_bwd_cuda(nsample: int, layer_norm: bool, xyz: torch.Tensor,
                      new_xyz: torch.Tensor, features: torch.Tensor | None,
                      params, idx: torch.Tensor, pooled: torch.Tensor,
                      d_pooled: torch.Tensor):
    """Backward of :func:`fused_sa_cuda` on the card, from its ``idx`` (which
    carries the neighbour selection) and ``pooled`` -> (d_xyz (B, N, 3),
    d_new_xyz (B, S, 3), d_features (B, N, F) or None, per-layer gradients
    shaped like ``params``)."""
    xyz, new_xyz, features, F, chans = _check_level(xyz, new_xyz, features,
                                                    params, layer_norm)
    device = xyz.device
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    if idx.shape != (B, S, nsample) or idx.dtype != torch.int32 \
            or idx.device != device:
        raise ValueError(f"idx must be ({B}, {S}, {nsample}) int32 on {device}")
    shape = (B, S, chans[-1])
    pooled = _f32(pooled, device, "pooled")
    d_pooled = _f32(d_pooled, device, "d_pooled")
    if pooled.shape != shape or d_pooled.shape != shape:
        raise ValueError(f"pooled and d_pooled must be {shape}")
    idx = idx.contiguous()

    ptrs, gptrs, keep, grads = [], [], [], []
    for layer in params:
        w = _f32(layer[0], device, "weight")
        co, ci = w.shape
        wt = w.t().contiguous()                   # (ci, co), the recompute
        w_pad = torch.zeros((co, (ci + 3) // 4 * 4), dtype=torch.float32,
                            device=device)
        w_pad[:, :ci] = w                          # (co, ci_pad), d_in
        rest = [_f32(a, device, "bias/gamma/beta") for a in layer[1:]]
        # the kernel sums the weight gradients over all blocks in f64
        g = [torch.zeros_like(w, dtype=torch.float64)] + [
            torch.zeros_like(a, dtype=torch.float64) for a in rest]
        keep += [wt, w_pad, *rest]
        ptrs += [wt.data_ptr(), w_pad.data_ptr(),
                 *(a.data_ptr() for a in rest)]
        gptrs += [t.data_ptr() for t in g]
        if not layer_norm:
            ptrs += [None, None]
            gptrs += [None, None]
        grads.append(tuple(g))

    d_xyz = torch.zeros_like(xyz)
    d_feat = None if features is None else torch.zeros_like(features)
    d_new = torch.empty_like(new_xyz)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_gptrs = (ctypes.c_void_p * len(gptrs))(*gptrs)
    err = _bind_bwd()(xyz.data_ptr(), new_xyz.data_ptr(),
                      None if features is None else features.data_ptr(),
                      idx.data_ptr(), pooled.data_ptr(), d_pooled.data_ptr(),
                      B, N, S, F, nsample, len(params), c_chans, c_ptrs,
                      c_gptrs, int(layer_norm), d_xyz.data_ptr(),
                      None if d_feat is None else d_feat.data_ptr(),
                      d_new.data_ptr(), build.stream_ptr(device))
    build.check(err, "fused_sa_backward")
    fused_sa_bwd_cuda.launches += 1
    grads = tuple(tuple(t.float() for t in layer) for layer in grads)
    return d_xyz, d_new, d_feat, grads


fused_sa_bwd_cuda.launches = 0


def _forward(radius: float, nsample: int, layer_norm: bool,
             xyz: torch.Tensor, new_xyz: torch.Tensor,
             features: torch.Tensor | None, params):
    """Launch ``csrc/fused_sa_fwd.cu`` -> (pooled, idx)."""
    xyz, new_xyz, features, F, chans = _check_level(xyz, new_xyz, features,
                                                    params, layer_norm)
    device = xyz.device
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    ptrs, keep = [], []  # keep: the operands stay alive through the launch
    for layer in params:
        wt = _f32(layer[0], device, "weight").t().contiguous()  # (ci, co)
        rest = [_f32(a, device, "bias/gamma/beta") for a in layer[1:]]
        keep += [wt, *rest]
        ptrs += [wt.data_ptr(), *(a.data_ptr() for a in rest)]
        if not layer_norm:
            ptrs += [None, None]

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
    return pooled, idx


def fused_sa_cuda(radius: float, nsample: int, layer_norm: bool,
                  xyz: torch.Tensor, new_xyz: torch.Tensor,
                  features: torch.Tensor | None, params):
    """One SA level on the card -> (pooled (B, S, C_last) f32,
    idx (B, S, nsample) int32). Arguments as ``ops.fused_sa.fused_sa_forward``;
    every layer width must be a multiple of 4."""
    out = _forward(radius, nsample, layer_norm, xyz, new_xyz, features,
                   params)
    fused_sa_cuda.launches += 1
    return out


fused_sa_cuda.launches = 0


def folded_sa_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                   new_xyz: torch.Tensor, features: torch.Tensor | None,
                   folded) -> torch.Tensor:
    """One eval-mode BatchNorm level on the card, the norm folded into the
    layers ``folded = [(w (C_out, C_in), b)]``: the same kernel without
    LayerNorm -> pooled (B, S, C_last) f32. Counted apart from
    :func:`fused_sa_cuda`."""
    pooled, _ = _forward(radius, nsample, False, xyz, new_xyz, features,
                         folded)
    folded_sa_cuda.launches += 1
    return pooled


folded_sa_cuda.launches = 0
