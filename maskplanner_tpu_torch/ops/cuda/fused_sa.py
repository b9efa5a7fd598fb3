"""Wrappers of the fused set-abstraction kernels: the forward
(``csrc/fused_sa_fwd.cu``) and the backward in two kernels, K1
(``csrc/fused_sa_bwd.cu``: recompute, routing, input gradients, the rows
of the weight gradient) and K2 (``csrc/sa_weight_grad.cu``: the weight
gradients as fixed-order split-K products).

``fused_sa_cuda.launches``, ``fused_sa_bf16_cuda.launches`` (the forward's
bf16 mode), ``folded_sa_cuda.launches`` (the forward on BatchNorm-folded
weights), ``fused_sa_bwd_cuda.launches`` (K1) and
``sa_weight_grad_cuda.launches`` (K2) count the kernels' launches (a run
that should go through a kernel reads its count after resetting it to 0).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_MAX_LAYERS = 4
# rows of one split of K2's split-K weight-gradient product: the number of
# splits follows from the shapes alone, and with it every summation order
SPLIT_ROWS = 8192


def bwd_signature(fn):
    """Set the ctypes signature of K1's C entry point ``fn``."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    return fn


@functools.cache
def _bind_bwd():
    return bwd_signature(build.library("fused_sa_bwd").fused_sa_backward)


@functools.cache
def _bind_wgrad():
    fn = build.library("sa_weight_grad").sa_weight_grad
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    return fn


def fwd_signature(fn):
    """Set the ctypes signature of the forward's C entry point ``fn``."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return fn


@functools.cache
def _bind(bf16: bool):
    lib = build.library("fused_sa_fwd")
    return fwd_signature(lib.fused_sa_forward_bf16 if bf16
                         else lib.fused_sa_forward)


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


def padded_transpose(w: torch.Tensor) -> torch.Tensor:
    """A Dense weight (C_out, C_in) -> its transpose zero-padded to
    (C_in, C_out) rounded up to multiples of 8: the layout of the layer
    product both kernels share (the mma's k and n of 8)."""
    co, ci = w.shape
    pad = (0, -co % 8, 0, -ci % 8)
    if not any(pad):
        return w.t().contiguous()
    return torch.nn.functional.pad(w.t(), pad)


def scratch_floats(chans, rows: int) -> int:
    """Floats of K1's scratch: per layer, d_pre (rows, C_out) and the
    layer's input (rows, C_in rounded up to a multiple of 4)."""
    return rows * sum(co + (ci + 3) // 4 * 4
                      for ci, co in zip(chans[:-1], chans[1:]))


def fused_sa_bwd_cuda(nsample: int, layer_norm: bool, xyz: torch.Tensor,
                      new_xyz: torch.Tensor, features: torch.Tensor | None,
                      params, idx: torch.Tensor, pooled: torch.Tensor,
                      d_pooled: torch.Tensor, needs=(True, True, True)):
    """K1: the backward of :func:`fused_sa_cuda` on the card up to the
    weight gradients, from its ``idx`` (which carries the neighbour
    selection) and ``pooled`` -> (d_xyz (B, N, 3), d_new_xyz (B, S, 3),
    d_features (B, N, F), each None unless ``needs`` (xyz, new_xyz,
    features) asks for it; scratch, vec: the rows and per-query sums
    :func:`sa_weight_grad_cuda` takes; chans)."""
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

    ptrs, keep = [], []  # keep: the operands stay alive through the launch
    for layer in params:
        w = _f32(layer[0], device, "weight")
        co, ci = w.shape
        wt = padded_transpose(w)                   # (ci8, co8), the recompute
        w_pad = torch.zeros((co, (ci + 3) // 4 * 4), dtype=torch.float32,
                            device=device)
        w_pad[:, :ci] = w                          # (co, ci_pad), d_in
        rest = [_f32(a, device, "bias/gamma/beta") for a in layer[1:]]
        keep += [wt, w_pad, *rest]
        ptrs += [wt.data_ptr(), w_pad.data_ptr(),
                 *(a.data_ptr() for a in rest)]
        if not layer_norm:
            ptrs += [None, None]

    need_xyz, need_new, need_feat = needs
    need_feat = need_feat and features is not None
    d_xyz = torch.zeros_like(xyz) if need_xyz else None
    d_feat = torch.zeros_like(features) if need_feat else None
    d_new = torch.empty_like(new_xyz) if need_new else None
    rows = B * S * nsample
    scratch = torch.empty(scratch_floats(chans, rows), dtype=torch.float32,
                          device=device)
    n_vec = sum(chans[1:]) * (3 if layer_norm else 1)
    vec = torch.empty((B * S, n_vec), dtype=torch.float32, device=device)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    need = int(need_xyz) | 2 * int(need_new) | 4 * int(need_feat)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _bind_bwd()(xyz.data_ptr(), new_xyz.data_ptr(), ptr(features),
                      idx.data_ptr(), pooled.data_ptr(), d_pooled.data_ptr(),
                      B, N, S, F, nsample, len(params), c_chans, c_ptrs,
                      int(layer_norm), need, ptr(d_xyz), ptr(d_feat),
                      ptr(d_new), scratch.data_ptr(), vec.data_ptr(),
                      build.stream_ptr(device))
    build.check(err, "fused_sa_backward")
    fused_sa_bwd_cuda.launches += 1
    return d_xyz, d_new, d_feat, scratch, vec, chans


fused_sa_bwd_cuda.launches = 0


def sa_weight_grad_cuda(scratch: torch.Tensor, vec: torch.Tensor, chans,
                        layer_norm: bool, rows: int):
    """K2: the level's weight gradients from K1's ``scratch`` rows and
    ``vec`` sums -> per layer (dW (C_out, C_in), db) plus (dgamma, dbeta)
    with LayerNorm, the same bits from run to run."""
    device = scratch.device
    n_layers = len(chans) - 1
    queries = vec.shape[0]
    for t, what in ((scratch, "scratch"), (vec, "vec")):
        if t.device.type != "cuda" or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous float32 on the card")
    if scratch.numel() != scratch_floats(chans, rows) or \
            vec.shape[1] != sum(chans[1:]) * (3 if layer_norm else 1):
        raise ValueError("scratch and vec do not follow the level's widths")
    splits = max(1, -(-rows // SPLIT_ROWS))
    sizes = [co * ci for ci, co in zip(chans[:-1], chans[1:])]
    vec_sizes = [co for co in chans[1:] for _ in range(3 if layer_norm
                                                       else 1)]
    slot = sum(sizes) + sum(vec_sizes)
    part = torch.empty((splits, slot), dtype=torch.float32, device=device)
    out = torch.empty(slot, dtype=torch.float32, device=device)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    err = _bind_wgrad()(scratch.data_ptr(), vec.data_ptr(), rows, queries,
                        n_layers, c_chans, int(layer_norm), splits,
                        part.data_ptr(), out.data_ptr(),
                        build.stream_ptr(device))
    build.check(err, "sa_weight_grad")
    sa_weight_grad_cuda.launches += 1
    pieces = iter(torch.split(out, sizes + vec_sizes))
    dws = [next(pieces).view(co, ci)
           for ci, co in zip(chans[:-1], chans[1:])]
    return [(dw, *(next(pieces) for _ in range(3 if layer_norm else 1)))
            for dw in dws]


sa_weight_grad_cuda.launches = 0


def fused_sa_backward_cuda(nsample: int, layer_norm: bool, xyz, new_xyz,
                           features, params, idx, pooled, d_pooled,
                           needs=(True, True, True)):
    """The level's whole backward on the card, K1 then K2 -> (d_xyz,
    d_new_xyz, d_features, each None where not asked; per-layer gradients
    shaped like ``params``)."""
    d_xyz, d_new, d_feat, scratch, vec, chans = fused_sa_bwd_cuda(
        nsample, layer_norm, xyz, new_xyz, features, params, idx, pooled,
        d_pooled, needs)
    grads = sa_weight_grad_cuda(scratch, vec, chans, layer_norm,
                                idx.numel())
    return d_xyz, d_new, d_feat, grads


def padded_bf16(w: torch.Tensor) -> torch.Tensor:
    """A Dense weight (C_out, C_in) -> rounded to bf16 (to nearest even)
    and zero-padded to multiples of 16: the layout of the bf16 product
    (the mma's k of 16; a B fragment is two consecutive k of one row)."""
    co, ci = w.shape
    return torch.nn.functional.pad(w, (0, -ci % 16, 0, -co % 16)) \
        .to(torch.bfloat16).contiguous()


def _forward(radius: float, nsample: int, layer_norm: bool,
             xyz: torch.Tensor, new_xyz: torch.Tensor,
             features: torch.Tensor | None, params, bf16: bool = False):
    """Launch ``csrc/fused_sa_fwd.cu`` (its bf16 mode with ``bf16``) ->
    (pooled, idx)."""
    xyz, new_xyz, features, F, chans = _check_level(xyz, new_xyz, features,
                                                    params, layer_norm)
    device = xyz.device
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    layout = padded_bf16 if bf16 else padded_transpose
    ptrs, keep = [], []  # keep: the operands stay alive through the launch
    for layer in params:
        wt = layout(_f32(layer[0], device, "weight"))
        rest = [_f32(a, device, "bias/gamma/beta") for a in layer[1:]]
        keep += [wt, *rest]
        ptrs += [wt.data_ptr(), *(a.data_ptr() for a in rest)]
        if not layer_norm:
            ptrs += [None, None]

    pooled = torch.empty((B, S, chans[-1]), dtype=torch.float32, device=device)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=device)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    err = _bind(bf16)(xyz.data_ptr(), new_xyz.data_ptr(),
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


def fused_sa_bf16_cuda(radius: float, nsample: int, layer_norm: bool,
                       xyz: torch.Tensor, new_xyz: torch.Tensor,
                       features: torch.Tensor | None, params):
    """The level's bf16 mode on the card (forward only) -> (pooled
    (B, S, C_last) f32, idx (B, S, nsample) int32): every layer product on
    operands rounded to bf16, summed in f32
    (``ops.fused_sa.fused_sa_forward_plain(..., precision="bf16")``).
    Arguments as :func:`fused_sa_cuda`; counted apart from it."""
    out = _forward(radius, nsample, layer_norm, xyz, new_xyz, features,
                   params, bf16=True)
    fused_sa_bf16_cuda.launches += 1
    return out


fused_sa_bf16_cuda.launches = 0


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
