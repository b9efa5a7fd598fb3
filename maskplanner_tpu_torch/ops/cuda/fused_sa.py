"""Wrappers of the fused set-abstraction kernels: the forward
(``csrc/fused_sa_fwd.cu``; its bf16 mode ``csrc/fused_sa_fwd_bf16.cu``)
and the backward in two kernels, K1 (``csrc/fused_sa_bwd.cu``: recompute,
routing, input gradients, the rows of the weight gradient; its bf16 mode
``csrc/fused_sa_bwd_bf16.cu``, on the bf16 forward's packed image) and K2
(``csrc/sa_weight_grad.cu``: the weight gradients as fixed-order split-K
products, also in a bf16 mode).

``fused_sa_cuda.launches``, ``fused_sa_bf16_cuda.launches`` (the forward's
bf16 mode), ``folded_sa_cuda.launches`` (the forward on BatchNorm-folded
weights), ``fused_sa_bwd_cuda.launches`` (K1),
``fused_sa_bwd_bf16_cuda.launches`` (K1's bf16 mode),
``sa_weight_grad_cuda.launches`` (K2) and
``sa_weight_grad_bf16_cuda.launches`` (K2's bf16 mode) count the kernels'
launches (a run that should go through a kernel reads its count after
resetting it to 0).
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


def bwd_signature(fn, bf16: bool = False):
    """Set the ctypes signature of K1's C entry point ``fn`` (its bf16
    mode's with ``bf16``: the forward's winner and its bytes an element
    after ``d_pooled``, and the level's packed image in place of the
    layers' pointers)."""
    fn.restype = ctypes.c_int
    if bf16:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6
        return fn
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    return fn


@functools.cache
def _bind_bwd(bf16: bool):
    if bf16:
        return bwd_signature(
            build.library("fused_sa_bwd_bf16").fused_sa_backward_bf16, True)
    return bwd_signature(build.library("fused_sa_bwd").fused_sa_backward)


@functools.cache
def _bind_wgrad(bf16: bool):
    lib = build.library("sa_weight_grad")
    fn = lib.sa_weight_grad_bf16 if bf16 else lib.sa_weight_grad
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
def _bind():
    return fwd_signature(build.library("fused_sa_fwd").fused_sa_forward)


def fwd_bf16_signature(fn):
    """Set the ctypes signature of the bf16 forward's C entry point
    ``fn`` (``csrc/fused_sa_fwd_bf16.cu``)."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    return fn


@functools.cache
def _bind_bf16():
    return fwd_bf16_signature(
        build.library("fused_sa_fwd_bf16").fused_sa_forward_bf16)


@functools.cache
def _bind_pack():
    fn = build.library("fused_sa_fwd_bf16").fused_sa_pack_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
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
    layer's input (rows, C_in rounded up to a multiple of 4). The bf16 mode
    holds as many bf16 values, its rows rounded up to even."""
    return rows * sum(co + (ci + 3) // 4 * 4
                      for ci, co in zip(chans[:-1], chans[1:]))


def _bwd(nsample: int, layer_norm: bool, xyz, new_xyz, features, params,
         idx, pooled, d_pooled, needs, bf16: bool, winner=None, image=None):
    """Launch K1 (its bf16 mode with ``bf16``, which routes by the bf16
    forward's ``winner`` and reads the level's packed ``image``, packed
    here when None) -> (d_xyz, d_new_xyz, d_features, scratch, vec,
    chans)."""
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

    need_xyz, need_new, need_feat = needs
    need_feat = need_feat and features is not None
    d_xyz = torch.zeros_like(xyz) if need_xyz else None
    d_feat = torch.zeros_like(features) if need_feat else None
    d_new = torch.empty_like(new_xyz) if need_new else None
    rows = B * S * nsample
    n_vec = sum(chans[1:]) * (3 if layer_norm else 1)
    vec = torch.empty((B * S, n_vec), dtype=torch.float32, device=device)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    need = int(need_xyz) | 2 * int(need_new) | 4 * int(need_feat)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    head = (xyz.data_ptr(), new_xyz.data_ptr(), ptr(features),
            idx.data_ptr(), pooled.data_ptr(), d_pooled.data_ptr())
    tail = (ptr(d_xyz), ptr(d_feat), ptr(d_new))
    if bf16:
        if max(chans[1:]) > MAX_WIDTH:
            raise ValueError(f"K1's bf16 mode takes layers of at most "
                             f"{MAX_WIDTH} channels, got {chans[1:]}")
        if winner is None or winner.shape != shape \
                or winner.dtype != winner_dtype(nsample) \
                or winner.device != device:
            raise ValueError(f"K1's bf16 mode routes by the bf16 forward's "
                             f"winner: {shape} {winner_dtype(nsample)} on "
                             f"{device}")
        winner = winner.contiguous()
        if image is None:
            image = pack_image_cuda(params, layer_norm)
        if image.dtype != torch.uint8 or image.device != device or \
                image.numel() != image_bytes(chans, layer_norm):
            raise ValueError(f"the level's image must be "
                             f"{image_bytes(chans, layer_norm)} bytes "
                             f"(uint8) on {device}")
        image = image.contiguous()
        # rows in pairs: an odd last row's partner must read zero
        alloc = torch.zeros if rows % 2 else torch.empty
        scratch = alloc(scratch_floats(chans, rows + rows % 2),
                        dtype=torch.bfloat16, device=device)
        err = _bind_bwd(True)(*head, winner.data_ptr(),
                              winner.element_size(), B, N, S, F, nsample,
                              len(params), c_chans, int(layer_norm),
                              image.data_ptr(), image.numel(), need, *tail,
                              scratch.data_ptr(), vec.data_ptr(),
                              build.stream_ptr(device))
        build.check(err, "fused_sa_backward_bf16")
        return d_xyz, d_new, d_feat, scratch, vec, chans

    ptrs, keep = [], []  # keep: the operands stay alive through the launch
    for layer in params:
        w = _f32(layer[0], device, "weight")
        co, ci = w.shape
        w_pad = torch.zeros((co, (ci + 3) // 4 * 4), dtype=torch.float32,
                            device=device)
        w_pad[:, :ci] = w                      # (co, ci_pad), d_in
        ws = [padded_transpose(w), w_pad]      # (ci8, co8), the recompute
        rest = [_f32(a, device, "bias/gamma/beta") for a in layer[1:]]
        keep += [*ws, *rest]
        ptrs += [*(a.data_ptr() for a in ws), *(a.data_ptr() for a in rest)]
        if not layer_norm:
            ptrs += [None, None]
    scratch = torch.empty(scratch_floats(chans, rows), dtype=torch.float32,
                          device=device)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    err = _bind_bwd(False)(*head, B, N, S, F, nsample, len(params), c_chans,
                           c_ptrs, int(layer_norm), need, *tail,
                           scratch.data_ptr(), vec.data_ptr(),
                           build.stream_ptr(device))
    build.check(err, "fused_sa_backward")
    return d_xyz, d_new, d_feat, scratch, vec, chans


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
    out = _bwd(nsample, layer_norm, xyz, new_xyz, features, params, idx,
               pooled, d_pooled, needs, False)
    fused_sa_bwd_cuda.launches += 1
    return out


fused_sa_bwd_cuda.launches = 0


def fused_sa_bwd_bf16_cuda(nsample: int, layer_norm: bool,
                           xyz: torch.Tensor, new_xyz: torch.Tensor,
                           features: torch.Tensor | None, params,
                           idx: torch.Tensor, pooled: torch.Tensor,
                           d_pooled: torch.Tensor, needs=(True, True, True),
                           winner: torch.Tensor | None = None,
                           image: torch.Tensor | None = None):
    """K1's bf16 mode (``csrc/fused_sa_bwd_bf16.cu``): the backward of
    :func:`fused_sa_bf16_cuda` from its ``idx``, ``pooled`` and ``winner``
    (``d_pooled[c]`` goes to the winner's row where ``pooled[c] > 0``:
    ``ops.fused_sa.fused_sa_backward_plain(..., precision="bf16",
    winner=)``), on the level's packed ``image`` (the bf16 forward's, from
    ``fused_sa_bf16_cuda(..., image=True)``; None: packed here by
    :func:`pack_image_cuda`) -> as :func:`fused_sa_bwd_cuda`, its scratch
    rows bf16 (for :func:`sa_weight_grad_bf16_cuda`). Every layer at most
    256 channels. Counted apart."""
    out = _bwd(nsample, layer_norm, xyz, new_xyz, features, params, idx,
               pooled, d_pooled, needs, True, winner, image)
    fused_sa_bwd_bf16_cuda.launches += 1
    return out


fused_sa_bwd_bf16_cuda.launches = 0


def _wgrad(scratch: torch.Tensor, vec: torch.Tensor, chans,
           layer_norm: bool, rows: int, bf16: bool):
    device = scratch.device
    n_layers = len(chans) - 1
    queries = vec.shape[0]
    dtype = torch.bfloat16 if bf16 else torch.float32
    for t, what, want in ((scratch, "scratch", dtype),
                          (vec, "vec", torch.float32)):
        if t.device.type != "cuda" or t.dtype != want \
                or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous {want} on the card")
    if scratch.numel() != scratch_floats(chans, rows + (rows % 2 if bf16
                                                        else 0)) or \
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
    err = _bind_wgrad(bf16)(scratch.data_ptr(), vec.data_ptr(), rows,
                            queries, n_layers, c_chans, int(layer_norm),
                            splits, part.data_ptr(), out.data_ptr(),
                            build.stream_ptr(device))
    build.check(err, "sa_weight_grad")
    pieces = iter(torch.split(out, sizes + vec_sizes))
    dws = [next(pieces).view(co, ci)
           for ci, co in zip(chans[:-1], chans[1:])]
    return [(dw, *(next(pieces) for _ in range(3 if layer_norm else 1)))
            for dw in dws]


def sa_weight_grad_cuda(scratch: torch.Tensor, vec: torch.Tensor, chans,
                        layer_norm: bool, rows: int):
    """K2: the level's weight gradients from K1's ``scratch`` rows and
    ``vec`` sums -> per layer (dW (C_out, C_in), db) plus (dgamma, dbeta)
    with LayerNorm, the same bits from run to run."""
    out = _wgrad(scratch, vec, chans, layer_norm, rows, False)
    sa_weight_grad_cuda.launches += 1
    return out


sa_weight_grad_cuda.launches = 0


def sa_weight_grad_bf16_cuda(scratch: torch.Tensor, vec: torch.Tensor,
                             chans, layer_norm: bool, rows: int):
    """K2's bf16 mode, on the bf16 scratch of :func:`fused_sa_bwd_bf16_cuda`:
    dW = Σ bf16(d_pre)ᵀ · bf16(in) summed in f32, the rest as
    :func:`sa_weight_grad_cuda`. Counted apart."""
    out = _wgrad(scratch, vec, chans, layer_norm, rows, True)
    sa_weight_grad_bf16_cuda.launches += 1
    return out


sa_weight_grad_bf16_cuda.launches = 0


def fused_sa_backward_cuda(nsample: int, layer_norm: bool, xyz, new_xyz,
                           features, params, idx, pooled, d_pooled,
                           needs=(True, True, True), bf16: bool = False,
                           winner: torch.Tensor | None = None,
                           image: torch.Tensor | None = None):
    """The level's whole backward on the card, K1 then K2 (their bf16 modes
    with ``bf16``, routed by the bf16 forward's ``winner`` on its packed
    ``image``) -> (d_xyz, d_new_xyz, d_features, each None where not asked;
    per-layer gradients shaped like ``params``)."""
    args = (nsample, layer_norm, xyz, new_xyz, features, params, idx,
            pooled, d_pooled, needs)
    if bf16:
        d_xyz, d_new, d_feat, scratch, vec, chans = fused_sa_bwd_bf16_cuda(
            *args, winner=winner, image=image)
        k2 = sa_weight_grad_bf16_cuda
    else:
        d_xyz, d_new, d_feat, scratch, vec, chans = fused_sa_bwd_cuda(*args)
        k2 = sa_weight_grad_cuda
    grads = k2(scratch, vec, chans, layer_norm, idx.numel())
    return d_xyz, d_new, d_feat, grads


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
        wt = padded_transpose(_f32(layer[0], device, "weight"))
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


# the bf16 forward's widths: a layer's output padded to a multiple of
# WIDTH_STEP (one wgmma of n 64, 128, 192 or 256), at most MAX_WIDTH; the
# gathered rows to a multiple of 16 (wgmma's k)
WIDTH_STEP = 64
MAX_WIDTH = 256


def padded_widths(chans) -> tuple[list, list]:
    """The bf16 forward's padded widths of a level of channels ``chans``
    -> (kp, np): layer l takes kp[l] inputs (layer 0's rows rounded up to
    16, else the previous layer's np) and gives np[l] outputs (rounded up
    to ``WIDTH_STEP``)."""
    np_ = [-(-co // WIDTH_STEP) * WIDTH_STEP for co in chans[1:]]
    kp = [-(-chans[0] // 16) * 16] + np_[:-1]
    return kp, np_


def pack_wgmma(w: torch.Tensor, kp: int, np_: int) -> torch.Tensor:
    """A Dense weight (C_out, C_in) -> rounded to bf16 (to nearest even),
    zero-padded to (np_, kp) and packed in wgmma's K-major core-matrix
    layout without swizzle, the bf16 forward's B operand (the plain version
    of what ``fused_sa_pack_bf16_kernel`` writes): core matrices of
    8 output rows x 8 inputs (16 bytes a row, 128 contiguous bytes each),
    the input chunks outermost. Element (o, i) lies at flat index
    ``((i // 8) * (np_ // 8) + o // 8) * 64 + (o % 8) * 8 + i % 8``, so the
    result is ``(kp // 8, np_ // 8, 8, 8)``."""
    co, ci = w.shape
    if (co, ci) != (np_, kp):
        w = torch.nn.functional.pad(w, (0, kp - ci, 0, np_ - co))
    out = torch.empty((kp // 8, np_ // 8, 8, 8), dtype=torch.bfloat16,
                      device=w.device)
    out.copy_(w.view(np_ // 8, 8, kp // 8, 8).permute(2, 0, 1, 3))
    return out


def pack_vectors(params, layer_norm: bool, np_) -> torch.Tensor:
    """The bf16 forward's vectors, f32: per layer the bias, then with
    LayerNorm the gamma and the beta, each zero-padded to the layer's
    padded width."""
    parts = []
    for layer, width in zip(params, np_):
        for a in layer[1:4 if layer_norm else 2]:
            parts.append(a if a.shape[0] == width else
                         torch.nn.functional.pad(a, (0, width - a.shape[0])))
    return torch.cat(parts)


def image_offsets(chans) -> tuple[list, int]:
    """Where the bf16 forward's image keeps each layer's packed weight
    (bytes, each at a multiple of 128) and where its vectors begin."""
    kp, np_ = padded_widths(chans)
    offsets, at = [], 0
    for k, n in zip(kp, np_):
        offsets.append(at)
        at += -(-k * n * 2 // 128) * 128
    return offsets, at


def image_bytes(chans, layer_norm: bool) -> int:
    """Bytes of the bf16 forward's image of a level of channels ``chans``."""
    _, np_ = padded_widths(chans)
    return image_offsets(chans)[1] + 4 * sum(np_) * (3 if layer_norm else 1)


def pack_image(params, layer_norm: bool) -> torch.Tensor:
    """The plain version of the image that ``csrc/fused_sa_fwd_bf16.cu``
    packs on the card (``fused_sa_pack_bf16_kernel``) and copies into
    shared memory: each layer's :func:`pack_wgmma` at its
    :func:`image_offsets` offset (zero between), then
    :func:`pack_vectors` -> uint8 (``image_bytes``,)."""
    chans = [params[0][0].shape[1]] + [layer[0].shape[0] for layer in params]
    kp, np_ = padded_widths(chans)
    offsets, at = image_offsets(chans)
    out = torch.zeros(image_bytes(chans, layer_norm), dtype=torch.uint8,
                      device=params[0][0].device)
    for layer, k, n, off in zip(params, kp, np_, offsets):
        w = pack_wgmma(layer[0], k, n).reshape(-1).view(torch.uint8)
        out[off:off + w.numel()] = w
    out[at:] = pack_vectors(params, layer_norm, np_).view(torch.uint8)
    return out


def winner_dtype(nsample: int) -> torch.dtype:
    """The bf16 forward's winner: one byte a channel up to K 256."""
    return torch.uint8 if nsample <= 256 else torch.int32


def _layer_pointers(params, layer_norm: bool, device):
    """The level's f32 tensors (kept alive by the caller) and their
    pointers, four a layer, gamma and beta null without LayerNorm."""
    keep, ptrs = [], []
    for layer in params:
        ts = [_f32(a, device, "weight/bias/gamma/beta") for a in layer]
        keep += ts
        ptrs += [t.data_ptr() for t in ts] + ([] if layer_norm
                                               else [None, None])
    return keep, (ctypes.c_void_p * len(ptrs))(*ptrs)


def pack_image_cuda(params, layer_norm: bool) -> torch.Tensor:
    """``fused_sa_pack_bf16_kernel`` alone: the image the bf16 forward
    packs before its kernel, for holding against :func:`pack_image`."""
    device = params[0][0].device
    chans = [params[0][0].shape[1]] + [layer[0].shape[0] for layer in params]
    keep, c_ptrs = _layer_pointers(params, layer_norm, device)
    out = torch.empty(image_bytes(chans, layer_norm), dtype=torch.uint8,
                      device=device)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    err = _bind_pack()(len(params), c_chans, c_ptrs, int(layer_norm),
                       out.data_ptr(), out.numel(), build.stream_ptr(device))
    build.check(err, "fused_sa_pack_bf16")
    return out


def _forward_bf16(radius: float, nsample: int, layer_norm: bool,
                  xyz: torch.Tensor, new_xyz: torch.Tensor,
                  features: torch.Tensor | None, params, winner: bool):
    """Launch ``csrc/fused_sa_fwd_bf16.cu`` (its image's packing, then the
    level) -> (pooled, idx, winner or None, the level's packed image)."""
    xyz, new_xyz, features, F, chans = _check_level(xyz, new_xyz, features,
                                                    params, layer_norm)
    if max(chans[1:]) > MAX_WIDTH:
        raise ValueError(f"the bf16 fused SA forward takes layers of at most "
                         f"{MAX_WIDTH} channels, got {chans[1:]}")
    device = xyz.device
    B, N, _ = xyz.shape
    S = new_xyz.shape[1]
    keep, c_ptrs = _layer_pointers(params, layer_norm, device)
    image = torch.empty(image_bytes(chans, layer_norm), dtype=torch.uint8,
                        device=device)
    shape = (B, S, chans[-1])
    pooled = torch.empty(shape, dtype=torch.float32, device=device)
    idx = torch.empty((B, S, nsample), dtype=torch.int32, device=device)
    win = (torch.empty(shape, dtype=winner_dtype(nsample), device=device)
           if winner else None)
    c_chans = (ctypes.c_int * len(chans))(*chans)
    err = _bind_bf16()(xyz.data_ptr(), new_xyz.data_ptr(),
                       None if features is None else features.data_ptr(),
                       B, N, S, F, nsample, float(radius) ** 2, len(params),
                       c_chans, c_ptrs, int(layer_norm), image.data_ptr(),
                       image.numel(), pooled.data_ptr(), idx.data_ptr(),
                       None if win is None else win.data_ptr(),
                       0 if win is None else win.element_size(),
                       build.stream_ptr(device))
    build.check(err, "fused_sa_forward_bf16")
    return pooled, idx, win, image


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
                       features: torch.Tensor | None, params,
                       winner: bool = False, image: bool = False):
    """The level's bf16 mode on the card (``csrc/fused_sa_fwd_bf16.cu``;
    its backward: :func:`fused_sa_bwd_bf16_cuda`) -> (pooled
    (B, S, C_last) f32, idx (B, S, nsample) int32), and with ``winner``
    the max-pool's winner (B, S, C_last) (:func:`winner_dtype`: the first
    neighbour whose last activation is the max, which the backward routes
    to), and with ``image`` the level's packed image (:func:`pack_image`'s
    layout, which the backward reads too): every layer product on operands
    rounded to bf16, summed in f32
    (``ops.fused_sa.fused_sa_forward_plain(..., precision="bf16")``).
    Arguments as :func:`fused_sa_cuda`, every layer at most 256 channels;
    counted apart from it."""
    pooled, idx, win, packed = _forward_bf16(radius, nsample, layer_norm,
                                             xyz, new_xyz, features, params,
                                             winner)
    fused_sa_bf16_cuda.launches += 1
    return (pooled, idx) + ((win,) if winner else ()) + (
        (packed,) if image else ())


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
