"""K1's bf16 mode (``csrc/fused_sa_bwd_bf16.cu``), on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain bf16 backward there). Here, with inputs made by numpy from a seed at
sa1's and sa2's widths and a level without LayerNorm, the arithmetic of its
addressing:

- the input gradient ``d_pre · W`` reads each layer's weight from the
  level's packed image (``pack_image``, the bf16 forward's, K-major for the
  recompute) MN-major, through wgmma's transpose of B: a core matrix is 8
  k-rows (the layer's outputs) of 8 consecutive n (its inputs), 128 bytes
  between core matrices along K' and ``np x 16`` along N'. Emulating the
  descriptor's addresses gives back the padded bf16 weight bitwise, and a
  moved stride does not;
- the scratch rows leave the registers as the kernel's ``store_rows``
  moves them (rows paired across lanes g, g ^ 1, columns gathered in fours
  across lanes t4, t4 ^ 1, 16-byte stores): an emulation of its lanes
  writes K2's pair-interleaved layout exactly;
- ``FusedSALevel`` saves the image the bf16 forward packed and hands it to
  the backward (the CUDA wrappers replaced by their plain twins): its
  gradients are bitwise ``PlainBf16Level``'s.
"""
import numpy as np
import pytest
import torch

from maskplanner_tpu_torch.ops.cuda import fused_sa as cuda_sa
from maskplanner_tpu_torch.ops.fused_sa import (FusedSALevel, PlainBf16Level,
                                                fused_sa_backward_plain,
                                                fused_sa_forward_plain)

# (channels, LayerNorm): sa1, sa2 and a level without a norm
LEVELS = {"sa1": ((3, 64, 64, 128), True),
          "sa2": ((131, 128, 128, 256), True),
          "none": ((14, 32, 48), False)}
# csrc/fused_sa_bwd_bf16.cu: kTransLbo, and np x 16 along N'
TRANS_LBO = 128


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _params(chans, layer_norm, seed):
    rng = np.random.default_rng(seed)
    params = []
    for ci, co in zip(chans[:-1], chans[1:]):
        shapes = [(co, ci)] + [(co,)] * (3 if layer_norm else 1)
        params.append(tuple(torch.from_numpy(
            (rng.normal(size=s) * 0.3).astype(np.float32)) for s in shapes))
    return params


def _desc(addr: int, lbo: int, sbo: int) -> int:
    """``wgmma_bf16.cuh::desc``: the start address, LBO and SBO in 16-byte
    units in bits 0-13, 16-29 and 32-45."""
    return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32)


def _mn_major_tile(image: np.ndarray, desc: int, k: int, n: int):
    """The (k, n) bf16 tile an MN-major B descriptor without swizzle reads:
    element (kk, nn) at start + (kk // 8) LBO + (nn // 8) SBO + (kk % 8) 16
    + (nn % 8) 2 bytes."""
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    at = start + (kk // 8) * lbo + (nn // 8) * sbo + (kk % 8) * 16 \
        + (nn % 8) * 2
    halves = image.view(np.int16)
    assert (at % 2 == 0).all()
    return halves[at // 2]


def _input_grad_operand(image, off, kp, np_, lbo=TRANS_LBO, sbo=None):
    """B' = W (np_ x kp: K' the layer's padded outputs, N' its padded inputs)
    as the kernel's input gradient reads it, one k-step of 16 at a time (its
    descriptor at ``off + 256 j``), pieced together."""
    sbo = 16 * np_ if sbo is None else sbo
    steps = [_mn_major_tile(image, _desc(off + 256 * j, lbo, sbo), 16, kp)
             for j in range(np_ // 16)]
    return np.concatenate(steps, axis=0)


@pytest.mark.parametrize("level", LEVELS)
def test_input_gradient_reads_the_packed_weight_mn_major(level):
    """Read MN-major under the kernel's strides, the packed image gives back
    every layer's bf16 weight (zero-padded to (np, kp)) bitwise, the K' of
    the input gradient's product being the weight's rows: d_in = d_pre · W;
    with a moved stride it does not."""
    chans, layer_norm = LEVELS[level]
    params = _params(chans, layer_norm, seed=sum(chans))
    image = cuda_sa.pack_image(params, layer_norm).numpy()
    kp, np_ = cuda_sa.padded_widths(list(chans))
    offsets, _ = cuda_sa.image_offsets(list(chans))
    for (w, *_), k, n, off in zip(params, kp, np_, offsets):
        padded = torch.zeros((n, k), dtype=torch.bfloat16)
        padded[:w.shape[0], :w.shape[1]] = w.to(torch.bfloat16)
        want = padded.view(torch.int16).numpy()
        got = _input_grad_operand(image, off, k, n)
        assert got.shape == (n, k)
        np.testing.assert_array_equal(got, want)
        # the strides swapped, or N' stepped as if one core matrix narrower
        for moved in (dict(lbo=16 * n, sbo=TRANS_LBO),
                      dict(sbo=16 * n - 128)):
            bad = _input_grad_operand(image, off, k, n, **moved)
            assert not np.array_equal(bad, want)


def _store_rows(acc_words: np.ndarray, width: int) -> dict:
    """Emulate ``store_rows`` of one warp (fast path): ``acc_words[lane, j,
    r]`` is the kernel's A register a[j][r] of each lane (two bf16 values,
    the lower column in the low half). -> {element offset: 32-bit word} of
    the 16-byte stores, the warp's first row pair at 0."""
    out = {}
    for j in range(acc_words.shape[1]):
        if 16 * j >= width:
            continue
        a = acc_words[:, j, :]

        def shfl(vals, mask):
            return np.array([vals[lane ^ mask] for lane in range(32)])

        lanes = np.arange(32)
        g8, t4 = lanes >> 2, lanes & 3
        even = (g8 & 1) == 0
        r0 = shfl(np.where(even, a[:, 1], a[:, 0]), 4)
        r2 = shfl(np.where(even, a[:, 3], a[:, 2]), 4)
        lo0 = np.where(even, a[:, 0], r0)
        hi0 = np.where(even, r0, a[:, 1])
        lo1 = np.where(even, a[:, 2], r2)
        hi1 = np.where(even, r2, a[:, 3])

        def prmt_lo(x, y):   # __byte_perm(x, y, 0x5410)
            return (x & 0xFFFF) | ((y & 0xFFFF) << 16)

        def prmt_hi(x, y):   # __byte_perm(x, y, 0x7632)
            return (x >> 16) | (y & 0xFFFF0000)

        w00, w01 = prmt_lo(lo0, hi0), prmt_hi(lo0, hi0)
        w10, w11 = prmt_lo(lo1, hi1), prmt_hi(lo1, hi1)
        te = (t4 & 1) == 0
        y0 = shfl(np.where(te, w10, w00), 1)
        y1 = shfl(np.where(te, w11, w01), 1)
        for lane in range(32):
            pair = g8[lane] // 2 if even[lane] else (g8[lane] + 7) // 2
            c = 16 * j + 2 * t4[lane] if te[lane] \
                else 16 * j + 8 + 2 * (t4[lane] - 1)
            if c >= width:
                continue
            words = (w00[lane], w01[lane], y0[lane], y1[lane]) if te[lane] \
                else (y0[lane], y1[lane], w10[lane], w11[lane])
            base = pair * 2 * width + 2 * c
            assert base % 8 == 0   # 16-byte aligned
            for q, word in enumerate(words):
                out[base + 2 * q] = int(word)
    return out


@pytest.mark.parametrize("width", [4, 64, 128, 256, 132])
def test_scratch_rows_leave_the_registers_pair_interleaved(width):
    """A warp's 16 rows in the accumulator (A-fragment) layout, stored as
    ``store_rows`` stores them, land in K2's layout: element (r, c) at
    (r / 2) 2 w + 2 c + r % 2, every element once."""
    rng = np.random.default_rng(width)
    nk = -(-width // 16)
    rows = rng.integers(0, 1 << 16, size=(16, 16 * nk), dtype=np.uint32)
    rows[:, width:] = 0
    # a[j][r] of lane (g8, t4): rows g8 (r even) / g8 + 8 (r odd), columns
    # 16 j + 8 (r // 2) + 2 t4 and + 1
    words = np.zeros((32, nk, 4), np.uint32)
    for lane in range(32):
        g8, t4 = lane >> 2, lane & 3
        for j in range(nk):
            for r in range(4):
                row = g8 + 8 * (r % 2)
                c = 16 * j + 8 * (r // 2) + 2 * t4
                words[lane, j, r] = rows[row, c] | (rows[row, c + 1] << 16)
    stored = _store_rows(words, width)
    want = np.zeros(16 * width, np.uint32)
    for r in range(16):
        for c in range(width):
            want[(r // 2) * 2 * width + 2 * c + r % 2] = rows[r, c]
    halves = np.zeros(16 * width, np.uint32)
    for at, word in stored.items():
        halves[at] = word & 0xFFFF
        halves[at + 1] = word >> 16
    assert len(stored) * 2 == 16 * width
    np.testing.assert_array_equal(halves, want)


def test_fused_level_hands_the_forward_image_to_the_backward(monkeypatch):
    """``FusedSALevel`` in bf16 asks the forward for the level's packed
    image, saves it and hands that same tensor to the backward: with the
    CUDA wrappers replaced by their plain twins (the image ``pack_image``'s,
    the card's packing's plain version), its gradients are bitwise
    ``PlainBf16Level``'s, at sa1's widths."""
    chans, layer_norm = LEVELS["sa1"]
    K = 32
    rng = np.random.default_rng(11)
    xyz = torch.from_numpy((rng.normal(size=(2, 96, 3)) * 0.3)
                           .astype(np.float32))
    new_xyz = xyz[:, :12].clone()
    params = _params(chans, layer_norm, seed=7)
    ct = torch.from_numpy(rng.normal(size=(2, 12, chans[-1]))
                          .astype(np.float32))
    seen = {}

    def forward(radius, nsample, layer_norm, xyz, new_xyz, features, params,
                winner=False, image=False):
        out = fused_sa_forward_plain(radius, nsample,
                                     "layer" if layer_norm else "none", xyz,
                                     new_xyz, features, params, "bf16",
                                     winner=winner)
        assert winner and image
        seen["image"] = cuda_sa.pack_image(params, layer_norm)
        return (*out, seen["image"])

    def backward(nsample, layer_norm, xyz, new_xyz, features, params, idx,
                 pooled, d_pooled, needs=(True, True, True), bf16=False,
                 winner=None, image=None):
        assert bf16 and image is seen["image"]
        seen["backward"] = image
        return fused_sa_backward_plain(nsample,
                                       "layer" if layer_norm else "none",
                                       xyz, new_xyz, features, params, idx,
                                       pooled, d_pooled, needs,
                                       precision="bf16", winner=winner)

    monkeypatch.setattr(cuda_sa, "fused_sa_bf16_cuda", forward)
    monkeypatch.setattr(cuda_sa, "fused_sa_backward_cuda", backward)
    grads = []
    for level in (FusedSALevel, PlainBf16Level):
        xs = [xyz.clone().requires_grad_(True),
              new_xyz.clone().requires_grad_(True)]
        ps = [tuple(a.clone().requires_grad_(True) for a in layer)
              for layer in params]
        flat = [a for layer in ps for a in layer]
        head = (0.3, K, True, True) if level is FusedSALevel else \
            (0.3, K, "layer")
        pooled, _ = level.apply(*head, *xs, None, 4, *flat)
        grads.append(torch.autograd.grad((pooled * ct).sum(), xs + flat))
    assert seen["backward"] is seen["image"]
    assert seen["image"].numel() == cuda_sa.image_bytes(list(chans), True)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
