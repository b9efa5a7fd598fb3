"""The max-pool winner of the fused SA level's bf16 forward, on the CPU.

The bf16 forward on the card (``csrc/fused_sa_fwd_bf16.cu``) sums its
products in wgmma's order and normalises in registers, so the bf16
backward (K1) cannot find the max-pool's winner by equality with a
recompute: the forward writes the winner (the first neighbour whose last
activation is the max) and the backward routes ``d_pooled`` to it. Here,
on the plain twins with inputs made by numpy from a seed, narrow widths and
the flagship's K:

- ``fused_sa_forward_plain(..., winner=True)`` gives the first argmax,
  also where a ball holds fewer than K points (its padding repeats the
  first neighbour: ties);
- ``fused_sa_backward_plain(..., winner=)`` is bitwise the equality-routed
  backward, in f32 and bf16, with and without LayerNorm and features;
- the winner-routed bf16 gradient against ``jax.vjp`` of the JAX level's
  ``fused_sa_train(precision="default")`` in interpret mode, its products
  made the MXU's single bf16 pass, within the JAX package's bf16 tolerance
  2e-2 · max|ref| (``tests/test_torch_port_bf16_train.py``'s rule for the
  same comparison); a winner moved to another row fails both checks;
- ``FusedSALevel`` saves the bf16 forward's winner and hands it to the
  backward (the CUDA wrappers replaced by their plain twins on the CPU);
- the bf16 forward's weight packing (``pack_wgmma``): the documented
  index map gives back the padded bf16 weight bitwise; and the whole image
  it copies into shared memory (``pack_image``: the weights, then the
  vectors), the plain version of the card's packing kernel, which
  ``chip_smoke.py`` holds bitwise against it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from maskplanner_tpu_torch.ops import fused_sa
from maskplanner_tpu_torch.ops.cuda import fused_sa as cuda_sa
from maskplanner_tpu_torch.ops.fused_sa import (FusedSALevel, PlainBf16Level,
                                                fused_sa_backward_plain,
                                                fused_sa_forward_plain)

RADIUS = 0.35
FLAGSHIP_K = (32, 64)     # sa1's and sa2's nsample
JAX_K = 16
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bf16_values(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _case(norm, with_features, K, B=2, N=192, S=24, chans=(32, 48),
          sparse=True, seed=3):
    """A level's inputs and a cotangent. ``sparse``: every third query sits
    where its ball holds fewer than K points (some none), so its padding
    repeats the first neighbour."""
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    new_xyz = xyz[:, :S].copy()
    if sparse:
        new_xyz[:, ::3] += np.array([1.3, 0.0, 0.0], np.float32)
        new_xyz[:, ::7] += 50.0
    feats = None
    if with_features:
        feats = rng.normal(size=(B, N, 11)).astype(np.float32)
        # the JAX kernel's hi/lo gather of the first 5 channels agrees with
        # a single bf16 rounding on bf16 values
        feats[..., :5] = _bf16_values(feats[..., :5])
    ci = 3 + (0 if feats is None else feats.shape[-1])
    params = []
    for co in chans:
        layer = [(rng.normal(size=(co, ci)) * 0.3).astype(np.float32),
                 (rng.normal(size=(co,)) * 0.1).astype(np.float32)]
        if norm == "layer":
            layer += [(rng.normal(size=(co,)) * 0.2 + 1.0).astype(np.float32),
                      (rng.normal(size=(co,)) * 0.1).astype(np.float32)]
        params.append(tuple(layer))
        ci = co
    ct = rng.normal(size=(B, S, chans[-1])).astype(np.float32)
    return xyz, new_xyz, feats, tuple(params), ct


def _torch_case(*case):
    xyz, new_xyz, feats, params, ct = case
    return ([_t(xyz), _t(new_xyz), _t(feats)],
            [tuple(_t(a) for a in layer) for layer in params], _t(ct))


def _flat(d_xyz, d_new, d_feat, grads):
    return [t for t in (d_xyz, d_new, d_feat) if t is not None] + [
        g for layer in grads for g in layer]


LEVELS = pytest.mark.parametrize(
    "norm,with_features", [("layer", False), ("layer", True),
                           ("none", False), ("none", True)],
    ids=["layer-xyz", "layer-features", "none-xyz", "none-features"])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("K", FLAGSHIP_K)
def test_forward_winner_is_first_argmax(K, precision):
    """The winner is, for each (query, channel), the lowest k whose last
    activation equals the max (numpy's own scan over the activations);
    the padded balls make ties, which go to the first."""
    leaves, params, _ = _torch_case(*_case("layer", True, K))
    pooled, idx, winner = fused_sa_forward_plain(
        RADIUS, K, "layer", *leaves, params, precision, winner=True)
    ref_pooled, ref_idx = fused_sa_forward_plain(RADIUS, K, "layer", *leaves,
                                                 params, precision)
    assert torch.equal(pooled, ref_pooled) and torch.equal(idx, ref_idx)
    feats = leaves[2]
    if precision == "bf16":
        feats = fused_sa.bf16_round(feats)
    rows = fused_sa._gather_plain(leaves[0], leaves[1], feats, idx)
    act = fused_sa._mlp_plain(rows, params, "layer",
                              fused_sa.PRODUCTS[precision])[-1][3].numpy()
    B, S, _, C = act.shape
    want = np.empty((B, S, C), np.int64)
    ties = 0
    for b in range(B):
        for s in range(S):
            for c in range(C):
                col = act[b, s, :, c]
                hits = np.flatnonzero(col == col.max())
                want[b, s, c] = hits[0]
                ties += len(hits) > 1
    assert ties > 0, "the case has no tie to break"
    # a ball with fewer than K points repeats its first neighbour
    assert bool((idx[..., -1] == idx[..., 0]).any())
    np.testing.assert_array_equal(winner.numpy(), want)
    np.testing.assert_array_equal(
        np.take_along_axis(act, want[:, :, None, :], 2)[:, :, 0],
        pooled.numpy())


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@LEVELS
def test_backward_by_winner_is_equality_routing(norm, with_features,
                                               precision):
    """Routed by the forward's winner, the plain backward is bitwise the
    backward that finds the first winner by ``>=`` against pooled."""
    K = FLAGSHIP_K[0]
    leaves, params, ct = _torch_case(*_case(norm, with_features, K))
    pooled, idx, winner = fused_sa_forward_plain(
        RADIUS, K, norm, *leaves, params, precision, winner=True)
    args = (K, norm, *leaves, params, idx, pooled, ct)
    ref = _flat(*fused_sa_backward_plain(*args, splits=3,
                                         precision=precision))
    got = _flat(*fused_sa_backward_plain(*args, splits=3,
                                         precision=precision,
                                         winner=winner))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


# -- against the JAX level ----------------------------------------------------

@pytest.fixture
def mxu_default(monkeypatch):
    """The JAX level's Pallas kernels in interpret mode, its "default"
    products as the MXU makes them: one pass on operands rounded to bf16,
    float32 sums (patched here; the JAX package is unchanged)."""
    import maskplanner_tpu.ops.pallas.fused_sa_train as fst

    jax.clear_caches()
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    dot = fst._dot

    def single_pass(a, b, dims, prec):
        if prec == "default":
            a, b = a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
        return dot(a, b, dims, prec)

    monkeypatch.setattr(fst, "_dot", single_pass)
    yield
    jax.clear_caches()


def _jax_grads(norm, xyz, new_xyz, feats, params, ct):
    from maskplanner_tpu.ops.pallas import fused_sa_train as fst

    def loss(x, q, f, p):
        return jnp.sum(fst.fused_sa_train(RADIUS, JAX_K, norm, x, q, f, p,
                                          precision="default") * ct)

    args = (_j(xyz), _j(new_xyz), _j(feats),
            jax.tree_util.tree_map(jnp.asarray, params))
    argnums = (0, 1, 3) if feats is None else (0, 1, 2, 3)
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(
        jax.grad(loss, argnums)(*args))]


def _worst(got, ref):
    """The largest error of any gradient as a share of its max|ref|."""
    return max(float(np.abs(g.numpy() - r).max() / (np.abs(r).max() + 1e-9))
               for g, r in zip(got, ref))


def _winner_grads(norm, case, move: bool = False):
    leaves, params, ct = _torch_case(*case)
    pooled, idx, winner = fused_sa_forward_plain(
        RADIUS, JAX_K, norm, *leaves, params, "bf16", winner=True)
    if move:
        winner = (winner + 1) % JAX_K
    return _flat(*fused_sa_backward_plain(
        JAX_K, norm, *leaves, params, idx, pooled, ct, precision="bf16",
        winner=winner)), pooled


@LEVELS
def test_winner_routed_bf16_gradient_matches_jax(norm, with_features,
                                                 mxu_default):
    case = _case(norm, with_features, JAX_K)
    ref = _jax_grads(norm, *case)
    got, _ = _winner_grads(norm, case)
    assert len(got) == len(ref)
    for g in got:
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert _worst(got, ref) <= BF16_TOL


def test_moved_winner_fails(mxu_default):
    """The control: each winner moved to the next row routes the gradient
    elsewhere, which both checks above see."""
    case = _case("layer", True, JAX_K)
    leaves, params, ct = _torch_case(*case)
    got, pooled = _winner_grads("layer", case, move=True)
    _, idx = fused_sa_forward_plain(RADIUS, JAX_K, "layer", *leaves, params,
                                    "bf16")
    ref = _flat(*fused_sa_backward_plain(JAX_K, "layer", *leaves, params,
                                         idx, pooled, ct, precision="bf16"))
    assert not all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _worst(got, _jax_grads("layer", *case)) > BF16_TOL


def test_fused_level_saves_and_routes_by_winner(monkeypatch):
    """``FusedSALevel`` in bf16 asks the forward for its winner, saves it
    and routes the backward by it: with the CUDA wrappers replaced by their
    plain twins, its gradients are bitwise ``PlainBf16Level``'s."""
    K = FLAGSHIP_K[0]
    seen = {}

    def forward(radius, nsample, layer_norm, xyz, new_xyz, features, params,
                winner=False, image=False):
        out = fused_sa_forward_plain(radius, nsample,
                                     "layer" if layer_norm else "none", xyz,
                                     new_xyz, features, params, "bf16",
                                     winner=winner)
        seen["forward"] = out[-1] if winner else None
        if image:
            out = (*out, cuda_sa.pack_image(params, layer_norm))
        return out

    def backward(nsample, layer_norm, xyz, new_xyz, features, params, idx,
                 pooled, d_pooled, needs=(True, True, True), bf16=False,
                 winner=None, image=None):
        assert bf16 and winner is seen["forward"]
        seen["backward"] = winner
        return fused_sa_backward_plain(nsample,
                                       "layer" if layer_norm else "none",
                                       xyz, new_xyz, features, params, idx,
                                       pooled, d_pooled, needs,
                                       precision="bf16", winner=winner)

    monkeypatch.setattr(cuda_sa, "fused_sa_bf16_cuda", forward)
    monkeypatch.setattr(cuda_sa, "fused_sa_backward_cuda", backward)
    leaves, params, ct = _torch_case(*_case("layer", True, K))
    grads = []
    for level in (FusedSALevel, PlainBf16Level):
        xs = [t.clone().requires_grad_(True) for t in leaves]
        ps = [tuple(a.clone().requires_grad_(True) for a in layer)
              for layer in params]
        flat = [a for layer in ps for a in layer]
        head = (0.2, K, True, True) if level is FusedSALevel else \
            (0.2, K, "layer")
        pooled, _ = level.apply(*head, *xs, 4, *flat)
        grads.append(torch.autograd.grad((pooled * ct).sum(), xs + flat))
    assert seen["backward"] is not None
    assert seen["backward"].dtype == torch.int64
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(48, 3), (64, 131), (256, 128), (20, 8)])
def test_pack_wgmma_index_map(shape):
    """Element (o, i) of the padded weight lies at flat index
    ((i // 8) (np // 8) + o // 8) 64 + (o % 8) 8 + i % 8 of the packed
    one, as ``csrc/fused_sa_fwd_bf16.cu`` reads it; the padding is zero."""
    co, ci = shape
    w = torch.from_numpy(np.random.default_rng(co + ci).normal(
        size=shape).astype(np.float32))
    kp, np_ = cuda_sa.padded_widths([ci, co])
    kp, np_ = kp[0], np_[0]
    assert kp % 16 == 0 and np_ % cuda_sa.WIDTH_STEP == 0
    packed = cuda_sa.pack_wgmma(w, kp, np_)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (kp // 8, np_ // 8, 8, 8)
    flat = packed.reshape(-1).view(torch.int16).numpy()
    o, i = np.meshgrid(np.arange(np_), np.arange(kp), indexing="ij")
    at = ((i // 8) * (np_ // 8) + o // 8) * 64 + (o % 8) * 8 + i % 8
    padded = torch.zeros((np_, kp), dtype=torch.bfloat16)
    padded[:co, :ci] = w.to(torch.bfloat16)
    np.testing.assert_array_equal(flat[at],
                                  padded.view(torch.int16).numpy())
    unpacked = packed.permute(1, 2, 0, 3).reshape(np_, kp)
    assert torch.equal(unpacked.view(torch.int16), padded.view(torch.int16))


@pytest.mark.parametrize("layer_norm", [True, False], ids=["layer", "none"])
@pytest.mark.parametrize("chans", [(131, 128, 128, 256), (14, 32, 48)],
                         ids=["sa2", "narrow"])
def test_pack_image_layout(chans, layer_norm):
    """The image the forward copies into shared memory: each layer's packed
    weight at its offset (a multiple of 128 bytes, zeros between), then
    the vectors, f32, per layer the bias, gamma and beta (LayerNorm) each
    zero-padded to the layer's padded width."""
    rng = np.random.default_rng(sum(chans))
    params = []
    for ci, co in zip(chans[:-1], chans[1:]):
        n = 4 if layer_norm else 2
        params.append(tuple(torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)) for shape in [(co, ci)] + [(co,)] * (n - 1)))
    image = cuda_sa.pack_image(params, layer_norm)
    assert image.dtype == torch.uint8
    assert image.numel() == cuda_sa.image_bytes(list(chans), layer_norm)
    kp, np_ = cuda_sa.padded_widths(list(chans))
    offsets, at = cuda_sa.image_offsets(list(chans))
    ends = offsets[1:] + [at]
    for layer, k, n, off, end in zip(params, kp, np_, offsets, ends):
        assert off % 128 == 0
        w = cuda_sa.pack_wgmma(layer[0], k, n).reshape(-1).view(torch.uint8)
        assert torch.equal(image[off:off + w.numel()], w)
        assert not bool(image[off + w.numel():end].any())
    vec = image[at:].view(torch.float32)
    start = 0
    for layer, n in zip(params, np_):
        for a in layer[1:]:
            assert torch.equal(vec[start:start + a.numel()], a)
            assert not bool(vec[start + a.numel():start + n].any())
            start += n
    assert start == vec.numel()


def test_padded_widths_follow_the_kernel():
    """The flagship's levels: sa1 (3 -> 64 -> 64 -> 128) and sa2 (131 ->
    128 -> 128 -> 256), and a narrow level padded to the wgmma's steps."""
    assert cuda_sa.padded_widths([3, 64, 64, 128]) == ([16, 64, 64],
                                                       [64, 64, 128])
    assert cuda_sa.padded_widths([131, 128, 128, 256]) == ([144, 128, 128],
                                                           [128, 128, 256])
    assert cuda_sa.padded_widths([14, 32, 48]) == ([16, 64], [64, 64])
    assert cuda_sa.winner_dtype(64) == torch.uint8
    assert cuda_sa.winner_dtype(300) == torch.int32
