"""The fused set-abstraction backward's decomposition, on the CPU.

``ops.fused_sa.fused_sa_backward_plain`` follows the two backward kernels
(``csrc/fused_sa_bwd.cu``: recompute, first-winner routing, LayerNorm
backward, input gradients, the rows of the weight gradient;
``csrc/sa_weight_grad.cu``: the weight gradients as fixed-order split
sums). It is held against the JAX level's gradients (the Pallas kernels in
interpret mode, ``precision="highest"``) within 5e-4 · max|ref|, the JAX
package's own fused-vs-unfused tolerance, and against autograd through the
port's plain level. ``tf32_split`` states the tolerance of the kernels'
3xTF32 tensor-core products before any card run.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from maskplanner_tpu_torch.ops.fused_sa import (fused_sa_backward_plain,
                                                fused_sa_forward_plain,
                                                matmul_3xtf32, tf32_split)

torch.set_num_threads(1)

RADIUS, K = 0.35, 16


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _sa_case(norm, with_features, B=2, N=256, S=64, chans=(16, 24)):
    """As ``tests/test_torch_port_train_ops.py``: numpy inputs from a seed."""
    rng = np.random.default_rng(0)
    xyz = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    new_xyz = xyz[:, :S].copy()
    feats = (rng.normal(size=(B, N, 5)).astype(np.float32)
             if with_features else None)
    ci = 3 + (5 if with_features else 0)
    params = []
    for co in chans:
        layer = [(rng.normal(size=(co, ci)) * 0.3).astype(np.float32),
                 (rng.normal(size=(co,)) * 0.1).astype(np.float32)]
        if norm == "layer":
            layer += [(rng.normal(size=(co,)) * 0.2 + 1.0).astype(np.float32),
                      (rng.normal(size=(co,)) * 0.1).astype(np.float32)]
        params.append(tuple(layer))
        ci = co
    ct = np.random.default_rng(1).normal(size=(B, S, chans[-1])) \
        .astype(np.float32)
    return xyz, new_xyz, feats, tuple(params), ct


def _torch_case(norm, with_features, **kw):
    xyz, new_xyz, feats, params, ct = _sa_case(norm, with_features, **kw)
    leaves = [torch.from_numpy(xyz), torch.from_numpy(new_xyz),
              None if feats is None else torch.from_numpy(feats)]
    tparams = [tuple(torch.from_numpy(a) for a in l) for l in params]
    pooled, idx = fused_sa_forward_plain(RADIUS, K, norm, *leaves, tparams)
    return leaves, tparams, pooled, idx, torch.from_numpy(ct)


def _flat(d_xyz, d_new, d_feat, grads):
    return [t for t in (d_xyz, d_new, d_feat) if t is not None] + [
        g for layer in grads for g in layer]


@pytest.mark.parametrize("norm", ["layer", "none"])
@pytest.mark.parametrize("with_features", [False, True],
                         ids=["xyz", "features"])
def test_plain_backward_matches_jax(norm, with_features, interpret_mode):
    from maskplanner_tpu.ops.pallas.fused_sa_train import fused_sa_train

    xyz, new_xyz, feats, params, ct = _sa_case(norm, with_features)

    def jax_loss(xyz_, new_, feats_, params_):
        out = fused_sa_train(RADIUS, K, norm, xyz_, new_, feats_, params_,
                             precision="highest")
        return jnp.sum(out * ct)

    jargs = (jnp.asarray(xyz), jnp.asarray(new_xyz),
             None if feats is None else jnp.asarray(feats),
             jax.tree_util.tree_map(jnp.asarray, params))
    argnums = (0, 1, 3) if feats is None else (0, 1, 2, 3)
    ref = jax.tree_util.tree_leaves(jax.grad(jax_loss, argnums)(*jargs))

    leaves, tparams, pooled, idx, tct = _torch_case(norm, with_features)
    got = _flat(*fused_sa_backward_plain(K, norm, *leaves, tparams, idx,
                                         pooled, tct, splits=3))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=5e-4 * (np.abs(r).max() + 1e-9))


@pytest.mark.parametrize("norm", ["layer", "none"])
def test_plain_backward_matches_autograd(norm):
    """The decomposition against autograd through the same plain level:
    only the summation order differs (1e-5 · max|ref|)."""
    leaves, tparams, _, idx, ct = _torch_case(norm, True)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    tparams = [tuple(t.clone().requires_grad_(True) for t in l)
               for l in tparams]
    pooled, _ = fused_sa_forward_plain(RADIUS, K, norm, *leaves, tparams)
    flat = leaves + [t for l in tparams for t in l]
    ref = torch.autograd.grad((pooled * ct).sum(), flat)
    det = [t.detach() for t in leaves]
    dparams = [tuple(t.detach() for t in l) for l in tparams]
    got = _flat(*fused_sa_backward_plain(K, norm, *det, dparams, idx,
                                         pooled.detach(), ct))
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


def test_unasked_input_gradients_are_none():
    """With every needs-grad flag off the point and feature gradients are
    None, as autograd gives none for inputs that need no gradient, and the
    weight gradients are those of the full call, bit for bit."""
    leaves, tparams, pooled, idx, ct = _torch_case("layer", True)
    wparams = [tuple(t.clone().requires_grad_(True) for t in l)
               for l in tparams]
    out, _ = fused_sa_forward_plain(RADIUS, K, "layer", *leaves, wparams)
    (out * ct).sum().backward()
    assert all(t.grad is None for t in leaves)
    d_xyz, d_new, d_feat, grads = fused_sa_backward_plain(
        K, "layer", *leaves, tparams, idx, pooled, ct,
        needs=(False, False, False))
    assert (d_xyz, d_new, d_feat) == (None, None, None)
    full = fused_sa_backward_plain(K, "layer", *leaves, tparams, idx, pooled,
                                   ct)
    assert all(t is not None for t in full[:3])
    for layer, ref, w in zip(grads, full[3], wparams):
        for g, r, p in zip(layer, ref, w):
            assert torch.equal(g, r)
            assert float((g - p.grad).abs().max()) \
                <= 1e-5 * float(p.grad.abs().max())
    # one flag alone
    d_xyz, d_new, d_feat, _ = fused_sa_backward_plain(
        K, "layer", *leaves, tparams, idx, pooled, ct,
        needs=(False, False, True))
    assert d_xyz is None and d_new is None and torch.equal(d_feat, full[2])


def test_split_weight_gradients_are_fixed_order():
    """dW from 1 and from 7 row splits agree within float32 rounding, and
    two calls with the same splits give the same bits."""
    leaves, tparams, pooled, idx, ct = _torch_case("layer", True)
    args = (K, "layer", *leaves, tparams, idx, pooled, ct)
    one = fused_sa_backward_plain(*args, splits=1)[3]
    seven = fused_sa_backward_plain(*args, splits=7)[3]
    again = fused_sa_backward_plain(*args, splits=7)[3]
    rows = idx.numel()
    for a, b, c in zip(one, seven, again):
        for x, y, z in zip(a, b, c):
            assert torch.equal(y, z)
            # each of the `rows` additions rounds by at most an ulp
            tol = rows * 2.0 ** -24 * float(x.abs().max())
            assert float((x - y).abs().max()) <= tol


def test_tf32_split_parts():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=4096)
                         .astype(np.float32)) * 1e3
    hi, lo = tf32_split(x)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    # hi is the nearest TF32 value; hi + lo within 2^-22 relative of x
    assert float(((x - hi).abs() / x.abs()).max()) <= 2.0 ** -11
    rest = (x.double() - hi.double() - lo.double()).abs() / x.abs().double()
    assert float(rest.max()) <= 2.0 ** -21
    # ties round away from zero, as cvt.rna does
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32_split(tie)[0].tolist() == [1.0 + 2.0 ** -10,
                                           -(1.0 + 2.0 ** -10)]


def test_3xtf32_product_is_as_good_as_float32():
    """The tolerance of the kernels' tensor-core products: a 3xTF32 product
    at the flagship's widest layer (rows x 256 · 256 x 128) lies within 2x
    the float32 product's own error from float64 (rms and max)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.normal(size=(512, 256)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    exact = a.double() @ b.double()
    e3 = matmul_3xtf32(a, b).double() - exact
    e32 = (a @ b).double() - exact
    assert float(e3.norm()) <= 2.0 * float(e32.norm())
    assert float(e3.abs().max()) <= 2.0 * float(e32.abs().max())
    # one TF32 pass alone is far worse: the split is what makes it f32-grade
    hi_a, _ = tf32_split(a)
    hi_b, _ = tf32_split(b)
    e1 = (hi_a @ hi_b).double() - exact
    assert float(e1.norm()) > 20.0 * float(e32.norm())
