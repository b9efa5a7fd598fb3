"""The fused set-abstraction forward's tensor-core arithmetic, on the CPU.

The forward kernel (``csrc/fused_sa_fwd.cu``) and the backward's
recompute (``csrc/fused_sa_bwd.cu``) form every layer product as one
3xTF32 tensor-core product on weights zero-padded to the mma's 8
channels. ``ops.fused_sa.matmul_3xtf32`` emulates that product; these
tests state its tolerance before any card run:

- the plain level with the emulated product against the JAX level (the
  Pallas kernel in interpret mode) at ``tests/test_torch_port_ops.py``'s
  tolerance, 2e-5 · max|ref|;
- at the flagship widths (the seeded model, 2 clouds, both levels)
  against float64, within 2x the float32 level's own error;
- zero-padding sa1's 3 input channels to 8 changes nothing.

Inputs are made with numpy from a seed.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from maskplanner_tpu_torch.ops.cuda.fused_sa import padded_transpose
from maskplanner_tpu_torch.ops.fused_sa import (_gather_plain, _mlp_plain,
                                                matmul_3xtf32)
from maskplanner_tpu_torch.ops.sampling import (ball_query_plain,
                                                farthest_point_sample,
                                                index_points)

torch.set_num_threads(1)

RADIUS, K = 0.35, 16
FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _sa_case(norm, with_features, B=2, N=256, S=64, chans=(16, 24)):
    rng = np.random.default_rng(0)
    xyz = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    new_xyz = xyz[:, :S].copy()
    new_xyz[:, ::7] += 50.0            # some balls empty
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
    return xyz, new_xyz, feats, tuple(params)


def _level(radius, nsample, norm, xyz, new_xyz, feats, params,
           product=torch.matmul, idx=None):
    """The plain level with the given product -> (pooled, idx)."""
    if idx is None:
        idx = ball_query_plain(radius, nsample, xyz, new_xyz)
    rows = _gather_plain(xyz, new_xyz, feats, idx)
    return _mlp_plain(rows, params, norm, product)[-1][3].amax(dim=2), idx


@pytest.mark.parametrize("norm", ["layer", "none"])
@pytest.mark.parametrize("with_features", [False, True],
                         ids=["xyz", "features"])
def test_emulated_forward_matches_jax(norm, with_features, interpret_mode):
    from maskplanner_tpu.ops.pallas.fused_sa_train import (_fsa_train_fwd_raw,
                                                           _pack_xt)

    xyz, new_xyz, feats, params = _sa_case(norm, with_features)
    jf = None if feats is None else jnp.asarray(feats)
    out, idx = _fsa_train_fwd_raw(
        RADIUS, K, norm, _pack_xt(jnp.asarray(xyz), jf),
        jnp.swapaxes(jnp.asarray(new_xyz), 1, 2),
        tuple(tuple(jnp.asarray(a) for a in layer) for layer in params))
    ref = np.swapaxes(np.asarray(out), 1, 2)
    ref_idx = np.swapaxes(np.asarray(idx)[:, :K, :out.shape[-1]], 1,
                          2).astype(np.int32)

    t = torch.from_numpy
    pooled, got_idx = _level(
        RADIUS, K, norm, t(xyz), t(new_xyz), None if feats is None
        else t(feats), [tuple(t(a) for a in layer) for layer in params],
        matmul_3xtf32)
    np.testing.assert_array_equal(got_idx.numpy(), ref_idx)
    # the Pallas kernel's own tolerance against its unfused reference (it
    # gathers through a hi/lo bf16 one-hot split)
    np.testing.assert_allclose(pooled.numpy(), ref,
                               atol=2e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def flagship_levels():
    """The seeded flagship model's sa1 and sa2 on 2 clouds of the
    synthetic windows-v2 train split: per level (its module, xyz, new_xyz,
    features), sa2's inputs from the float32 sa1."""
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=[FLAGSHIP])
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    ds = PaintDataset(cfg, split="train", size=2)
    pts = torch.from_numpy(np.stack([ds[i]["point_cloud"] for i in range(2)]))
    levels = {}
    feats = None
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        new_xyz = index_points(pts, farthest_point_sample(pts, sa.npoint))
        levels[name] = (sa, pts, new_xyz, feats)
        with torch.no_grad():
            feats, _ = _level(sa.radius, sa.nsample, "layer", pts, new_xyz,
                              feats, sa.layer_params())
        pts = new_xyz
    return levels


@pytest.mark.parametrize("level", ["sa1", "sa2"])
def test_emulated_forward_against_float64(flagship_levels, level):
    """The 3xTF32 level lies within 2x the float32 level's own error from
    float64 (max over the pooled output, relative to max|ref|), on the same
    neighbours."""
    sa, xyz, new_xyz, feats = flagship_levels[level]
    params = [tuple(t.detach() for t in layer) for layer in sa.layer_params()]
    args = (sa.radius, sa.nsample, "layer")
    with torch.no_grad():
        p32, idx = _level(*args, xyz, new_xyz, feats, params)
        p3, _ = _level(*args, xyz, new_xyz, feats, params, matmul_3xtf32, idx)
        p64, _ = _level(*args, xyz.double(), new_xyz.double(),
                        None if feats is None else feats.double(),
                        [tuple(t.double() for t in layer) for layer in params],
                        idx=idx)
    scale = float(p64.abs().max())
    e32 = float((p32.double() - p64).abs().max()) / scale
    e3 = float((p3.double() - p64).abs().max()) / scale
    assert e3 <= 2.0 * e32, (e3, e32)
    assert e3 < 1e-5


def test_padding_changes_nothing(flagship_levels):
    """sa1's rows [x - q] (3 channels) zero-padded to the mma's 8, times the
    padded transposed weight (``padded_transpose``, the kernels' layout),
    give the same bits as the unpadded product."""
    sa, xyz, new_xyz, _ = flagship_levels["sa1"]
    w = sa.layer_params()[0][0].detach()
    assert tuple(w.shape) == (64, 3)
    wt = padded_transpose(w)
    assert tuple(wt.shape) == (8, 64)
    assert not bool(wt[3:].any())
    idx = ball_query_plain(sa.radius, sa.nsample, xyz, new_xyz)
    rows = _gather_plain(xyz, new_xyz, None, idx).reshape(-1, 3)
    padded = torch.nn.functional.pad(rows, (0, 5))
    for product in (torch.matmul, matmul_3xtf32):
        assert torch.equal(product(padded, wt), product(rows, w.t()))
