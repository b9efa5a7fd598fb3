"""The PyTorch port's training-step ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through both packages:
``nn_argmin`` (indices identical), the v6 chamfer flags (values within 1e-5
relative, gradients within 1e-5 · max|ref|), the batched Hungarian match
and the plain JV solver (total cost within 1e-5 relative of JAX and of
scipy), and the fused set-abstraction level with its gradient (within
5e-4 · max|ref|, the JAX package's own fused-vs-unfused tolerance). The
JAX Pallas kernels run in interpret mode; the JAX distances take their
fixed-order form, which the port uses. The kernel-vs-plain cases need a
CUDA card and skip here.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.optimize
import torch
from jax.experimental import pallas as pl

from maskplanner_tpu_torch.ops.chamfer import chamfer_distance
from maskplanner_tpu_torch.ops.cuda.lap import lap_cuda
from maskplanner_tpu_torch.ops.cuda.nn_argmin import nn_argmin_cuda
from maskplanner_tpu_torch.ops.fused_sa import fused_sa_forward
from maskplanner_tpu_torch.ops.hungarian import hungarian, lap, lap_plain
from maskplanner_tpu_torch.ops.nn_argmin import nn_argmin, nn_argmin_plain

torch.set_num_threads(1)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", interp)


@pytest.fixture
def fixed_order_distances(monkeypatch):
    monkeypatch.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nn_case(name):
    rng = np.random.default_rng(7)
    shapes = {"unmasked": (2, 130, 77, 24), "masked": (2, 130, 77, 24),
              "all_invalid_row": (2, 40, 33, 6), "odd_sizes": (3, 9, 5, 5)}
    B, P1, P2, D = shapes[name]
    x = rng.normal(size=(B, P1, D)).astype(np.float32)
    y = rng.normal(size=(B, P2, D)).astype(np.float32)
    mask = None
    if name != "unmasked":
        mask = rng.random((B, P2)) > 0.4
        if name == "all_invalid_row":
            mask[1] = False
    return x, y, mask


NN_CASES = ["unmasked", "masked", "all_invalid_row", "odd_sizes"]


class TestNnArgmin:
    @pytest.mark.parametrize("name", NN_CASES)
    def test_matches_pallas_interpret(self, name, interpret_mode):
        from maskplanner_tpu.ops.pallas.nn_argmin import nn_argmin_pallas

        x, y, mask = _nn_case(name)
        ref = nn_argmin_pallas(jnp.asarray(x), jnp.asarray(y),
                               None if mask is None else jnp.asarray(mask))
        got = nn_argmin(torch.from_numpy(x), torch.from_numpy(y),
                        None if mask is None else torch.from_numpy(mask))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("name", NN_CASES)
    def test_matches_xla_masked_argmin(self, name, fixed_order_distances):
        from maskplanner_tpu.ops.chamfer import _masked_min
        from maskplanner_tpu.ops.distance import square_distance

        x, y, mask = _nn_case(name)
        _, ref = _masked_min(square_distance(jnp.asarray(x), jnp.asarray(y)),
                             None if mask is None else jnp.asarray(mask))
        got = nn_argmin_plain(torch.from_numpy(x), torch.from_numpy(y),
                              None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    def test_ties_go_to_the_lowest_index(self):
        y = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]]])
        x = torch.tensor([[[0.5, 0.5], [1.0, 0.0]]])
        assert nn_argmin(x, y).tolist() == [[0, 0]]
        mask = torch.tensor([[False, True, True]])
        assert nn_argmin(x, y, mask).tolist() == [[1, 2]]


def _chamfer_case():
    rng = np.random.default_rng(11)
    y_pred = (rng.normal(size=(2, 30, 24)) * 0.5).astype(np.float32)
    y = (rng.normal(size=(2, 26, 24)) * 0.5).astype(np.float32)
    y[0, 20:] = -100.0                       # padded GT segments
    y_mask = np.ones((2, 26), bool)
    y_mask[0, 20:] = False
    pc = (rng.normal(size=(2, 50, 6)) * 0.5).astype(np.float32)
    pc[1, 41:] = -100.0
    pc_mask = np.ones((2, 50), bool)
    pc_mask[1, 41:] = False
    return y_pred, y, y_mask, pc, pc_mask


# the three chamfer calls of the v6 loss, plus the symmetric default
CHAMFER_CALLS = {
    "forward_segments": lambda cd, yp, y, ym, pc, pm, B: cd(
        yp, y, padded=True, y_mask=ym, asymmetric=True, return_matching=True,
        point_reduction=None, batch_reduction=None),
    "reverse_segments": lambda cd, yp, y, ym, pc, pm, B: cd(
        yp, y, padded=True, y_mask=ym, reverse_asymmetric=True),
    "reverse_points": lambda cd, yp, y, ym, pc, pm, B: cd(
        yp.reshape(B, -1, 6), pc, padded=True, y_mask=pm,
        reverse_asymmetric=True),
    "symmetric": lambda cd, yp, y, ym, pc, pm, B: cd(yp, y, padded=True),
}


@pytest.mark.parametrize("call", sorted(CHAMFER_CALLS))
def test_chamfer_matches_jax(call, fixed_order_distances):
    from maskplanner_tpu.ops.chamfer import chamfer_distance as jax_cd

    yp, y, ym, pc, pm = _chamfer_case()
    fn = CHAMFER_CALLS[call]
    rng = np.random.default_rng(3)

    def jax_value(yp_, y_):
        out = fn(jax_cd, yp_, y_, jnp.asarray(ym), jnp.asarray(pc),
                 jnp.asarray(pm), 2)
        return out

    ref = jax_value(jnp.asarray(yp), jnp.asarray(y))
    tp = torch.from_numpy(yp).requires_grad_(True)
    ty = torch.from_numpy(y).requires_grad_(True)
    got = fn(chamfer_distance, tp, ty, torch.from_numpy(ym),
             torch.from_numpy(pc), torch.from_numpy(pm), 2)
    assert len(got) == len(ref)
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-7)
    for g, r in zip(got[2:], ref[2:]):          # the matching indices
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))

    ct = rng.normal(size=np.shape(ref[0])).astype(np.float32)

    def jax_loss(yp_, y_):
        return jnp.sum(jax_value(yp_, y_)[0] * ct)

    ref_g = jax.grad(jax_loss, (0, 1))(jnp.asarray(yp), jnp.asarray(y))
    (got[0] * torch.from_numpy(ct)).sum().backward()
    for t, b in zip((tp, ty), ref_g):
        b = np.asarray(b)
        a = torch.zeros_like(t) if t.grad is None else t.grad  # unused input
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=1e-5 * (np.abs(b).max() + 1e-12))


def test_chamfer_unported_flags_raise():
    x = torch.zeros(1, 4, 6)
    for flag in ("velocities", "min_centroids",
                 "avoid_in_sequence_collapsing"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            chamfer_distance(x, x, **{flag: True})


def _cost_case():
    rng = np.random.default_rng(5)
    cost = rng.normal(size=(6, 9, 9)).astype(np.float32)
    cost[0] = np.round(cost[0])                      # many exact ties
    col_mask = rng.random((6, 9)) > 0.3
    col_mask[2] = True
    col_mask[3, :] = False
    col_mask[3, 4] = True
    return cost, col_mask


def _assignment_cost(cost, row4col, matched):
    c = np.take_along_axis(np.swapaxes(cost, -1, -2), row4col[..., None],
                           axis=-1)[..., 0]
    return np.where(matched, c, 0.0).sum(-1)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_hungarian_matches_jax_and_scipy(masked):
    from maskplanner_tpu.ops.hungarian import hungarian_cost

    cost, col_mask = _cost_case()
    mask = col_mask if masked else None
    row4col, matched = hungarian(torch.from_numpy(cost),
                                 None if mask is None
                                 else torch.from_numpy(mask))
    got = _assignment_cost(cost, row4col.numpy(), matched.numpy())
    ref = np.asarray(hungarian_cost(jnp.asarray(cost), None if mask is None
                                    else jnp.asarray(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    for b in range(cost.shape[0]):
        cols = np.arange(9) if mask is None else np.flatnonzero(mask[b])
        r, c = scipy.optimize.linear_sum_assignment(cost[b][:, cols])
        np.testing.assert_allclose(got[b], cost[b][:, cols][r, c].sum(),
                                   rtol=1e-5, atol=1e-5)
        # every real column gets its own row
        assert len(set(row4col[b].numpy()[cols].tolist())) == len(cols)


def test_hungarian_rectangular():
    rng = np.random.default_rng(2)
    cost = rng.normal(size=(3, 7, 4)).astype(np.float32)
    row4col, matched = hungarian(torch.from_numpy(cost))
    got = _assignment_cost(cost, row4col.numpy(), matched.numpy())
    for b in range(3):
        r, c = scipy.optimize.linear_sum_assignment(cost[b])
        np.testing.assert_allclose(got[b], cost[b][r, c].sum(), rtol=1e-5)


@pytest.mark.parametrize("n", [1, 6, 22])
def test_plain_lap_matches_pallas_interpret(n):
    from maskplanner_tpu.ops.pallas.lap import lap_jv_pallas

    rng = np.random.default_rng(n)
    cost = rng.normal(size=(5, n, n)).astype(np.float32)
    cost[1] = np.round(cost[1])
    got = lap_plain(torch.from_numpy(cost)).numpy()
    ref = np.asarray(lap_jv_pallas(jnp.asarray(cost), interpret=True))
    rows = np.arange(n)
    for b in range(5):
        assert sorted(got[b].tolist()) == list(range(n))
        np.testing.assert_allclose(cost[b][rows, got[b]].sum(),
                                   cost[b][rows, ref[b]].sum(), rtol=1e-5,
                                   atol=1e-5)


def _sa_case(norm, with_features, B=2, N=256, S=64, chans=(16, 24)):
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
    return xyz, new_xyz, feats, tuple(params)


@pytest.mark.parametrize("norm", ["layer", "none"])
@pytest.mark.parametrize("with_features", [False, True],
                         ids=["xyz", "features"])
def test_fused_level_gradients_match_jax(norm, with_features,
                                         interpret_mode):
    """Values and every gradient (d_xyz, d_new_xyz, d_features, d_params)
    of the level, as tests/test_fused_sa_train.py holds the JAX kernel."""
    from maskplanner_tpu.ops.pallas.fused_sa_train import fused_sa_train

    radius, K = 0.35, 16
    xyz, new_xyz, feats, params = _sa_case(norm, with_features)
    ct = np.random.default_rng(1).normal(size=(2, 64, 24)).astype(np.float32)

    def jax_loss(xyz_, new_, feats_, params_):
        out = fused_sa_train(radius, K, norm, xyz_, new_, feats_, params_,
                             precision="highest")
        return jnp.sum(out * ct), out

    jargs = (jnp.asarray(xyz), jnp.asarray(new_xyz),
             None if feats is None else jnp.asarray(feats),
             jax.tree_util.tree_map(jnp.asarray, params))
    argnums = (0, 1, 3) if feats is None else (0, 1, 2, 3)
    (_, ref_out), ref_g = jax.value_and_grad(jax_loss, argnums,
                                             has_aux=True)(*jargs)

    t = [torch.from_numpy(xyz).requires_grad_(True),
         torch.from_numpy(new_xyz).requires_grad_(True),
         None if feats is None else torch.from_numpy(feats).requires_grad_(True)]
    tparams = tuple(tuple(torch.from_numpy(a).requires_grad_(True) for a in l)
                    for l in params)
    pooled, _ = fused_sa_forward(radius, K, norm, *t, tparams)
    scale = float(np.abs(np.asarray(ref_out)).max())
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(ref_out),
                               atol=5e-4 * scale)
    (pooled * torch.from_numpy(ct)).sum().backward()
    leaves = [a for a in t if a is not None] + [a for l in tparams for a in l]
    for got, ref in zip(leaves, jax.tree_util.tree_leaves(ref_g)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref,
                                   atol=5e-4 * (np.abs(ref).max() + 1e-9))


def test_cpu_tensors_never_count_a_launch():
    from maskplanner_tpu_torch.ops.cuda.fused_sa import (fused_sa_bwd_cuda,
                                                         sa_weight_grad_cuda)

    before = (nn_argmin_cuda.launches, lap_cuda.launches,
              fused_sa_bwd_cuda.launches, sa_weight_grad_cuda.launches)
    x = torch.randn(1, 5, 3)
    nn_argmin(x, x)
    lap(torch.randn(2, 3, 3))
    xyz, new_xyz, feats, params = _sa_case("layer", True)
    w = torch.from_numpy(params[0][0]).requires_grad_(True)
    tp = ((w,) + tuple(torch.from_numpy(a) for a in params[0][1:]),
          tuple(torch.from_numpy(a) for a in params[1]))
    pooled, _ = fused_sa_forward(0.35, 8, "layer", torch.from_numpy(xyz),
                                 torch.from_numpy(new_xyz),
                                 torch.from_numpy(feats), tp)
    pooled.sum().backward()
    assert w.grad is not None
    assert (nn_argmin_cuda.launches, lap_cuda.launches,
            fused_sa_bwd_cuda.launches,
            sa_weight_grad_cuda.launches) == before


@pytest.mark.cuda
class TestKernelsOnCard:
    """Kernel vs plain version on the card, as chip_smoke.py's checks."""

    def test_nn_argmin_kernel_matches_plain(self, cuda_device):
        for name in NN_CASES:
            x, y, mask = (None if a is None else torch.from_numpy(a)
                          .to(cuda_device) for a in _nn_case(name))
            before = nn_argmin_cuda.launches
            got = nn_argmin(x, y, mask)
            assert nn_argmin_cuda.launches == before + 1
            assert torch.equal(got, nn_argmin_plain(x, y, mask))

    def test_lap_kernel_matches_plain(self, cuda_device):
        cost = torch.from_numpy(_cost_case()[0]).to(cuda_device)
        got, ref = lap(cost), lap_plain(cost)
        rows = torch.arange(9, device=cuda_device)
        for b in range(cost.shape[0]):
            assert sorted(got[b].tolist()) == list(range(9))
            assert torch.allclose(cost[b][rows, got[b].long()].sum(),
                                  cost[b][rows, ref[b].long()].sum(),
                                  rtol=1e-5)

    @pytest.mark.parametrize("norm", ["layer", "none"])
    def test_fused_level_backward_matches_plain(self, cuda_device, norm):
        from maskplanner_tpu_torch.ops.fused_sa import fused_sa_forward_plain

        xyz, new_xyz, feats, params = _sa_case(norm, True)
        leaves = [torch.from_numpy(a).to(cuda_device).requires_grad_(True)
                  for a in (xyz, new_xyz, feats)]
        tparams = tuple(tuple(torch.from_numpy(a).to(cuda_device)
                              .requires_grad_(True) for a in l)
                        for l in params)
        flat = leaves + [a for l in tparams for a in l]
        got, _ = fused_sa_forward(0.35, 16, norm, *leaves, tparams)
        ref, _ = fused_sa_forward_plain(0.35, 16, norm, *leaves, tparams)
        ct = torch.randn_like(ref)
        g = torch.autograd.grad((got * ct).sum(), flat)
        r = torch.autograd.grad((ref * ct).sum(), flat)
        for a, b in zip(g, r):
            assert float((a - b).abs().max()) <= 5e-4 * float(b.abs().max())

    @pytest.mark.parametrize("norm", ["layer", "none"])
    def test_backward_kernels_match_their_plain_version(self, cuda_device,
                                                        norm):
        """K1 with each input flag and K2 against the decomposition's plain
        version; K2's sums the same bits on a second launch."""
        from maskplanner_tpu_torch.ops.cuda.fused_sa import (
            fused_sa_bwd_cuda, sa_weight_grad_cuda)
        from maskplanner_tpu_torch.ops.fused_sa import (
            fused_sa_backward_plain, fused_sa_forward_plain)

        xyz, new_xyz, feats, params = _sa_case(norm, True)
        leaves = [torch.from_numpy(a).to(cuda_device)
                  for a in (xyz, new_xyz, feats)]
        tparams = [tuple(torch.from_numpy(a).to(cuda_device) for a in l)
                   for l in params]
        pooled, idx = fused_sa_forward_plain(0.35, 16, norm, *leaves,
                                             tparams)
        ct = torch.randn_like(pooled)
        args = (16, norm == "layer", *leaves, tparams, idx, pooled, ct)
        for needs in ((True, True, True), (False, False, True),
                      (False, False, False)):
            ref = fused_sa_backward_plain(16, norm, *leaves, tparams, idx,
                                          pooled, ct, needs=needs)
            before = (fused_sa_bwd_cuda.launches,
                      sa_weight_grad_cuda.launches)
            *got, scratch, vec, chans = fused_sa_bwd_cuda(*args, needs)
            grads = sa_weight_grad_cuda(scratch, vec, chans,
                                        norm == "layer", idx.numel())
            again = sa_weight_grad_cuda(scratch, vec, chans,
                                        norm == "layer", idx.numel())
            assert (fused_sa_bwd_cuda.launches,
                    sa_weight_grad_cuda.launches) == (before[0] + 1,
                                                      before[1] + 2)
            for a, b in zip(got, ref[:3]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert float((a - b).abs().max()) \
                        <= 5e-4 * float(b.abs().max())
            for layer, rlayer, layer2 in zip(grads, ref[3], again):
                for a, b, c in zip(layer, rlayer, layer2):
                    assert torch.equal(a, c)
                    assert float((a - b).abs().max()) \
                        <= 5e-4 * float(b.abs().max())
