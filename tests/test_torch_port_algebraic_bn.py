"""The algebraic BatchNorm of the port (``MASKPLANNER_ALGEBRAIC_BN=1``:
``models.pointnet2.PointMLP.folded_bn_layer``) on the CPU.

- Against the JAX package's ``PointMLP._folded_bn_layer`` with the variable
  set on both sides, at ``tests/test_algebraic_bn.py``'s shapes (a (4, 16,
  8, 7) input, layers of 12 and 24, parameters moved off their init): the
  output's loss, every parameter and input gradient within 1e-5 of the
  gradients' norm plus 10x the port's own float32 error (the same step in
  float64), the running statistics within 1e-6 plus 10x that error; in
  bf16 the output within the bf16 rounding class.
- Against the port's default BatchNorm: in float64 the two paths agree to
  1e-12 of each tensor's norm (the same moments, another summation); in
  float32 within 10x the default path's own float32 error, as the
  E[x²] − E[x]² and the Gram forms round differently; the Dense biases'
  gradients are exactly 0 on the algebraic path (rounding on the other).
  Likewise one train-mode pass of a ``model.norm=batch`` model (every
  level's MLP on the algebraic path, nine layers) with a fixed cotangent,
  where float64 agrees to 1e-9 (nine normalised layers).
- The state dict is the default path's (checkpoints are interchangeable),
  it is off without the variable and in eval mode.
- Over 2 gloo ranks, each with half the rows, the mean and the Gram matrix
  are the global batch's: the outputs, gradients and statistics are the
  single process's at the global batch within 1e-12 (float64).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskplanner_tpu.models import pointnet2 as jax_pointnet2
from maskplanner_tpu_torch.models.pointnet2 import PointMLP
from test_torch_port_parallel import join, start

torch.set_num_threads(1)

ROUNDING_FACTOR = 10
WIDTHS = (12, 24)
ENV = "MASKPLANNER_ALGEBRAIC_BN"


@pytest.fixture
def algebraic(monkeypatch):
    monkeypatch.setenv(ENV, "1")


def _input(seed=0, shape=(4, 16, 8, 7)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * 2 + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def jax_mlp():
    """The JAX PointMLP, its parameters moved off their init and its
    statistics off 0/1 (as ``tests/test_algebraic_bn.py``)."""
    x = _input()
    mlp = jax_pointnet2.PointMLP(WIDTHS, dtype=jnp.float32, norm="batch")
    v = mlp.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    leaves, treedef = jax.tree_util.tree_flatten(v["params"])
    params = jax.tree_util.tree_unflatten(treedef, [
        leaf + 0.3 * jax.random.normal(k, leaf.shape, leaf.dtype)
        for leaf, k in zip(leaves, keys)])
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.2,
                                   v["batch_stats"])
    return params, stats


def _jax_step(params, stats, x, dtype=jnp.float32):
    """The JAX MLP's train-mode pass with the algebraic path, loss
    mean(out²) -> (loss, output, {name: gradient} by the port's names,
    {name: statistic})."""
    mlp = jax_pointnet2.PointMLP(WIDTHS, dtype=dtype, norm="batch")

    def loss(p, xx):
        out, mut = mlp.apply({"params": p, "batch_stats": stats}, xx,
                             train=True, mutable=["batch_stats"])
        out32 = out.astype(jnp.float32)
        return jnp.sum(out32 ** 2) / out.size, (out32, mut["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ENV, "1")
        (value, (out, new)), (g, gx) = jax.value_and_grad(
            loss, has_aux=True, argnums=(0, 1))(params, jnp.asarray(x))
    grads, moved = {"x": np.asarray(gx, np.float64)}, {}
    for j in range(len(WIDTHS)):
        dense, bn = g[f"Dense_{j}"], g[f"BatchNorm_{j}"]
        grads[f"mlp_convs.{j}.weight"] = np.asarray(dense["kernel"]).T
        grads[f"mlp_convs.{j}.bias"] = np.asarray(dense["bias"])
        grads[f"mlp_bns.{j}.weight"] = np.asarray(bn["scale"])
        grads[f"mlp_bns.{j}.bias"] = np.asarray(bn["bias"])
        for k, name in (("mean", "running_mean"), ("var", "running_var")):
            moved[f"mlp_bns.{j}.{name}"] = np.asarray(
                new[f"BatchNorm_{j}"][k], np.float64)
    return float(value), np.asarray(out, np.float64), grads, moved


def _port_mlp(params, stats, dtype=torch.float32):
    mlp = PointMLP(7, WIDTHS, "batch", dtype=dtype)
    sd = {}
    for j in range(len(WIDTHS)):
        dense, bn = params[f"Dense_{j}"], params[f"BatchNorm_{j}"]
        sd[f"mlp_convs.{j}.weight"] = np.asarray(dense["kernel"]).T
        sd[f"mlp_convs.{j}.bias"] = np.asarray(dense["bias"])
        sd[f"mlp_bns.{j}.weight"] = np.asarray(bn["scale"])
        sd[f"mlp_bns.{j}.bias"] = np.asarray(bn["bias"])
        sd[f"mlp_bns.{j}.running_mean"] = stats[f"BatchNorm_{j}"]["mean"]
        sd[f"mlp_bns.{j}.running_var"] = stats[f"BatchNorm_{j}"]["var"]
    state = mlp.state_dict()
    state.update({k: torch.tensor(np.array(v, np.float32))
                  for k, v in sd.items()})
    mlp.load_state_dict(state, strict=True)
    return mlp.train()


def _port_step(mlp, x, precision=torch.float32):
    """A train-mode pass of a copy of ``mlp`` in ``precision`` (its
    parameters'), loss mean(out²) -> (loss, output, {name: gradient},
    {name: statistic})."""
    mlp = copy.deepcopy(mlp).to(precision)
    xt = torch.from_numpy(x).to(precision).requires_grad_(True)
    out = mlp(xt).float() if mlp.dtype == torch.bfloat16 else mlp(xt)
    value = (out ** 2).sum() / out.numel()
    value.backward()
    grads = {n: p.grad.double().numpy() for n, p in mlp.named_parameters()}
    grads["x"] = xt.grad.double().numpy()
    moved = {n: b.double().numpy() for n, b in mlp.named_buffers()
             if "running" in n}
    return value.item(), out.detach().double().numpy(), grads, moved


def _rel(a, b, norm):
    return np.linalg.norm(a - b) / norm


def test_moments_and_gradients_match_jax(jax_mlp, algebraic):
    params, stats = jax_mlp
    x = _input()
    ref = _jax_step(params, stats, x)
    mlp = _port_mlp(params, stats)
    calls = []
    fold = PointMLP.folded_bn_layer

    def counted(self, *a):
        calls.append(a[0])
        return fold(self, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PointMLP, "folded_bn_layer", counted)
        got = _port_step(mlp, x)
    assert calls == [0, 1]
    exact = _port_step(mlp, x, torch.float64)
    own = abs(got[0] - exact[0])
    assert abs(got[0] - ref[0]) <= 1e-5 * abs(ref[0]) + ROUNDING_FACTOR * own
    norm = np.sqrt(sum((g ** 2).sum() for g in ref[2].values()))
    for k, want in ref[2].items():
        err = np.linalg.norm(got[2][k] - want)
        own = np.linalg.norm(got[2][k] - exact[2][k])
        assert err <= 1e-5 * norm + ROUNDING_FACTOR * own, (k, err, norm, own)
    for k, want in ref[3].items():
        own = np.abs(got[3][k] - exact[3][k]).max()
        np.testing.assert_allclose(got[3][k], want, rtol=0,
                                   atol=1e-6 + ROUNDING_FACTOR * own,
                                   err_msg=k)
    # the Dense biases cancel out of the normalised output (JAX's too)
    for j in range(len(WIDTHS)):
        assert not got[2][f"mlp_convs.{j}.bias"].any()
        assert not ref[2][f"mlp_convs.{j}.bias"].any()


def test_bf16_matches_jax_within_its_rounding(jax_mlp, algebraic):
    """bf16 products with f32 moments: the outputs within bf16's rounding
    class (as ``tests/test_algebraic_bn.py`` holds bf16 against f32)."""
    params, stats = jax_mlp
    x = _input(2)
    _, ref, _, _ = _jax_step(params, stats, x, jnp.bfloat16)
    _, got, grads, _ = _port_step(_port_mlp(params, stats, torch.bfloat16),
                                  x)
    assert np.isfinite(got).all() and all(np.isfinite(g).all()
                                          for g in grads.values())
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2 * np.abs(
        ref).max())


def _against_default(mlp, x):
    """The algebraic path against the default one, in float64 (1e-12 of
    each tensor's norm) and float32 (10x the default path's own float32
    error on the tensor)."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for on in (True, False):
            if on:
                mp.setenv(ENV, "1")
            else:
                mp.delenv(ENV, raising=False)
            for precision in (torch.float32, torch.float64):
                runs[on, precision] = _port_step(mlp, x, precision)
    a32, a64 = runs[True, torch.float32], runs[True, torch.float64]
    d32, d64 = runs[False, torch.float32], runs[False, torch.float64]
    for part in (1, 2, 3):
        tensors = ({"out": a64[1]} if part == 1 else a64[part])
        pick = ((lambda r, k: r[1]) if part == 1
                else (lambda r, k, p=part: r[p][k]))
        for k in tensors:
            n = np.linalg.norm(pick(d64, k))
            if k.startswith("mlp_convs") and k.endswith("bias"):
                # 0 in exact arithmetic: the default path's is rounding
                assert not pick(a64, k).any() and not pick(a32, k).any(), k
                continue
            assert _rel(pick(a64, k), pick(d64, k), n) <= 1e-12, k
            own = np.linalg.norm(pick(d32, k) - pick(d64, k))
            assert np.linalg.norm(pick(a32, k) - pick(d32, k)) <= \
                ROUNDING_FACTOR * own, k
    assert abs(a64[0] - d64[0]) <= 1e-12 * abs(d64[0])
    assert abs(a32[0] - d32[0]) <= ROUNDING_FACTOR * abs(d32[0] - d64[0]) \
        + 1e-7 * abs(d64[0])


def test_algebraic_path_is_the_default_batch_norm(jax_mlp):
    params, stats = jax_mlp
    _against_default(_port_mlp(params, stats), _input(1))


def test_model_train_pass_is_the_default_batch_norm(monkeypatch):
    """A ``model.norm=batch`` model (sa1, sa2 and sa3's MLPs, nine layers
    on the algebraic path), train mode with FPS from index 0 and no
    dropout, a fixed cotangent on its poses."""
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=["config=[maskplanner,windows_v2,longx_v2]",
                          "model.norm=batch", "pc_points=64",
                          "model.hidden_size=[32,32]",
                          "n_pred_traj_points=120", "max_n_strokes=6"])
    model = get_model(cfg, device="cpu", dropout=0.0,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, b in model.named_buffers():
            if "running_var" in n:
                b.uniform_(0.5, 1.5, generator=torch.Generator()
                           .manual_seed(1))
    rng = np.random.default_rng(3)
    pc = torch.from_numpy(rng.normal(size=(4, 64, 3)).astype(np.float32))

    def run(on, precision):
        if on:
            monkeypatch.setenv(ENV, "1")
        else:
            monkeypatch.delenv(ENV, raising=False)
        m = copy.deepcopy(model).to(precision).train()
        calls = []
        fold = PointMLP.folded_bn_layer
        monkeypatch.setattr(PointMLP, "folded_bn_layer",
                            lambda self, *a: calls.append(1)
                            or fold(self, *a))
        traj = m(pc.to(precision)).traj
        cot = torch.from_numpy(np.random.default_rng(4).normal(
            size=traj.shape)).to(precision)
        (traj * cot).sum().backward()
        monkeypatch.setattr(PointMLP, "folded_bn_layer", fold)
        assert len(calls) == (9 if on else 0)
        return ({n: p.grad.double() for n, p in m.named_parameters()
                 if p.grad is not None and n.startswith("sa")},
                {n: b.double() for n, b in m.named_buffers()
                 if n.startswith("sa") and "running" in n},
                traj.detach().double())

    runs = {(on, p): run(on, p) for on in (True, False)
            for p in (torch.float32, torch.float64)}
    for part in range(3):
        a32, a64 = runs[True, torch.float32][part], runs[
            True, torch.float64][part]
        d32, d64 = runs[False, torch.float32][part], runs[
            False, torch.float64][part]
        if part == 2:
            a32, a64, d32, d64 = ({"traj": t} for t in (a32, a64, d32, d64))
        assert a32.keys() == d32.keys() and len(a32) > 0
        for k in d64:
            n = float(d64[k].norm())
            if "mlp_convs" in k and k.endswith("bias"):
                # 0 in exact arithmetic: the default path's is rounding
                assert not a64[k].any() and not a32[k].any(), k
                continue
            # float64 through nine normalised layers: the Gram form's
            # cancellation (E[x²] against E[x]²) costs a few digits more
            assert float((a64[k] - d64[k]).norm()) <= 1e-9 * n, k
            own = float((d32[k] - d64[k]).norm())
            assert float((a32[k] - d32[k]).norm()) <= ROUNDING_FACTOR * own \
                + 1e-7 * n, (k, own)


def test_checkpoint_names_off_by_default_and_in_eval(jax_mlp, monkeypatch):
    params, stats = jax_mlp
    mlp = _port_mlp(params, stats)
    x = torch.from_numpy(_input())
    fold = PointMLP.folded_bn_layer

    def refused(self, *a):
        raise AssertionError("the algebraic path ran")

    monkeypatch.delenv(ENV, raising=False)
    monkeypatch.setattr(PointMLP, "folded_bn_layer", refused)
    default = copy.deepcopy(mlp)
    default(x)                      # off without the variable
    monkeypatch.setenv(ENV, "1")
    evaluated = copy.deepcopy(mlp).eval()
    evaluated(x)                    # eval mode: the running statistics
    monkeypatch.setattr(PointMLP, "folded_bn_layer", fold)
    algebraic = copy.deepcopy(mlp)
    algebraic(x)
    a, d = algebraic.state_dict(), default.state_dict()
    assert list(a) == list(d)
    for k in d:
        assert a[k].dtype == d[k].dtype and a[k].shape == d[k].shape
    assert int(a["mlp_bns.0.num_batches_tracked"]) == 1


# ---- over 2 gloo ranks -------------------------------------------------------

def _dp_mlp_worker(rank, world, state, x):
    import os

    from maskplanner_tpu_torch import parallel

    os.environ[ENV] = "1"
    mlp = PointMLP(7, WIDTHS, "batch").double().train()
    mlp.load_state_dict(state)
    rows = parallel.shard_rows(torch.from_numpy(x).double(), rank, world)
    rows.requires_grad_(True)
    with parallel.sharded_batch():
        out = mlp(rows)
        parallel.loss_share((out ** 2).mean()).backward()
        parallel.all_reduce_grads(mlp.parameters())
    return dict(out=out.detach(), x=rows.grad,
                grads={n: p.grad for n, p in mlp.named_parameters()},
                stats={n: b for n, b in mlp.named_buffers()})


def test_two_ranks_take_the_global_moments(jax_mlp, algebraic, tmp_path):
    params, stats = jax_mlp
    mlp = _port_mlp(params, stats)
    x = _input()
    handle = start(_dp_mlp_worker, 2, tmp_path,
                   {k: v.double() if v.is_floating_point() else v
                    for k, v in mlp.state_dict().items()}, x)
    single = copy.deepcopy(mlp).double()
    xt = torch.from_numpy(x).double().requires_grad_(True)
    out = single(xt)
    (out ** 2).mean().backward()
    ranks = join(handle)
    got = torch.cat([r["out"] for r in ranks])
    torch.testing.assert_close(got, out.detach(), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(torch.cat([r["x"] for r in ranks]), xt.grad,
                               rtol=1e-10, atol=1e-14)
    for r in ranks:
        for n, p in single.named_parameters():
            torch.testing.assert_close(r["grads"][n], p.grad, rtol=1e-10,
                                       atol=1e-14, msg=n)
        for n, b in single.named_buffers():
            torch.testing.assert_close(r["stats"][n], b, rtol=1e-12,
                                       atol=1e-12, msg=n)
    # the single process's grouped control: per-rank moments differ
    half = copy.deepcopy(mlp).double()
    half(torch.from_numpy(x[:2]).double())
    assert not torch.allclose(half.mlp_bns[0].running_mean,
                              single.mlp_bns[0].running_mean, rtol=1e-6)
