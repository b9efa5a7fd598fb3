"""The port's data-parallel training step (``maskplanner_tpu_torch/parallel``)
on the CPU: 2 gloo ranks, each a process spawned with a ``file://`` store
under the test's ``tmp_path``, each holding 2 of the 4 clouds of a global
batch.

The JAX step is one program over the global batch. The DP step must be it:
held against the eager JAX step at 4 clouds by
``tests/test_torch_port_train.py::test_one_train_step_matches_jax``'s rule
(the loss, every gradient after the all-reduce, the BatchNorm statistics,
each within a fixed tolerance plus ROUNDING_FACTOR times the DP step's own
float32 error against the same DP step in float64), and against the
port's single-process step at 4 clouds by the same rule, with random FPS
starts and dropout drawn from one seeded generator. Three controls, each
one piece of the design undone (per-rank BatchNorm statistics, a per-rank
``total_matched``, per-rank draws), must fail that comparison. After 3
Adam steps both ranks' parameters are bitwise equal; a group of one
process is bitwise the ungrouped step; the device-resident epoch over 2
ranks is the single process's; the host loader's shards are the JAX
package's, item for item.
"""
import multiprocessing
import os
import traceback
from unittest import mock

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
SMALL = [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]",
         "n_pred_traj_points=120", "max_n_strokes=6", "batch_size=4"]
GLOBAL_BATCH = 4
WORLD = 2
# test_torch_port_train.py's factors: the allowance for float32 rounding is
# this many times the step's own float32 error on each tensor, plus this
# many times the JAX step's own, sampled by the same step on the batch in
# reverse order
ROUNDING_FACTOR = 10
JAX_ROUNDING_FACTOR = 3
SPAWN_TIMEOUT = 180
DRAW_SEED = 5
# the PointNet regressor at a global batch of 2: one row a rank, where the
# regressor's batch-1 bypass of its BatchNorms must see the global batch
POINTNET = ["config=[pointWise,cuboids_v2,longx_v2,debug]", "pc_points=64",
            "n_pred_traj_points=80", "batch_size=2", "loss=[chamfer]",
            "model.backbone=pointnet", "extra_data=[]"]
POINTNET_BATCH = 2


# ---- spawning ranks ---------------------------------------------------------

def _rank_main(fn, rank, world, store, out, args):
    torch.set_num_threads(1)
    from maskplanner_tpu_torch import parallel

    try:
        if store is not None:
            parallel.distributed_init(f"file://{store}", rank, world)
        try:
            result = fn(rank, world, *args)
            torch.save(result, os.path.join(out, f"rank{rank}.pt"))
        finally:
            parallel.destroy()
    except BaseException:
        # for the parent's failure message
        with open(os.path.join(out, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def start(fn, world, tmp_path, *args, group=True):
    """Start ``fn(rank, world, *args)`` in ``world`` spawned processes
    joined in a gloo group (``group=False``: no group, the processes
    ungrouped) -> a handle for :func:`join`; the caller may work
    meanwhile."""
    out = tmp_path / f"ranks{world}-{fn.__name__}"
    out.mkdir()
    ctx = multiprocessing.get_context("spawn")
    store = str(out / "store") if group else None
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, store, str(out), args))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, out


def join(handle, timeout=SPAWN_TIMEOUT):
    """Each rank's return value. A rank that fails or outlives ``timeout``
    fails the test; every process is ended."""
    procs, out = handle
    try:
        for p in procs:
            p.join(timeout)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    assert not hung, f"{len(hung)} rank(s) outlived {timeout} s"
    errors = "".join(f.read_text() for f in sorted(out.glob("rank*.err")))
    assert [p.exitcode for p in procs] == [0] * len(procs), errors
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


# ---- the step ---------------------------------------------------------------

def _active_weights(config):
    from maskplanner_tpu_torch.train import apply_delayed_activations

    return apply_delayed_activations(config, dict(), 10 ** 6)


def port_step(state, batch, dtype, seed=None, steps=1, lr=0.0,
              argv=SMALL):
    """``steps`` port train steps on ``batch`` (this process's rows) in
    ``dtype`` from ``state`` -> loss of the last step, gradients and
    BatchNorm statistics after it, the parameters, and the matched count
    of the stroke-mask loss. ``seed``: the generator of the FPS starts and
    the dropout masks (rate 0.3); None: FPS from index 0, no dropout."""
    from maskplanner_tpu_torch.losses import LossHandler, mask_losses
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import train_step
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=argv)
    model = get_model(cfg, device="cpu",
                      dropout=0.0 if seed is None else 0.3)
    model.load_state_dict(state, strict=True)
    model.to(dtype)
    handler = LossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(_active_weights(cfg))
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in batch.items()}
    generator = (None if seed is None
                 else torch.Generator().manual_seed(seed))
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    counts = []
    count = mask_losses.batch_count

    def record(c, m):
        counts.append(int(c))
        return count(c, m)

    with mock.patch.object(mask_losses, "batch_count", record):
        for _ in range(steps):
            loss, _ = train_step(model, optimizer, handler, b, weights,
                                 generator)
    # a parameter that the step did not reach (a bypassed BatchNorm) has
    # a zero gradient
    return dict(loss=float(loss),
                grads={n: torch.zeros_like(p, dtype=torch.float64)
                       if p.grad is None else p.grad.double().clone()
                       for n, p in model.named_parameters()},
                stats={n: t.double().clone()
                       for n, t in model.state_dict().items()
                       if "running_" in n},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
                matched=counts[-1] if counts else None)


def _step_worker(rank, world, inputs):
    """Every DP case of this file on one rank."""
    from maskplanner_tpu_torch import parallel
    from maskplanner_tpu_torch.losses import mask_losses
    from maskplanner_tpu_torch.models import pointnet, pointnet2

    data = torch.load(inputs, weights_only=False)
    state = data["state"]
    local, pn_local = ({k: parallel.shard_rows(v, rank, world)
                        for k, v in data[key].items()}
                       for key in ("batch", "pn_batch"))
    out = dict(f32=port_step(state, local, torch.float32),
               f64=port_step(state, local, torch.float64),
               drawn=port_step(state, local, torch.float32, DRAW_SEED))
    with mock.patch.object(pointnet2, "mean_over_ranks", lambda *t: t):
        out["local_bn"] = port_step(state, local, torch.float32)
    with mock.patch.object(mask_losses, "batch_count",
                           lambda c, m: torch.clamp(c, min=m)):
        out["local_count"] = port_step(state, local, torch.float32)
    with mock.patch.object(pointnet2, "global_rows", lambda rows: rows), \
            mock.patch.object(pointnet2, "local_rows", lambda x: x):
        out["local_draws"] = port_step(state, local, torch.float32,
                                       DRAW_SEED)
    out["adam"] = port_step(state, local, torch.float32, DRAW_SEED,
                            steps=3, lr=1e-3)["params"]
    out["pointnet"] = port_step(data["pn_state"], pn_local, torch.float32,
                                DRAW_SEED, argv=POINTNET)
    # the control: the bypass decided on the rank's own row count
    with mock.patch.object(pointnet, "global_rows", lambda rows: rows):
        out["pointnet_bypass"] = port_step(data["pn_state"], pn_local,
                                           torch.float32, DRAW_SEED,
                                           argv=POINTNET)

    # the collectives themselves: a differentiable sum and a host flag
    with parallel.sharded_batch():
        x = torch.full((3,), float(rank + 1), requires_grad=True)
        y = parallel.all_reduce_sum(x)
        (y * (rank + 1)).sum().backward()
    out["sum"] = (y.detach(), x.grad)
    out["agree"] = (parallel.agree(rank == 1), parallel.agree(False))
    return out


def _single_worker(rank, world, inputs):
    """The port's single-process steps at the global batch, ungrouped, with
    the DP cases' draws."""
    data = torch.load(inputs, weights_only=False)
    state, batch = data["state"], data["batch"]
    pn_state, pn_batch = data["pn_state"], data["pn_batch"]
    return dict(drawn=port_step(state, batch, torch.float32, DRAW_SEED),
                drawn64=port_step(state, batch, torch.float64, DRAW_SEED),
                **{f"pointnet{suffix}": port_step(
                    pn_state, pn_batch, dtype, DRAW_SEED, argv=POINTNET)
                   for suffix, dtype in (("", torch.float32),
                                         ("64", torch.float64))})


def _port_named(jax_tree: dict, collection: str) -> dict:
    from maskplanner_tpu_torch.convert import state_dict_from_flax

    sd = state_dict_from_flax({collection: jax_tree})
    return {k: v.double() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The eager JAX step at 4 clouds, the port's single-process step at 4
    clouds, and every DP case of both ranks."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu.data import collate
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train.schedulers import \
        apply_delayed_activations as jax_delayed
    from maskplanner_tpu.train.trainer import build_loss_batch as jax_blb
    from maskplanner_tpu.utils.args import load_args as jax_load_args
    from maskplanner_tpu_torch.convert import state_dict_from_flax
    from maskplanner_tpu_torch.data import PaintDataset, collate as tcollate
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    cfg = jax_load_args(argv=SMALL)
    batch = collate([JaxPaintDataset(cfg, split="train", size=GLOBAL_BATCH)[i]
                     for i in range(GLOBAL_BATCH)])
    rng = np.random.default_rng(0)
    model = get_flax_model(cfg)
    variables = model.init(jax.random.PRNGKey(1),
                           jnp.asarray(batch["point_cloud"]), train=False)
    # seeded non-zero biases and scales, as test_torch_port_train.py
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1
                      ).astype(np.float32)
        if p[-1].key in ("bias", "scale", "mean") else
        (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
         if p[-1].key == "var" else np.asarray(a)), variables)
    handler = JaxLossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(jax_delayed(cfg, dict(), 10 ** 6))
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)

    def jax_step(b):
        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(b["point_cloud"]), train=True,
                mutable=["batch_stats"])
            lb = jax_blb(out, jax.tree_util.tree_map(jnp.asarray, b), cfg)
            total, _ = handler.compute(weights, rng=None, **lb)
            return total, mutated["batch_stats"]

        # eager, as the port runs (test_torch_port_train.py)
        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        tree = jax.tree_util.tree_map(np.asarray, (grads, stats))
        return dict(loss=float(loss), grads=_port_named(tree[0], "params"),
                    stats=_port_named(tree[1], "batch_stats"))

    # the ranks and the single process run while this process steps JAX
    state = state_dict_from_flax(variables)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    tmp = tmp_path_factory.mktemp("dp_step")
    pn_cfg = load_args(argv=POINTNET)
    pn_ds = PaintDataset(pn_cfg, split="train", size=POINTNET_BATCH)
    pn_batch = {k: torch.as_tensor(v) for k, v in tcollate(
        [pn_ds[i] for i in range(POINTNET_BATCH)]).items()}
    pn_state = get_model(pn_cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0)
                         ).state_dict()
    torch.save(dict(state=state, batch=tbatch, pn_state=pn_state,
                    pn_batch=pn_batch), tmp / "inputs.pt")
    handle = start(_step_worker, WORLD, tmp, str(tmp / "inputs.pt"))
    alone = start(_single_worker, 1, tmp, str(tmp / "inputs.pt"),
                  group=False)
    try:
        ref = jax_step(batch)
        rev = jax_step({k: v[::-1] for k, v in batch.items()})
    finally:
        mp.undo()
    ref["own"] = dict(loss=abs(ref["loss"] - rev["loss"]), **{
        key: {n: (t - rev[key][n]).abs().max().item()
              for n, t in ref[key].items()} for key in ("grads", "stats")})
    (single,) = join(alone)
    return dict(jax=ref, single=single, ranks=join(handle))


def _sum_ranks(ranks, case):
    """The DP step's result over the group: the all-reduced gradients and
    the statistics (each rank's; they must agree), the global loss."""
    r0 = ranks[0][case]
    for other in ranks[1:]:
        assert other[case]["loss"] == r0["loss"], "ranks report other losses"
        for key in ("grads", "stats"):
            for n, t in r0[key].items():
                assert torch.equal(t, other[case][key][n]), (case, n)
    return r0


def own_error(f32, f64) -> dict:
    """A float32 step's own rounding: its distance from the same step in
    float64, the loss (or the losses) and each tensor's largest."""
    return dict(loss=abs(f32["loss"] - f64["loss"]), **{
        key: {n: (t - f64[key][n]).abs().max().item()
              for n, t in f32[key].items()} for key in ("grads", "stats")})


def held(got, want, own) -> list[str]:
    """test_one_train_step_matches_jax's rule -> the values of ``got`` that
    fail it: the loss within 1e-5 relative, each gradient within
    5e-4 · max|want|, each BatchNorm statistic within 1e-6, each plus
    ROUNDING_FACTOR times ``own`` (:func:`own_error` of the sound step
    ``got`` stands for) and, where ``want`` is the JAX step,
    JAX_ROUNDING_FACTOR times its own rounding (``want["own"]``)."""
    ref_own = want.get("own") or dict(loss=0.0, grads={}, stats={})
    bad = []
    gap = abs(got["loss"] - want["loss"])
    allowed = (1e-5 * abs(want["loss"]) + ROUNDING_FACTOR * own["loss"]
               + JAX_ROUNDING_FACTOR * ref_own["loss"])
    if gap > allowed:
        bad.append(f"loss: {gap:.3g} > {allowed:.3g}")
    for key, tol in (("grads", lambda w: 5e-4 * w.abs().max().item()),
                     ("stats", lambda w: 1e-6)):
        assert sorted(got[key]) == sorted(want[key])
        for name, w in want[key].items():
            gap = (got[key][name] - w).abs().max().item()
            allowed = (tol(w) + ROUNDING_FACTOR * own[key][name]
                       + JAX_ROUNDING_FACTOR * ref_own[key].get(name, 0.0))
            if gap > allowed:
                bad.append(f"{key}/{name}: {gap:.3g} > {allowed:.3g}")
    return bad


def test_dp_step_matches_the_jax_step_at_the_global_batch(cases):
    got = _sum_ranks(cases["ranks"], "f32")
    own = own_error(got, _sum_ranks(cases["ranks"], "f64"))
    assert held(got, cases["jax"], own) == []


def test_dp_step_matches_the_single_process_step(cases):
    """With the FPS starts and dropout masks drawn from one seeded
    generator: the DP step against the port's single-process step at the
    global batch, within the single process's own float32 error."""
    single = cases["single"]
    assert held(_sum_ranks(cases["ranks"], "drawn"), single["drawn"],
                own_error(single["drawn"], single["drawn64"])) == []


@pytest.mark.parametrize("case,expect_held", [("pointnet", True),
                                              ("pointnet_bypass", False)])
def test_pointnet_regressor_at_one_row_a_rank(cases, case, expect_held):
    """The PointNet regressor at a global batch of 2 over 2 ranks: its
    batch-1 bypass looks at the global batch, so both BatchNorms normalise
    over the 2 clouds, and the DP step is the single process's by
    :func:`held`'s rule. Deciding the bypass on the rank's one row (the
    control) skips them and fails it."""
    single = cases["single"]
    bad = held(_sum_ranks(cases["ranks"], case), single["pointnet"],
               own_error(single["pointnet"], single["pointnet64"]))
    assert (bad == []) == expect_held, bad


@pytest.mark.parametrize("control", ["local_bn", "local_count",
                                     "local_draws"])
def test_each_control_fails_the_comparison(cases, control):
    """Per-rank BatchNorm statistics and a per-rank ``total_matched`` fail
    against the JAX step; per-rank draws against the single-process step
    with the same generator (the JAX step draws from its own keys); each
    with the allowance of the sound step it stands for."""
    ranks, single = cases["ranks"], cases["single"]
    if control == "local_count":
        # a real control only where the halves' counts differ
        assert ranks[0]["f32"]["matched"] != ranks[1]["f32"]["matched"]
    if control == "local_draws":
        want = single["drawn"]
        own = own_error(single["drawn"], single["drawn64"])
    else:
        want = cases["jax"]
        own = own_error(_sum_ranks(ranks, "f32"), _sum_ranks(ranks, "f64"))
    assert held(ranks[0][control], want, own) != []


def test_matched_count_is_global(cases):
    ranks = cases["ranks"]
    assert (ranks[0]["drawn"]["matched"] + ranks[1]["drawn"]["matched"]
            == cases["single"]["drawn"]["matched"])


def test_parameters_bitwise_equal_across_ranks_after_adam(cases):
    a, b = (r["adam"] for r in cases["ranks"])
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    moved = [n for n in a if not torch.equal(a[n], cases["ranks"][0]
                                             ["f32"]["params"][n])]
    assert moved


def test_all_reduce_sum_and_agree(cases):
    """``all_reduce_sum``: forward the sum over the ranks, backward the sum
    of the ranks' cotangents; ``agree``: any rank's flag."""
    for rank, r in enumerate(cases["ranks"]):
        y, grad = r["sum"]
        assert torch.equal(y, torch.full((3,), 3.0))
        assert torch.equal(grad, torch.full((3,), 3.0))
        assert r["agree"] == (True, False)


# ---- a group of one, and the device-resident epoch ------------------------

# the flagship with on-device subsampling (staged at 128 points a cloud)
EPOCH = ["config=[maskplanner,windows_v2,longx_v2,augm_v1]", *SMALL[1:]]
EPOCH_ITEMS = 8


def _epoch_run(lr: float, dtype=torch.float32):
    """One device-resident epoch (eager, the CPU's) of 2 steps over a
    staged split of 8 items with on-device subsampling, from the seeded
    model in ``dtype`` -> per-step losses, the last step's gradients, the
    statistics and parameters."""
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.data.device_dataset import (
        epoch_perm, stage_device_dataset)
    from maskplanner_tpu_torch.losses import DeviceWeights, LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=EPOCH)
    dataset = PaintDataset(cfg, split="train", size=EPOCH_ITEMS)
    data = {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in stage_device_dataset(dataset, device="cpu").items()}
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0)).to(dtype)
    handler = LossHandler(cfg["loss"], cfg)
    floats = handler.init_weights()
    floats.update(_active_weights(cfg))
    optimizer = torch.optim.Adam(model.parameters(), lr=lr)
    ep = DeviceEpoch(model, optimizer, handler, data,
                     DeviceWeights(floats, "cpu"),
                     torch.Generator().manual_seed(DRAW_SEED),
                     int(cfg["pc_points"]))
    losses, _ = ep.run(epoch_perm(EPOCH_ITEMS, GLOBAL_BATCH, 0, 1))
    return dict(loss=losses.double(),
                grads={n: p.grad.double().clone()
                       for n, p in model.named_parameters()},
                stats={n: t.double().clone()
                       for n, t in model.state_dict().items()
                       if "running_" in n},
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()})


def _step_pair():
    """Two train steps (Adam at 1e-3, the generator's draws) of the seeded
    model on a batch of 4 -> losses, terms and the parameters."""
    from maskplanner_tpu_torch.data import PaintDataset, collate
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import batch_to_device, train_step
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=SMALL)
    ds = PaintDataset(cfg, split="train", size=GLOBAL_BATCH)
    batch = batch_to_device(collate([ds[i] for i in range(GLOBAL_BATCH)]),
                            "cpu")
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    handler = LossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(_active_weights(cfg))
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    generator = torch.Generator().manual_seed(DRAW_SEED)
    out = []
    for _ in range(2):
        loss, terms = train_step(model, optimizer, handler, batch, weights,
                                 generator)
        out.append((loss, terms))
    return dict(steps=out, params={n: p.detach().clone()
                                   for n, p in model.named_parameters()},
                stats={n: t.clone() for n, t in model.state_dict().items()})


def _world_one_worker(rank, world):
    return dict(step=_step_pair(), epoch=_epoch_run(1e-3))


def _bitwise(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _bitwise(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _bitwise(x, y, f"{what}/{i}")
    else:
        assert a == b, what


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    """The group of one's runs and, computed meanwhile, the ungrouped
    ones."""
    handle = start(_world_one_worker, 1, tmp_path_factory.mktemp("w1"))
    ungrouped = dict(step=_step_pair(), epoch=_epoch_run(1e-3))
    (grouped,) = join(handle)
    return grouped, ungrouped


@pytest.mark.parametrize("path", ["step", "epoch"])
def test_world_one_group_is_bitwise_the_ungrouped_path(world_one, path):
    """A process group of one runs every collective (on unchanged values):
    two Adam steps, and a device-resident epoch of two with on-device
    subsampling, bitwise the ungrouped run's losses, terms, parameters and
    statistics."""
    grouped, ungrouped = world_one
    _bitwise(grouped[path], ungrouped[path], path)


def _epoch_worker(rank, world):
    from maskplanner_tpu_torch import parallel
    from maskplanner_tpu_torch.train import trainer

    run = _epoch_run(0.0)
    # the control: every rank gathers (and subsamples) rank 0's rows
    with mock.patch.object(trainer, "local_rows", lambda x: (
            parallel.shard_rows(x, 0, parallel.global_rows(1)))):
        return dict(run=run, control=_epoch_run(0.0))


def test_device_epoch_over_two_ranks_matches_the_single_process(tmp_path):
    """An epoch of 2 steps of the device-resident epoch (each rank gathers
    its rows of every batch and subsamples them from the global draw), at
    LR 0 so that both steps start from the same parameters, against the
    single process's by :func:`held`'s rule (each step's loss, the last
    step's gradients, the running statistics after both steps; the
    allowance from the single process's own float32 error). The same run
    with rank 0's rows gathered on both ranks fails it."""
    handle = start(_epoch_worker, WORLD, tmp_path)
    ref = _epoch_run(0.0)
    own = own_error(ref, _epoch_run(0.0, torch.float64))
    ranks = join(handle)
    _bitwise(ranks[0]["run"], ranks[1]["run"])

    def per_step(run):
        return [dict(run, loss=float(v)) for v in run["loss"]]

    for kind, expect_held in (("run", True), ("control", False)):
        bad = [held(got, want, dict(own, loss=float(o)))
               for got, want, o in zip(per_step(ranks[0][kind]),
                                       per_step(ref), own["loss"])]
        assert (sum(bad, []) == []) == expect_held, (kind, bad)


# ---- the host loader and the shard bounds ----------------------------------

@pytest.mark.parametrize("augm", [False, True])
@pytest.mark.parametrize("shard", [0, 1])
def test_host_loader_shards_are_the_jax_loaders_items(shard, augm):
    """``DataLoader(num_shards=2, shard_index=r)`` yields, batch for batch,
    bitwise the JAX loader's items (with ``pc_online_subsampling``, the
    per-shard host draws too), and the two shards rebuild the global
    batch as ``parallel.shard_rows`` splits it."""
    from maskplanner_tpu.data.dataset import DataLoader as JaxLoader
    from maskplanner_tpu.data.dataset import PaintDataset as JaxDataset
    from maskplanner_tpu.utils.args import load_args as jax_load_args
    from maskplanner_tpu_torch.data import DataLoader, PaintDataset
    from maskplanner_tpu_torch.parallel import shard_rows
    from maskplanner_tpu_torch.utils.args import load_args

    argv = ["config=[maskplanner,cuboids_v2,longx_v2,debug]", "pc_points=64",
            "n_pred_traj_points=80"] + (
                ["augmentations=[pc_online_subsampling]"] if augm else [])
    ours = DataLoader(PaintDataset(load_args(argv=argv), split="train",
                                   size=8), 4, shuffle=True, seed=3,
                      num_shards=2, shard_index=shard)
    theirs = JaxLoader(JaxDataset(jax_load_args(argv=argv), split="train",
                                  size=8), 4, shuffle=True, seed=3,
                       num_shards=2, shard_index=shard)
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    if not augm:
        whole = next(DataLoader(PaintDataset(load_args(argv=argv),
                                             split="train", size=8), 4,
                                shuffle=True, seed=3).epoch(0))
        for k, v in whole.items():
            np.testing.assert_array_equal(
                shard_rows(torch.as_tensor(v), shard, 2).numpy(),
                next(ours.epoch(0))[k])


@pytest.mark.parametrize("n,index,count", [
    (10, 0, 1), (10, 2, 3), (10, 0, 3), (7, 1, 2), (8, 3, 4), (3, 2, 4)])
def test_host_shard_bounds_are_the_jax_ones(n, index, count):
    from maskplanner_tpu.parallel.mesh import host_shard_bounds as jax_bounds
    from maskplanner_tpu_torch.parallel import host_shard_bounds

    assert host_shard_bounds(n, index, count) == jax_bounds(n, index, count)


def test_ungrouped_helpers_are_the_identity():
    """Without a group: ``sharded_batch`` yields 1 and every helper returns
    its input, bitwise, so the ungrouped step is the one before this
    layer."""
    from maskplanner_tpu_torch import parallel

    assert not parallel.grouped()
    x = torch.arange(6.0).reshape(3, 2)
    with parallel.sharded_batch() as world:
        assert world == 1
        assert parallel.local_rows(x) is x and parallel.global_rows(3) == 3
        assert parallel.mean_over_ranks(x, x)[0] is x
        assert parallel.global_sum(x) is x and parallel.loss_share(x) is x
        assert torch.equal(parallel.batch_count(torch.tensor(0), 1),
                           torch.tensor(1))
    assert parallel.agree(True) and not parallel.agree(False)
    assert parallel.distributed_init() == (0, 1)
    with pytest.raises(ValueError, match="divide"):
        parallel.shard_rows(x, 0, 2)
