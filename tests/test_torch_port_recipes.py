"""The port's other shipped recipes against the JAX package, on the CPU:
the paper's baselines ``segmentWise`` and ``pointWise`` (the symmetric
segment chamfer with stroke masks, at λ=4 and λ=1), the composites
``asymm_chamfer_v11`` and ``symm_chamfer_v1``, and the plain regressor
(``model.backbone=pointnet2``) with ``loss=[chamfer,repulsion]``.

At the small size of ``tests/test_torch_port_train.py`` (``pc_points=64``,
hidden 32x32, 120 poses, 6 stroke masks), the same converted weights on
both sides, FPS from index 0, dropout off and the loss weights after the
delayed activation, the first training step's loss and each of its terms
agree with the eager JAX step within 1e-5 relative, plus a float32
rounding allowance (``ROUNDING_FACTOR``). The driver trains each
recipe for 2 epochs with its final eval and dumps; the regressor's forward
agrees with the JAX module's within 1e-5 · max|ref|, and its weights
convert both ways; a device-resident epoch with the stochastic term
(``stoch_reverse_asymm_segment_chamfer``) is bitwise the host loader's.
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

SIZE = ["pc_points=64", "model.hidden_size=[32,32]",
        "n_pred_traj_points=120", "max_n_strokes=6"]
RECIPES = {
    "segmentWise": ["config=[segmentWise,windows_v2,longx_v2]"],
    "pointWise": ["config=[pointWise,windows_v2,longx_v2]"],
    "asymm_chamfer_v11": ["config=[asymm_chamfer_v11,delayMasksLoss,"
                          "traj_sampling_v2,sched_v9,windows_v2,longx_v2]"],
    "symm_chamfer_v1": ["config=[symm_chamfer_v1,delayMasksLoss,"
                        "traj_sampling_v2,sched_v9,windows_v2,longx_v2]"],
    "pointnet2": ["config=[maskplanner,windows_v2,longx_v2]",
                  "model.backbone=pointnet2", "loss=[chamfer,repulsion]",
                  "eval_metrics=[pcd]"],
}
STEP_BATCH = 4
# At random init the heads put many poses within a small fraction of
# their own magnitude of each other, so a distance between two of them
# loses most of its float32 digits to cancellation: the repulsion term
# moves with the forward's rounding, and the JAX forward's float32 outputs
# lie 6x further from the port's float64 ones than the port's float32
# outputs do (3e-4 against 5e-5 of max|out| 3.2 on the regressor's
# case; 4e-5 relative on the term). So each value is allowed, as in
# tests/test_torch_port_train.py, this many times the port's own float32
# error on it (its float32 step against its float64 step) ...
ROUNDING_FACTOR = 10
# ... and this many times the JAX step's own, sampled by the same step on
# the batch in reverse order
JAX_ROUNDING_FACTOR = 3


def _argv(recipe):
    return [*RECIPES[recipe], *SIZE]


@pytest.fixture(scope="module")
def deterministic_nn():
    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    yield mp
    mp.undo()


def _perturbed(variables, seed=0):
    """Seeded non-zero biases, scales and running statistics (Flax starts
    biases at 0, and sa1's first LayerNorm then sees constant rows)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1
                      ).astype(np.float32)
        if p[-1].key in ("bias", "scale", "mean") else
        (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
         if p[-1].key == "var" else np.asarray(a)), variables)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_first_step_matches_jax(recipe, deterministic_nn):
    """The loss and each term of the first step, the port's (Adam at lr 0)
    against the eager JAX step's, within 1e-5 relative plus the rounding
    allowance."""
    import flax.linen as fnn

    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu.data import collate
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train.schedulers import \
        apply_delayed_activations as jax_delayed
    from maskplanner_tpu.train.trainer import build_loss_batch as jax_blb
    from maskplanner_tpu_torch.convert import state_dict_from_flax
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import (apply_delayed_activations,
                                             batch_to_device, train_step)

    jcfg = jax_load_args(argv=_argv(recipe))
    batch = collate([JaxPaintDataset(jcfg, split="train", size=STEP_BATCH)[i]
                     for i in range(STEP_BATCH)])
    model = get_flax_model(jcfg)
    variables = _perturbed(model.init(
        jax.random.PRNGKey(1), jnp.asarray(batch["point_cloud"]),
        train=False))
    jhandler = JaxLossHandler(jcfg["loss"], jcfg)
    jweights = jhandler.init_weights()
    jweights.update(jax_delayed(jcfg, dict(), 10 ** 6))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)

        def jax_step(b):
            out, _ = model.apply(
                {"params": variables["params"],
                 "batch_stats": variables["batch_stats"]},
                jnp.asarray(b["point_cloud"]), train=True,
                mutable=["batch_stats"])
            lb = jax_blb(out, jax.tree_util.tree_map(jnp.asarray, b), jcfg)
            loss, terms = jhandler.compute(jweights, rng=None, **lb)
            return {k: float(v) for k, v in dict(terms, loss=loss).items()}

        ref = jax_step(batch)
        # the JAX step's own rounding, sampled by the batch in reverse
        rev = jax_step({k: v[::-1] for k, v in batch.items()})

    cfg = load_args(argv=_argv(recipe))
    handler = LossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(apply_delayed_activations(cfg, dict(), 10 ** 6))

    def port_step(dtype):
        port = get_model(cfg, device="cpu", dropout=0.0)
        port.load_state_dict(state_dict_from_flax(variables), strict=True)
        port.to(dtype)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch_to_device(batch, "cpu").items()}
        optimizer = torch.optim.Adam(port.parameters(), lr=0.0)
        loss, terms = train_step(port, optimizer, handler, b, weights)
        return port, dict(terms, loss=loss)

    port, got = port_step(torch.float32)
    _, exact = port_step(torch.float64)
    assert list(got) == list(ref) == [*cfg["loss"], "loss"]
    for name, want in ref.items():
        own = abs(float(got[name]) - float(exact[name]))
        np.testing.assert_allclose(
            float(got[name]), want, rtol=0,
            atol=1e-5 * abs(want) + ROUNDING_FACTOR * own
            + JAX_ROUNDING_FACTOR * abs(want - rev[name]), err_msg=name)
    # every parameter the recipe trains got a gradient
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in port.parameters())


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_driver_trains_and_evaluates_the_recipe(recipe, tmp_path):
    """2 epochs through the driver, an eval each, the final eval with its
    dumps and summary; the regressor's dumps hold no masks, and its run
    warm-starts another and scores through the eval CLI."""
    from maskplanner_tpu_torch import test_maskplanner, train_maskplanner

    args = [*_argv(recipe), "batch_size=2", "device=cpu", "epochs=2",
            "eval_freq=1", "dataset_size=4", "test_dataset_size=2",
            "seed=3", "no_save=false", f"output_dir={tmp_path}"]
    run_dir, model = train_maskplanner.main(args)
    with open(os.path.join(run_dir, "summary.json")) as fh:
        summary = json.load(fh)
    assert np.isfinite(summary["final_test_loss"])
    assert np.isfinite(summary["final_test_point-wise chamfer distance"])
    with open(os.path.join(run_dir, "logs.jsonl")) as fh:
        logs = [json.loads(line) for line in fh]
    assert len(logs) == 2 and all(np.isfinite(log["train_loss"])
                                  for log in logs)
    dump = np.load(os.path.join(run_dir, "results",
                                "last_test_batch0.npy"),
                   allow_pickle=True).item()
    assert np.isfinite(dump["traj_pred"]).all()
    if recipe != "pointnet2":
        assert dump["pred_stroke_masks"].shape[1] == 6
        return
    assert dump["traj_pred"].shape == dump["traj"].shape[:1] + (39, 24)
    assert dump["pred_stroke_masks"] is None
    assert dump["stroke_masks_scores"] is None and dump["seg_logits"] is None
    _, _, metrics = test_maskplanner.main(["--run", run_dir, "--device",
                                           "cpu"])
    np.testing.assert_allclose(
        metrics["point-wise chamfer distance"],
        summary["final_test_point-wise chamfer distance"], rtol=1e-6)
    warm, _ = train_maskplanner.main(
        [*args, "epochs=1", "model.load_strict=true",
         f"model.pretrained_custom={run_dir}", f"output_dir={tmp_path}/w"])
    a = torch.load(os.path.join(run_dir, "last_checkpoint.torch.pt"))
    w = torch.load(os.path.join(warm, "last_checkpoint.torch.pt"))
    assert a["model"].keys() == w["model"].keys()


@pytest.fixture(scope="module")
def regressor(deterministic_nn):
    from maskplanner_tpu.models import get_model as get_flax_model

    cfg = jax_load_args(argv=_argv("pointnet2"))
    model = get_flax_model(cfg)
    pc = np.random.default_rng(2).normal(size=(2, 64, 3)).astype(np.float32)
    variables = _perturbed(model.init(jax.random.PRNGKey(0),
                                      jnp.asarray(pc), train=False))
    return model, variables, pc


def test_regressor_forward_matches_jax(regressor):
    """The eval forward within 1e-5 · max|ref|; the port's model is the
    plain segment tensor, with the flagship's module names."""
    from maskplanner_tpu_torch.convert import state_dict_from_flax
    from maskplanner_tpu_torch.models import PointNet2Regressor, get_model

    model, variables, pc = regressor
    ref = np.asarray(model.apply(variables, jnp.asarray(pc), train=False))
    port = get_model(load_args(argv=_argv("pointnet2")), device="cpu")
    assert type(port) is PointNet2Regressor
    port.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(pc))
    assert isinstance(got, torch.Tensor) and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    names = {k.split(".")[0] for k in port.state_dict()}
    assert names == {"sa1", "sa2", "sa3", "fc1", "bn1", "fc2", "bn2", "fc3",
                     "fc_normals"}


def test_regressor_weights_convert_both_ways(regressor):
    """Flax -> port -> Flax gives back every array, and the tree's paths
    are a subset of the flagship's."""
    from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                               state_dict_from_flax)

    _, variables, _ = regressor
    back = flax_tree_from_state_dict(state_dict_from_flax(variables))
    want = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_leaves_with_path(variables)}
    got = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
           jax.tree_util.tree_leaves_with_path(back)}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_device_epoch_with_the_stochastic_term_is_the_host_epoch():
    """The loss's random subset comes from the step's generator, so the
    device-resident epoch (eager on the CPU) is bitwise the host loader's,
    the generators end in one state, and the subset moves between steps."""
    from maskplanner_tpu_torch.data import DataLoader, PaintDataset
    from maskplanner_tpu_torch.data.device_dataset import (
        epoch_perm, stage_device_dataset)
    from maskplanner_tpu_torch.losses import DeviceWeights, LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import (apply_delayed_activations,
                                             make_optimizer)
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch, host_epoch

    argv = [*_argv("segmentWise"), "loss=[chamfer_with_stroke_masks,"
            "stoch_reverse_asymm_segment_chamfer]"]

    def setup():
        cfg = load_args(argv=argv)
        model = get_model(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
        handler = LossHandler(cfg["loss"], cfg)
        weights = DeviceWeights(apply_delayed_activations(
            cfg, handler.init_weights(), 10 ** 6), "cpu")
        return dict(model=model, handler=handler, weights=weights,
                    optimizer=make_optimizer(model, cfg),
                    generator=torch.Generator().manual_seed(7),
                    dataset=PaintDataset(cfg, "train", size=4))

    host, dev = setup(), setup()
    loader = DataLoader(host["dataset"], 2, shuffle=True, seed=1)
    data = stage_device_dataset(dev["dataset"], device="cpu")
    epoch = DeviceEpoch(dev["model"], dev["optimizer"], dev["handler"], data,
                        dev["weights"], dev["generator"], 64)
    for e in range(2):
        batches = [{k: torch.as_tensor(v) for k, v in b.items()}
                   for b in loader.epoch(e)]
        want = host_epoch(host["model"], host["optimizer"], host["handler"],
                          batches, host["weights"], host["generator"])
        got = epoch.run(epoch_perm(4, 2, 1, e))
        assert torch.equal(got[0], want[0])
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), k
    stoch = got[1]["stoch_reverse_asymm_segment_chamfer"]
    assert torch.isfinite(stoch).all() and stoch[0] != stoch[1]
    for a, b in zip(host["model"].state_dict().values(),
                    dev["model"].state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(host["generator"].get_state(),
                       dev["generator"].get_state())
