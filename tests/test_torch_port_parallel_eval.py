"""The port's eval sharded over the ranks (``train.loop.evaluate`` and the
training driver's evals in a process group) against the single process,
on the CPU: 2 gloo ranks, each a spawned process, as in
``test_torch_port_parallel_driver.py``.

The split has 7 test clouds at an eval batch of 4: a first batch that the
ranks shard (2 rows each) and a last batch of 3, which does not divide and
runs whole, as in the JAX loop (``maskplanner_tpu/train/loop.py:44-48``).
The loss, its terms and every metric of the eval path are the single
process's within 1e-5 relative (the driver test's float32 rule); the
dumps have the single process's names and keys, the names and the
ground-truth arrays bitwise and the predicted arrays within 1e-5
relative.

The model is the seeded init with seeded non-zero biases (std 0.1, as the
step tests take them), and the mask head's with std 2, so that the
stroke masks' matching costs differ from stroke to stroke, as a trained
model's do. At random init the flagship loss is 99% chamfer terms, which
are means over rows and need no normaliser over the ranks, so the eval
is also held on the loss's batch-spanning part alone: the stroke-mask
term (``MASK_TERM``: the other weights 0), which divides by the matched
count of the whole batch (``losses/mask_losses.py``, ``batch_count``).
The control computes each rank's loss on its rows outside
``parallel.sharded_batch``, where that term divides by the rank's own
count, and averages the ranks by row count: on that term it misses the
rule by 5.2e-4 relative on this split, 52 times the rule (on the whole
loss, whose chamfer terms are the same either way, it misses by 1.6e-6,
inside the rule).

Both ranks are also held against the JAX eval loop
(``maskplanner_tpu/train/loop.py::evaluate``) on the same 7 clouds and
the same weights (converted by ``convert.flax_tree_from_state_dict``),
run eagerly with ``MASKPLANNER_DETERMINISTIC_NN`` as
``test_torch_port_eval.py`` runs it, under that file's rule: the loss,
its terms and every metric of both ranks within 1e-4 relative, the
single process's stroke counts exactly, and rank 0's dumped predictions
within 1e-4 of their largest, its inputs equal.

A group of one process gives bitwise the ungrouped eval, and a 2-rank
``train_maskplanner.main`` run has the single run's ``final_*`` summary
and logged evals by the same rule, with rank 1 writing nothing.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_port_parallel import _active_weights, join, start

torch.set_num_threads(1)

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
SMALL = [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]",
         "n_pred_traj_points=120", "max_n_strokes=6"]
EVAL_BATCH = 4
TEST_CLOUDS = 7
# every metric this eval path gives: the SoP and stroke-wise families need
# other models' outputs, and stroke_chamfer per-pose stroke ids, where the
# batch's are per segment
METRICS = ["pcd", "chamfer_original", "clustering_metrics",
           "stroke_masks_metrics"]
REL = 1e-5
# the port against JAX through the model (test_torch_port_eval.py)
LOOP_RTOL = 1e-4
# the driver at LR 0, so that both runs evaluate the same weights; 7 test
# clouds at batch 4 (a sharded batch, then 3 rows whole)
RUN = [*SMALL, "batch_size=4", "dataset_size=8", "test_dataset_size=7",
       "epochs=1", "eval_freq=1", "no_save=false", "skip_rendering=true",
       "seed=3", "lr=0.0", f"eval_metrics=[{','.join(METRICS)}]"]
# the recipe's weights but for these, set to 0: the stroke-mask term alone
MASK_TERM = ("weight_asymm_segment_chamfer",
             "weight_reverse_asymm_point_chamfer",
             "weight_reverse_asymm_segment_chamfer",
             "explicit_weight_stroke_masks_confidence")
GT_KEYS = ("traj", "stroke_ids", "stroke_ids_as_pc", "traj_as_pc",
           "n_strokes", "point_cloud")
PRED_KEYS = ("traj_pred", "pred_stroke_masks", "stroke_masks_scores",
             "seg_logits")


def _parts():
    """The model (seeded init and biases), loader, loss handler, active
    loss weights and metrics of the test split."""
    from maskplanner_tpu_torch.data import DataLoader, PaintDataset
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.metrics import MetricsHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=SMALL)
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for name, t in [*model.named_parameters(), *model.named_buffers()]:
            std = 2.0 if name == "sm_fc3.bias" else 0.1
            if name.endswith(("bias", "running_mean")):
                t.add_(torch.from_numpy(rng.normal(size=t.shape) * std))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, t.shape)))
    loader = DataLoader(PaintDataset(cfg, split="test", size=TEST_CLOUDS),
                        EVAL_BATCH, shuffle=False, drop_last=False)
    handler = LossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(_active_weights(cfg))
    return model, loader, handler, weights, MetricsHandler(cfg, METRICS)


def _eval(dump_dir):
    """``evaluate`` with its dumps and latency -> (loss, terms, metrics,
    ms, the dumps' file names, the loss of the stroke-mask term alone)."""
    from maskplanner_tpu_torch.train import forward
    from maskplanner_tpu_torch.train.loop import evaluate

    model, loader, handler, weights, metrics = _parts()
    os.makedirs(dump_dir)
    loss, terms, values, ms = evaluate(
        model, loader, handler, weights, metrics, "cpu", save=True,
        save_dir=dump_dir, split="test", forward=forward)
    mask_term, _, _, _ = evaluate(model, loader, handler,
                                  _mask_term(weights), None, "cpu")
    return dict(loss=loss, terms=terms, metrics=values, ms=ms,
                files=sorted(os.listdir(dump_dir)), mask_term=mask_term)


def _mask_term(weights):
    return {**weights, **dict.fromkeys(MASK_TERM, 0.0)}


def _eval_worker(rank, world, root):
    """The eval on this rank (rank 1's dump directory must stay empty),
    then a driver run in its own working directory."""
    from maskplanner_tpu_torch import train_maskplanner

    out = _eval(os.path.join(root, f"dumps{rank}"))
    if world > 1:
        own = os.path.join(root, f"cwd{rank}")
        os.makedirs(own)
        os.chdir(own)
        out["run"], _ = train_maskplanner.main(
            [*RUN, "device=cpu", f"output_dir={root}/runs"])
        out["cwd"] = sorted(os.listdir(own))
    return out


def _control_loss():
    """The stroke-mask term without ``sharded_batch``: each rank's rows
    with their own normaliser, the ranks averaged by row count (a batch
    that does not divide, whole)."""
    from maskplanner_tpu_torch.parallel import shard_rows
    from maskplanner_tpu_torch.train import batch_to_device, eval_step

    model, loader, handler, weights, _ = _parts()
    weights = _mask_term(weights)
    generator = torch.Generator().manual_seed(0)
    total, count = 0.0, 0
    for batch in loader.epoch(0):
        B = batch["point_cloud"].shape[0]
        world = 2 if B % 2 == 0 else 1
        for r in range(world):
            rows = {k: shard_rows(v, r, world) for k, v in batch.items()}
            loss, _, _ = eval_step(model, handler,
                                   batch_to_device(rows, "cpu"), weights,
                                   generator)
            total += float(loss) * (B // world)
        count += B
    return total / count


def _jax_eval(dump_dir):
    """The JAX eval loop on the same clouds, weights (``_parts``'s,
    converted) and active loss weights, eagerly, with its dumps ->
    (loss, terms, metrics, ms)."""
    import jax
    import jax.numpy as jnp
    from types import SimpleNamespace

    from maskplanner_tpu.data import DataLoader as JaxLoader
    from maskplanner_tpu.data import PaintDataset as JaxDataset
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu.metrics import MetricsHandler as JaxMetrics
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train.loop import evaluate as jax_evaluate
    from maskplanner_tpu.utils.args import load_args as jax_load_args
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict
    from test_torch_port_eval import _eager_eval_step, _eager_forward

    model, _, _, weights, _ = _parts()
    tree = flax_tree_from_state_dict(model.state_dict())
    state = SimpleNamespace(params=tree["params"],
                            batch_stats=tree.get("batch_stats", {}))
    cfg = jax_load_args(argv=SMALL)
    flax_model = get_flax_model(cfg)
    handler = JaxLossHandler(cfg["loss"], cfg)
    jweights = handler.init_weights()
    jweights.update({k: jnp.asarray(v, jnp.float32)
                     for k, v in weights.items()})
    loader = JaxLoader(JaxDataset(cfg, split="test", size=TEST_CLOUDS),
                       EVAL_BATCH, shuffle=False, drop_last=False)
    os.makedirs(dump_dir)
    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    try:
        return jax_evaluate(
            state, loader, _eager_eval_step(flax_model, handler, cfg),
            jweights, JaxMetrics(cfg, METRICS), jax.random.PRNGKey(0),
            save=True, save_dir=dump_dir, forward=_eager_forward(flax_model))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    from maskplanner_tpu_torch import train_maskplanner

    root = tmp_path_factory.mktemp("dp_eval")
    two = start(_eval_worker, 2, root, str(root / "two"))
    one = start(_eval_worker, 1, root, str(root / "one"))
    single = _eval(str(root / "single"))
    run, _ = train_maskplanner.main(
        [*RUN, "device=cpu", f"output_dir={root / 'single_run'}"])
    jax_ref = _jax_eval(str(root / "jax"))
    return dict(two=join(two), one=join(one), single=single,
                single_run=run, jax=jax_ref, root=root)


def _close(got, want, what):
    assert got == pytest.approx(want, rel=REL, abs=0), what


def test_sharded_eval_matches_the_single_process(evals):
    """Both ranks return the single process's loss, terms and metrics
    within 1e-5 relative; the split's first batch was sharded and its
    last ran whole."""
    from maskplanner_tpu_torch.metrics import METRIC_OUTPUTS

    single = evals["single"]
    assert list(single["metrics"]) == [n for m in METRICS
                                       for n in METRIC_OUTPUTS[m]]
    for rank in evals["two"]:
        _close(rank["loss"], single["loss"], "loss")
        _close(rank["mask_term"], single["mask_term"], "stroke-mask term")
        assert rank["terms"].keys() == single["terms"].keys()
        for k, v in single["terms"].items():
            _close(rank["terms"][k], v, k)
        assert list(rank["metrics"]) == list(single["metrics"])
        for k, v in single["metrics"].items():
            _close(rank["metrics"][k], v, k)
    # rank 0 alone times the single sample
    assert evals["two"][0]["ms"] > 0 and evals["two"][1]["ms"] is None


def test_sharded_eval_matches_jax(evals):
    """Both ranks against the JAX eval loop on the same clouds and
    weights: loss, terms and every metric within 1e-4 relative; the single
    process's stroke counts exactly. The counts mean something only if no
    JAX mask-score logit sits at the threshold (sigmoid 0.5: logit 0)."""
    from test_torch_port_eval import COUNT_NAMES

    loss, terms, metrics, ms = evals["jax"]
    assert ms > 0
    for rank in evals["two"]:
        np.testing.assert_allclose(rank["loss"], loss, rtol=LOOP_RTOL)
        assert list(rank["terms"]) == list(terms)
        for k in terms:
            np.testing.assert_allclose(rank["terms"][k], terms[k],
                                       rtol=LOOP_RTOL, err_msg=k)
        assert list(rank["metrics"]) == list(metrics)
        for k in metrics:
            np.testing.assert_allclose(rank["metrics"][k], metrics[k],
                                       rtol=LOOP_RTOL, err_msg=k)
    for name in COUNT_NAMES:
        assert evals["single"]["metrics"][name] == metrics[name], name
    root = evals["root"]
    scores = np.concatenate([
        np.load(os.path.join(root, "jax", name),
                allow_pickle=True).item()["stroke_masks_scores"]
        for name in evals["single"]["files"]])
    margin = float(np.abs(scores).min())
    assert margin > 1e-3, f"a JAX mask-score logit lies {margin} from 0"


def test_rank_0_dumps_match_jax(evals):
    """Rank 0's dumps against the JAX loop's: the same names and keys,
    inputs and names equal, predictions within 1e-4 of their largest."""
    root = evals["root"]
    names = sorted(os.listdir(os.path.join(root, "jax")))
    assert names == evals["two"][0]["files"]
    for name in names:
        want = np.load(os.path.join(root, "jax", name),
                       allow_pickle=True).item()
        got = np.load(os.path.join(root, "two", "dumps0", name),
                      allow_pickle=True).item()
        assert got.keys() == want.keys()
        assert got["dirnames"] == want["dirnames"]
        assert (got["batch"], got["suffix"]) == (want["batch"],
                                                 want["suffix"])
        for k in GT_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in PRED_KEYS:
            if want[k] is None:
                assert got[k] is None, k
                continue
            assert (got[k].dtype, got[k].shape) == (want[k].dtype,
                                                    want[k].shape), k
            np.testing.assert_allclose(
                got[k], want[k], rtol=0,
                atol=LOOP_RTOL * np.abs(want[k]).max(), err_msg=k)


def test_the_row_weighted_control_misses(evals):
    """The stroke-mask term of each rank's rows with its own normaliser,
    averaged by row count, misses the rule that the sharded eval meets
    (by 5.2e-4 relative: the module's docstring)."""
    want = evals["single"]["mask_term"]
    control = _control_loss()
    assert abs(control - want) > 10 * REL * abs(want)


def test_rank_0_writes_the_single_process_dumps(evals):
    root, single = evals["root"], evals["single"]
    assert single["files"] == ["last_test_batch0.npy", "last_test_batch1.npy"]
    assert evals["two"][0]["files"] == single["files"]
    assert evals["two"][1]["files"] == []
    for name in single["files"]:
        want = np.load(os.path.join(root, "single", name),
                       allow_pickle=True).item()
        got = np.load(os.path.join(root, "two", "dumps0", name),
                      allow_pickle=True).item()
        assert got.keys() == want.keys()
        assert got["dirnames"] == want["dirnames"]
        assert (got["batch"], got["suffix"]) == (want["batch"],
                                                 want["suffix"])
        for k in GT_KEYS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in PRED_KEYS:
            if want[k] is None:     # the flagship has no segment confidence
                assert k == "seg_logits" and got[k] is None
                continue
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=0,
                                       err_msg=k)


def test_a_group_of_one_is_the_ungrouped_eval(evals):
    (one,), single = evals["one"], evals["single"]
    for k in ("loss", "terms", "metrics", "mask_term"):
        assert one[k] == single[k], k
    root = evals["root"]
    for name in single["files"]:
        want = np.load(os.path.join(root, "single", name),
                       allow_pickle=True).item()
        got = np.load(os.path.join(root, "one", "dumps0", name),
                      allow_pickle=True).item()
        for k in GT_KEYS + PRED_KEYS:
            if want[k] is None:
                assert got[k] is None, k
            else:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_two_rank_driver_has_the_single_final_summary(evals):
    """The driver's periodic and final evals on both ranks: rank 0's
    ``final_*`` summary and logged eval losses are the single run's by the
    rule above; rank 1 returns no run and writes nothing."""
    ranks = evals["two"]
    assert ranks[1]["run"] is None and ranks[1]["cwd"] == []
    assert ranks[0]["cwd"] == []
    assert len(os.listdir(os.path.join(evals["root"], "two", "runs"))) == 1
    got_dir, want_dir = ranks[0]["run"], evals["single_run"]
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
    assert sorted(os.listdir(os.path.join(got_dir, "results"))) == sorted(
        os.listdir(os.path.join(want_dir, "results")))

    def summary(run_dir):
        with open(os.path.join(run_dir, "summary.json")) as fh:
            return json.load(fh)

    got, want = summary(got_dir), summary(want_dir)
    final = [k for k in want if k.startswith("final_")]
    assert final and sorted(final) == sorted(k for k in got
                                             if k.startswith("final_"))
    assert {"final_train_loss", "final_test_loss",
            "final_test_point-wise chamfer distance"} <= set(final)
    for k in final:
        _close(got[k], want[k], k)

    def logged(run_dir):
        with open(os.path.join(run_dir, "logs.jsonl")) as fh:
            return [{k: v for k, v in json.loads(line).items()
                     if k not in ("_time", "epoch_seconds")}
                    for line in fh]

    for a, b in zip(logged(got_dir), logged(want_dir), strict=True):
        assert a.keys() == b.keys() and "eval_loss" in a
        assert "point-wise chamfer distance" in a
        for k in b:
            _close(a[k], b[k], k)
