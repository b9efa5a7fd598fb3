"""The PyTorch port's eval (metrics, eval loop and dumps, the final eval of
its driver, its eval CLI) against the JAX package's, on the CPU.

The JAX side runs eagerly with ``MASKPLANNER_DETERMINISTIC_NN`` set, as the
step tests do: under ``jax.jit`` XLA fuses the fixed-order distance sums,
and near-ties of the nearest-neighbour matching can fall the other way
(ROADMAP.md, Queue 3). Tolerances: the metric code alone on the same
inputs agrees within 1e-6 relative (chamfer metrics) or exactly (counts,
clustering scores); through the model, as the step tests allow for the
JAX package's LayerNorm and BatchNorm variance (Queue 3), within 1e-4
relative (loss, terms, pcd, dumped outputs), counts exactly.
"""
import glob
import json
import os
import shutil
import sys

import numpy as np
import jax
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
# the debug flagship at a small width (449 segments, 22 masks): the loop,
# the driver and both CLIs share these shapes, so the eager JAX side
# compiles each op once a worker
SMALL = ["config=[maskplanner,windows_v2,longx_v2,debug]", "pc_points=64",
         "model.hidden_size=[32,32]", "batch_size=2"]
LOOP_RTOL = 1e-4
METRIC_RTOL = 1e-6
# the JAX driver's summary.json (root train_maskplanner.py:349-377): these,
# then final_{split}_loss, final_{split}_{metric} and {split}_inference_ms
SUMMARY_KEYS = ("best_epoch", "best_eval_loss", "last_eval_loss",
                "tot_train_seconds")
DUMP_KEYS = {"dirnames", "traj", "stroke_ids", "stroke_ids_as_pc",
             "traj_as_pc", "traj_pred", "pred_stroke_masks",
             "stroke_masks_scores", "seg_logits", "n_strokes", "point_cloud",
             "batch", "suffix"}
COUNT_NAMES = ("perc_correct_n_strokes", "avg_num_of_pred_strokes",
               "avg_num_of_gt_strokes", "mean_absolute_error_NoP")


@pytest.fixture(autouse=True)
def deterministic_nn(monkeypatch):
    monkeypatch.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")


def _metric_inputs(seed=0, B=3, V=20, lam=4, M=6):
    """Seeded metric inputs: V predicted segments of λ poses (d 6), V GT
    poses with a −100-padded suffix of another length in each sample,
    per-pose GT stroke ids (−1 on padding), mask logits and scores."""
    rng = np.random.default_rng(seed)
    y_pred = rng.normal(size=(B, V, lam * 6)).astype(np.float32)
    traj = rng.normal(size=(B, V, 6)).astype(np.float32)
    ids = rng.integers(0, 3, size=(B, V)).astype(np.int64)
    for b, n_valid in enumerate((V, V - 5, V - 9)[:B]):
        traj[b, n_valid:] = -100.0
        ids[b, n_valid:] = -1
    masks = rng.normal(size=(B, M, V)).astype(np.float32) * 3.0
    scores = rng.normal(size=(B, M)).astype(np.float32) * 3.0
    n_strokes = np.array([len(np.unique(r[r >= 0])) for r in ids])
    return dict(y_pred=y_pred, traj_as_pc=traj, traj_pc=traj,
                stroke_ids=ids, pc_mask=ids >= 0, n_strokes=n_strokes,
                pred_stroke_masks=masks, mask_scores=scores,
                traj_pred=[np.zeros((n, 3)) for n in (2, 3, 4)[:B]])


FAMILIES = [["pcd", "chamfer_original", "stroke_chamfer",
             "clustering_metrics", "stroke_masks_metrics"],
            ["strokewise_num_of_strokes_metrics"]]


@pytest.mark.parametrize("renorm", [None, {"active": True, "from": 800.0,
                                           "to": 1100.0}],
                         ids=["plain", "renormalized"])
@pytest.mark.parametrize("family", FAMILIES, ids=["chamfer+masks",
                                                  "strokewise"])
def test_metrics_match_jax(family, renorm):
    """Every ported metric on the same seeded inputs: chamfer metrics
    within 1e-6 relative, counts and clustering scores equal."""
    from maskplanner_tpu.metrics import MetricsHandler as JaxMetrics
    from maskplanner_tpu_torch.metrics import MetricsHandler

    cfg, jcfg = load_args(argv=[FLAGSHIP]), jax_load_args(argv=[FLAGSHIP])
    kw = _metric_inputs()
    ref = JaxMetrics(jcfg, family, renormalize_output_config=renorm
                     ).compute(**kw)
    port_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
    handler = MetricsHandler(cfg, family, renormalize_output_config=renorm)
    got = handler.compute(**port_kw)
    assert list(got) == list(ref) == handler.output_names()
    for name, want in ref.items():
        if "chamfer" in name:
            np.testing.assert_allclose(got[name], want, rtol=METRIC_RTOL,
                                       err_msg=name)
        else:
            assert got[name] == want, name


def test_renormalization_keeps_padding_rows():
    from maskplanner_tpu_torch.metrics import MetricsHandler

    handler = MetricsHandler(load_args(argv=[FLAGSHIP]), ["pcd"], {
        "active": True, "from": 2.0, "to": 1.0})
    traj = torch.tensor([[[1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
                          [-100.0] * 6]])
    out = handler._renorm_traj(traj)
    np.testing.assert_array_equal(out[0, 0], [2, 4, 6, 4, 5, 6])
    np.testing.assert_array_equal(out[0, 1], [-100.0] * 6)


@pytest.mark.parametrize("metric", ["sop_metrics", "sop_metrics_v2"])
def test_sop_metrics_raise_when_asked_for(metric):
    """Asked for beside ``pcd`` (once they raised, before
    ``postprocess/sop.py`` was ported), the SoP families give the JAX
    handler's values exactly, the port's inputs as tensors; asked for
    without their inputs, the handler raises."""
    from maskplanner_tpu.metrics import MetricsHandler as JaxMetricsHandler
    from maskplanner_tpu_torch.metrics import MetricsHandler
    from maskplanner_tpu_torch.postprocess.sop import \
        postprocess_sop_predictions

    rng = np.random.default_rng(12)
    sop_gt = np.full((3, 8, 24), -100.0, np.float32)
    for b, n in enumerate((2, 5, 8)):
        sop_gt[b, :n] = rng.normal(size=(n, 24))
    sop_pred = rng.normal(size=(3, 10, 24)).astype(np.float32)
    conf = rng.normal(size=(3, 10)).astype(np.float32)
    pcd = dict(y_pred=rng.normal(size=(3, 5, 24)).astype(np.float32),
               traj_as_pc=rng.normal(size=(3, 30, 6)).astype(np.float32))
    kw = dict(pcd, sop_pred=sop_pred, sop_gt=sop_gt,
              pred_sop_conf_scores=conf, sop_conf_threshold=0.5,
              processed_sop_pred=postprocess_sop_predictions(sop_pred, conf))
    want = JaxMetricsHandler(jax_load_args(argv=[FLAGSHIP]),
                             ["pcd", metric]).compute(**kw)
    handler = MetricsHandler(load_args(argv=[FLAGSHIP]), ["pcd", metric])
    got = handler.compute(**{k: torch.from_numpy(v)
                             if isinstance(v, np.ndarray) else v
                             for k, v in kw.items()})
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["point-wise chamfer distance"],
                               want["point-wise chamfer distance"],
                               rtol=METRIC_RTOL)
    for name in got:
        if name != "point-wise chamfer distance":
            assert got[name] == want[name], name
    with pytest.raises(ValueError, match="sop_gt"):
        handler.compute(**dict(kw, sop_gt=None))


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


def _eager_eval_step(model, handler, config):
    """``make_eval_step`` without ``jax.jit`` (see the module docstring)."""
    from maskplanner_tpu.train.trainer import build_loss_batch

    def eval_step(state, batch, weights, rng):
        out = model.apply({"params": state.params,
                           "batch_stats": state.batch_stats},
                          batch["point_cloud"], train=False)
        total, terms = handler.compute(
            weights, rng=rng, **build_loss_batch(out, batch, config))
        return total, terms, out

    return eval_step


def _eager_forward(model):
    """``make_forward`` without ``jax.jit``."""
    return lambda state, pc: model.apply(
        {"params": state.params, "batch_stats": state.batch_stats}, pc,
        train=False)


@pytest.fixture(scope="module")
def jax_state():
    """A JAX train state (Adam and all) of SMALL's model: eager Flax init
    is slow, so the tests share one and replace its variables."""
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train import create_train_state

    cfg = jax_load_args(argv=SMALL)
    return create_train_state(get_flax_model(cfg), cfg, jax.random.PRNGKey(0),
                              np.zeros((1, cfg["pc_points"], 3), np.float32))


@pytest.fixture(scope="module")
def loop_case(tmp_path_factory, jax_state):
    """Both eval loops on the same 3 test items (batches of 2 and 1) and the
    same converted weights, with dumps."""
    from maskplanner_tpu.data import DataLoader as JaxLoader
    from maskplanner_tpu.data import PaintDataset as JaxDataset
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu.metrics import MetricsHandler as JaxMetrics
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train.loop import evaluate as jax_evaluate
    from maskplanner_tpu_torch.convert import state_dict_from_flax
    from maskplanner_tpu_torch.data import DataLoader, PaintDataset
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.metrics import MetricsHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import forward
    from maskplanner_tpu_torch.train.loop import evaluate

    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    jcfg, cfg = jax_load_args(argv=SMALL), load_args(argv=SMALL)
    metrics = list(cfg["eval_metrics"])
    assert metrics == ["pcd", "stroke_masks_metrics"]
    jloader = JaxLoader(JaxDataset(jcfg, split="test", size=3), 2,
                        shuffle=False, drop_last=False)
    loader = DataLoader(PaintDataset(cfg, split="test", size=3), 2,
                        shuffle=False, drop_last=False)
    flax_model = get_flax_model(jcfg)
    variables = _perturbed({"params": jax_state.params,
                            "batch_stats": jax_state.batch_stats})
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in ("jax", "port")}

    handler = JaxLossHandler(jcfg["loss"], jcfg)
    ref = jax_evaluate(
        jax_state.replace(**variables), jloader,
        _eager_eval_step(flax_model, handler, jcfg), handler.init_weights(),
        JaxMetrics(jcfg, metrics), jax.random.PRNGKey(0), save=True,
        save_dir=dirs["jax"], forward=_eager_forward(flax_model))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    handler = LossHandler(cfg["loss"], cfg)
    got = evaluate(model, loader, handler, handler.init_weights(),
                   MetricsHandler(cfg, metrics), "cpu", save=True,
                   save_dir=dirs["port"], forward=forward)
    mp.undo()
    return ref, got, dirs


def test_eval_loop_matches_jax(loop_case):
    """Loss, terms and pcd within 1e-4 relative, the stroke counts equal,
    both latencies measured."""
    (loss, terms, metrics, ms), (g_loss, g_terms, g_metrics, g_ms), dirs = \
        loop_case
    np.testing.assert_allclose(g_loss, loss, rtol=LOOP_RTOL)
    assert list(g_terms) == list(terms)
    for k in terms:
        np.testing.assert_allclose(g_terms[k], terms[k], rtol=LOOP_RTOL)
    assert list(g_metrics) == list(metrics)
    np.testing.assert_allclose(g_metrics["point-wise chamfer distance"],
                               metrics["point-wise chamfer distance"],
                               rtol=LOOP_RTOL)
    for name in COUNT_NAMES:
        assert g_metrics[name] == metrics[name], name
    # the counts' equality means something only if no JAX confidence logit
    # sits at the decision threshold (sigmoid 0.5: logit 0)
    scores = np.concatenate([
        np.load(p, allow_pickle=True).item()["stroke_masks_scores"]
        for p in sorted(glob.glob(os.path.join(dirs["jax"], "*.npy")))])
    margin = float(np.abs(scores).min())
    assert margin > 1e-3, f"a JAX mask-score logit lies {margin} from 0"
    assert ms > 0 and g_ms > 0


def test_eval_dumps_match_jax(loop_case):
    """Every dump has the JAX dump's keys, dtypes and shapes, the same
    dirnames, inputs equal and outputs within 1e-4 · max|ref|; it loads as
    the JAX tools load it."""
    _, _, dirs = loop_case
    names = sorted(os.listdir(dirs["jax"]))
    assert names == ["last_test_batch0.npy", "last_test_batch1.npy"]
    assert sorted(os.listdir(dirs["port"])) == names
    for name in names:
        ref = np.load(os.path.join(dirs["jax"], name),
                      allow_pickle=True).item()
        got = np.load(os.path.join(dirs["port"], name),
                      allow_pickle=True).item()
        assert set(got) == set(ref) == DUMP_KEYS
        assert got["dirnames"] == ref["dirnames"]
        assert (got["batch"], got["suffix"]) == (ref["batch"], ref["suffix"])
        for key in DUMP_KEYS - {"dirnames", "batch", "suffix"}:
            a, b = got[key], ref[key]
            if b is None:
                assert a is None, key
                continue
            assert isinstance(a, np.ndarray), key
            assert (a.dtype, a.shape) == (b.dtype, b.shape), key
            if key in ("traj_pred", "pred_stroke_masks",
                       "stroke_masks_scores"):
                np.testing.assert_allclose(
                    a, b, rtol=0, atol=LOOP_RTOL * np.abs(b).max(),
                    err_msg=key)
            else:
                np.testing.assert_array_equal(a, b, err_msg=key)


# -- the driver's final eval and the eval CLI --------------------------------

DRIVER = [*SMALL, "device=cpu", "dataset_size=4", "test_dataset_size=2",
          "epochs=2", "no_save=false", "seed=4"]


@pytest.fixture(scope="module")
def driver_run(tmp_path_factory):
    from maskplanner_tpu_torch import train_maskplanner

    run_dir, _ = train_maskplanner.main(
        [*DRIVER, f"output_dir={tmp_path_factory.mktemp('runs')}"])
    with open(os.path.join(run_dir, "summary.json")) as fh:
        summary = json.load(fh)
    return run_dir, summary


def test_driver_final_eval_writes_the_jax_summary_and_dumps(driver_run):
    from maskplanner_tpu.metrics import MetricsHandler as JaxMetrics

    run_dir, summary = driver_run
    names = JaxMetrics(jax_load_args(argv=DRIVER),
                       ["pcd", "stroke_masks_metrics"]).output_names()
    want = set(SUMMARY_KEYS)
    for split in ("train", "test"):
        want |= {f"final_{split}_loss", f"{split}_inference_ms"}
        want |= {f"final_{split}_{n}" for n in names}
    assert set(summary) == want
    assert summary["last_eval_loss"] == summary["final_test_loss"]
    assert sorted(os.listdir(os.path.join(run_dir, "results"))) == [
        "last_test_batch0.npy", "last_train_batch0.npy"]
    with open(os.path.join(run_dir, "logs.jsonl")) as fh:
        logs = [json.loads(line) for line in fh]
    evals = [log for log in logs if "eval_loss" in log]
    assert evals and all(set(names) <= set(log) for log in evals)


def test_eval_cli_reproduces_the_final_eval(driver_run):
    from maskplanner_tpu_torch import test_maskplanner

    run_dir, summary = driver_run
    loss, terms, metrics = test_maskplanner.main(
        ["--run", run_dir, "--device", "cpu", "--save"])
    assert loss == summary["final_test_loss"]
    assert list(terms) == ["asymm_v6_chamfer_with_stroke_masks"]
    for name, v in metrics.items():
        assert v == summary[f"final_test_{name}"], name


@pytest.fixture(scope="module")
def jax_run(driver_run, jax_state, tmp_path_factory):
    """A copy of the port run with its last_checkpoint as a JAX (orbax)
    checkpoint of the same weights."""
    from maskplanner_tpu.train import checkpoints
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    run_dir, _ = driver_run
    dest = str(tmp_path_factory.mktemp("jax") / "run")
    shutil.copytree(run_dir, dest)
    blob = torch.load(os.path.join(run_dir, "last_checkpoint.torch.pt"),
                      weights_only=True)
    state = jax_state.replace(**flax_tree_from_state_dict(blob["model"]))
    checkpoints.save_checkpoint(dest, "last_checkpoint", state,
                                blob["epoch"])
    return dest


@pytest.mark.parametrize("extra", [
    [], ["--target", "cuboids-v2", "--renormalize_data_to_default"]],
    ids=["same-category", "transfer-renormalized"])
def test_eval_cli_matches_jax_cli(driver_run, jax_run, extra, monkeypatch):
    """The port CLI and root ``test_maskplanner.py`` on the same weights:
    loss and terms within 1e-4 relative, pcd within 1e-4, counts equal."""
    import test_maskplanner as jax_cli
    from maskplanner_tpu_torch import test_maskplanner

    run_dir, _ = driver_run
    monkeypatch.setattr(sys, "argv", ["test_maskplanner.py", "--run",
                                      jax_run, *extra])
    monkeypatch.setattr(jax_cli, "make_eval_step", _eager_eval_step)
    monkeypatch.setattr(jax_cli, "make_forward", _eager_forward)
    loss, terms, metrics = jax_cli.main()
    g_loss, g_terms, g_metrics = test_maskplanner.main(
        ["--run", run_dir, "--device", "cpu", *extra])
    np.testing.assert_allclose(g_loss, loss, rtol=LOOP_RTOL)
    for k in terms:
        np.testing.assert_allclose(g_terms[k], terms[k], rtol=LOOP_RTOL)
    assert list(g_metrics) == list(metrics)
    np.testing.assert_allclose(g_metrics["point-wise chamfer distance"],
                               metrics["point-wise chamfer distance"],
                               rtol=LOOP_RTOL)
    for name in COUNT_NAMES:
        assert g_metrics[name] == metrics[name], name
