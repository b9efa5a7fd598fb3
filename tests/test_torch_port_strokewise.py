"""The port's stroke-wise family against the JAX package's, on the CPU.

``PointNet2StrokeWise`` (eval outputs, train-mode BatchNorm statistics,
the weights both ways), the stroke losses through ``LossHandler`` (value
and gradient with respect to the predictions), the gradient of
``masked_mse_strokes_v2`` through the model, the dataset's
``load_extra_data`` items and the stroke-wise postprocess. The same seeded
numpy inputs go through both packages; the JAX distances take their
fixed-order form (``MASKPLANNER_DETERMINISTIC_NN``), which the port uses,
and the JAX steps run eagerly, as the port does.

Tolerances: model outputs within 1e-5 · max|ref|; BatchNorm statistics
within 1e-6 plus ``ROUNDING_FACTOR`` times the port's own float32 error on
the tensor (its float32 result against its float64 one), the step tests'
rule for Flax's E[x²] − E[x]² variance; a loss within 1e-5 relative, its
gradient within 1e-4 of the reference's norm (root of the summed squared
difference); numpy items and the postprocess bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
# the small data has 2-3 strokes of at most 60 poses (19 segments) a cloud
STROKES = ["max_n_strokes=6", "max_n_stroke_points=60",
           "out_points_per_stroke=60", "out_segments_per_stroke=19"]
SMALL = [FLAGSHIP, "pc_points=256", "model.hidden_size=[64,64]",
         "n_pred_traj_points=120", *STROKES,
         "model.backbone=pointnet2_strokewise"]
EXTRAS = ["load_extra_data=[stroke_prototypes,segments_per_stroke,"
          "history_of_segments_per_stroke_v2]", "substroke_points=4",
          "start_of_path_token_length=4"]
WEIGHTS = ["explicit_weight_masked_mse_loss=1.0",
           "explicit_weight_point_confidence_loss=0.5",
           "explicit_weight_stroke_confidence_loss=2.0",
           "explicit_no_stroke_weight=0.3",
           "explicit_weight_endofpath_confidence_loss=3.0"]
OUTDIM = 6
ROUNDING_FACTOR = 10


@pytest.fixture(scope="module")
def deterministic_nn():
    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    yield
    mp.undo()


def _perturbed(variables, seed=0):
    """Seeded non-zero biases, scales and running statistics, so that every
    tensor's conversion shows in the outputs."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1
                      ).astype(np.float32)
        if p[-1].key in ("bias", "scale", "mean") else
        (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
         if p[-1].key == "var" else np.asarray(a)), variables)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float64)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _batch(argv, split="test", n=2):
    from maskplanner_tpu_torch.data import PaintDataset, collate

    ds = PaintDataset(load_args(argv=argv), split=split, size=n)
    return collate([ds[i] for i in range(n)])


@pytest.fixture(scope="module")
def strokewise(deterministic_nn):
    """A perturbed Flax ``PointNet2StrokeWise`` at the shipped hybrid norm,
    its variables and two clouds of the small data."""
    from maskplanner_tpu.models import get_model as get_flax_model

    model = get_flax_model(jax_load_args(argv=SMALL))
    batch = _batch([*SMALL, *EXTRAS])
    pc = batch["point_cloud"]
    variables = _perturbed(model.init(jax.random.PRNGKey(0),
                                      jnp.asarray(pc), train=False))
    return model, variables, batch


def _port_model(variables, argv=SMALL, dropout=0.3):
    from maskplanner_tpu_torch.convert import state_dict_from_flax
    from maskplanner_tpu_torch.models import get_model

    model = get_model(load_args(argv=argv), device="cpu", dropout=dropout)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def test_strokewise_eval_outputs_match_jax(strokewise):
    from maskplanner_tpu_torch.models import PointNet2StrokeWise

    model, variables, batch = strokewise
    pc = batch["point_cloud"]
    ref = model.apply(variables, jnp.asarray(pc), train=False)
    port = _port_model(variables)
    assert type(port) is PointNet2StrokeWise
    with torch.no_grad():
        got = port(torch.from_numpy(pc))
    assert len(got) == 3
    shapes = [(2, 6, 60 * OUTDIM), (2, 6, 60), (2, 6)]
    for a, b, shape in zip(ref, got, shapes):
        a = np.asarray(a)
        assert b.shape == a.shape == shape
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-5 * np.abs(a).max())
    names = {k.split(".")[0] for k in port.state_dict()}
    assert names == {"sa1", "sa2", "sa3", "fc1", "bn1", "fc2", "bn2", "fc3",
                     "fc_normals", "point_conf_out", "stroke_conf_out"}


def test_strokewise_weights_convert_both_ways(strokewise):
    from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                               state_dict_from_flax)

    _, variables, _ = strokewise
    back = flax_tree_from_state_dict(state_dict_from_flax(variables))
    want, got = _leaves(variables), _leaves(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _train_forward(model_or_variables, pc, dtype):
    """The port's train forward (dropout off, FPS from index 0) in
    ``dtype`` -> (outputs, BatchNorm statistics as a Flax tree)."""
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    port = _port_model(model_or_variables, dropout=0.0).to(dtype).train()
    with torch.no_grad():
        out = port(torch.from_numpy(pc).to(dtype))
    stats = flax_tree_from_state_dict(port.state_dict())["batch_stats"]
    return [t.double().numpy() for t in out], stats


def test_strokewise_train_forward_and_batch_stats_match_jax(strokewise):
    """Train mode: the outputs within 1e-5 · max|ref| and the moved running
    statistics within 1e-6, each plus ROUNDING_FACTOR times the port's
    float32 error on the tensor."""
    import flax.linen as fnn

    model, variables, batch = strokewise
    pc = batch["point_cloud"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        ref, mutated = model.apply(variables, jnp.asarray(pc), train=True,
                                   mutable=["batch_stats"])
    out, stats = _train_forward(variables, pc, torch.float32)
    out64, stats64 = _train_forward(variables, pc, torch.float64)
    for a, b, exact in zip(ref, out, out64):
        a = np.asarray(a)
        np.testing.assert_allclose(
            b, a, rtol=0, atol=1e-5 * np.abs(a).max()
            + ROUNDING_FACTOR * np.abs(b - exact).max())
    want = _leaves(mutated["batch_stats"])
    got, exact = _leaves(stats), _leaves(stats64)
    assert got.keys() == want.keys() and len(want) == 10
    for key, b in want.items():
        np.testing.assert_allclose(
            got[key], b, rtol=0, atol=1e-6 + ROUNDING_FACTOR
            * np.abs(got[key] - exact[key]).max(), err_msg=key)


# ---------------------------------------------------------------- losses

def _stroke_data():
    """Batches of the small data with every extra, and predictions near
    the GT (random where the GT is padding): per loss name, its batch
    keys, and which of them are predictions."""
    b = _batch([*SMALL, *EXTRAS])
    rng = np.random.default_rng(7)

    def near(gt, scale=0.05):
        return np.where(gt == -100.0, rng.normal(size=gt.shape),
                        gt + rng.normal(size=gt.shape) * scale
                        ).astype(np.float32)

    valid = b["stroke_valid"]
    segs = b["segments_per_stroke"][valid]                  # (K, 19, 24)
    pts = b["points_per_stroke"][valid]                     # (K, 60, 6)
    K, N = pts.shape[:2]
    B, M = valid.shape
    hist_tgt = b["strokewise_target_batch"].reshape(-1, 24)
    eop = b["strokewise_end_of_path_batch"].reshape(-1)
    out_mask = ~np.all(pts == -100.0, axis=-1)
    pps = b["points_per_stroke"].reshape(B, M, -1)          # (B, 6, 360)
    return {
        "chamfer_strokes": dict(
            stacked_segments_per_stroke_pred=near(segs),
            stacked_segments_per_stroke_gt=segs),
        "asymm_v6_chamfer_strokes": dict(
            stacked_segments_per_stroke_pred=near(segs),
            stacked_segments_per_stroke_gt=segs,
            stacked_segments_per_stroke_gt_mask=~np.all(
                segs == -100.0, axis=-1)),
        "mse_strokes": dict(stacked_strokes_pred=near(pts.reshape(K, -1)),
                            stacked_strokes_gt=pts.reshape(K, -1)),
        "mse_nexttoken": dict(stacked_pred_nexttoken=near(hist_tgt),
                              stacked_gt_nexttoken=hist_tgt),
        "mse_nexttoken_v2": dict(
            stacked_pred_nexttoken=near(hist_tgt),
            stacked_gt_nexttoken=hist_tgt,
            end_of_path_scores=rng.normal(size=eop.shape).astype(np.float32),
            end_of_path_gt=eop),
        "masked_mse_strokes": dict(
            stacked_points_per_stroke_pred=near(np.concatenate(
                [pts, np.zeros((K, 4, OUTDIM), np.float32)], axis=1)),
            stacked_points_per_stroke_gt=pts,
            confidence_scores=rng.normal(size=(K, N + 4, 1)).astype(
                np.float32)),
        "masked_mse_strokes_from_segments": dict(
            stacked_points_per_stroke_pred=near(np.where(
                pts == -100.0, 0.0, pts)),
            stacked_points_per_stroke_gt=np.where(
                pts == -100.0, 0.0, pts).astype(np.float32),
            confidence_scores=rng.uniform(0.01, 0.99, (K, N, 1)).astype(
                np.float32),
            output_mask=out_mask),
        # 6 predicted strokes against the 6 GT columns, 3-4 of them padding
        "masked_mse_strokes_v2": dict(
            pred_points_per_stroke=near(pps[:, ::-1].copy(), 0.3),
            points_per_stroke=pps,
            pred_point_scores=rng.normal(size=(B, M, 60)).astype(np.float32),
            pred_stroke_scores=rng.normal(size=(B, M)).astype(np.float32),
            gt_stroke_mask=valid),
    }


PRED_KEYS = {
    "chamfer_strokes": ["stacked_segments_per_stroke_pred"],
    "asymm_v6_chamfer_strokes": ["stacked_segments_per_stroke_pred"],
    "mse_strokes": ["stacked_strokes_pred"],
    "mse_nexttoken": ["stacked_pred_nexttoken"],
    "mse_nexttoken_v2": ["stacked_pred_nexttoken", "end_of_path_scores"],
    "masked_mse_strokes": ["stacked_points_per_stroke_pred",
                           "confidence_scores"],
    "masked_mse_strokes_from_segments": ["stacked_points_per_stroke_pred",
                                         "confidence_scores"],
    "masked_mse_strokes_v2": ["pred_points_per_stroke", "pred_point_scores",
                              "pred_stroke_scores"],
}
# the names the JAX handler takes at lambda_points > 1; the others need a
# λ=1 configuration (the handler's check only: the data stay the same)
LAMBDA_GT_1 = ("chamfer_strokes", "mse_nexttoken", "mse_nexttoken_v2")


@pytest.fixture(scope="module")
def stroke_data(deterministic_nn):
    return _stroke_data()


def _handler_argv(name):
    lam = [] if name in LAMBDA_GT_1 else ["lambda_points=1", "overlapping=0"]
    return [*SMALL, *WEIGHTS, f"weight_{name}=0.7", *lam]


def handler_both(name, batch, pred_keys):
    """(JAX loss, JAX gradients, port loss, port gradients) of the term
    ``name`` through each package's ``LossHandler``, the gradients with
    respect to ``pred_keys``."""
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu_torch.losses import LossHandler

    argv = _handler_argv(name)
    jh = JaxLossHandler([name], jax_load_args(argv=argv))
    jw = jh.init_weights()
    fixed = {k: jnp.asarray(v) for k, v in batch.items()
             if k not in pred_keys}

    def jax_loss(preds):
        total, terms = jh.compute(jw, rng=None, **fixed, **preds)
        return total

    ref, ref_g = jax.value_and_grad(jax_loss)(
        {k: jnp.asarray(batch[k]) for k in pred_keys})

    h = LossHandler([name], load_args(argv=argv))
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    for k in pred_keys:
        tb[k].requires_grad_(True)
    total, terms = h.compute(h.init_weights(), **tb)
    assert list(terms) == [name]
    total.backward()
    return (float(ref), {k: np.asarray(v) for k, v in ref_g.items()},
            total.item(), {k: tb[k].grad.numpy() for k in pred_keys})


def _assert_loss_and_gradient(ref, ref_g, got, got_g):
    assert np.isfinite(ref) and ref != 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    for k, want in ref_g.items():
        norm = np.sqrt((want.astype(np.float64) ** 2).sum())
        assert norm > 0, k
        err = np.sqrt(((got_g[k] - want).astype(np.float64) ** 2).sum())
        assert err <= 1e-4 * norm, (k, err, norm)


@pytest.mark.parametrize("name", sorted(PRED_KEYS))
def test_stroke_loss_and_its_gradient_match_jax(name, stroke_data):
    """Through each package's handler: the weighted term within 1e-5
    relative, its gradient with respect to each prediction input within
    1e-4 of the reference gradient's norm."""
    _assert_loss_and_gradient(*handler_both(name, stroke_data[name],
                                            PRED_KEYS[name]))


@pytest.mark.parametrize("case", ["fewer_gt_columns", "all_columns_real"])
def test_masked_mse_strokes_v2_with_more_predictions(case, stroke_data):
    """6 predicted strokes against fewer GT columns (4, two of them
    padding), and against GT columns that are all real (the matched cost,
    not the indices, decides: the LAP totals agree)."""
    from maskplanner_tpu.ops.hungarian import hungarian_cost
    from maskplanner_tpu_torch.ops.hungarian import hungarian

    d = dict(stroke_data["masked_mse_strokes_v2"])
    if case == "fewer_gt_columns":
        d["points_per_stroke"] = d["points_per_stroke"][:, :4].copy()
        d["gt_stroke_mask"] = d["gt_stroke_mask"][:, :4].copy()
    else:
        d["gt_stroke_mask"] = np.ones_like(d["gt_stroke_mask"])
        d["points_per_stroke"] = np.where(
            d["points_per_stroke"] == -100.0, 0.25,
            d["points_per_stroke"]).astype(np.float32)
    _assert_loss_and_gradient(*handler_both(
        "masked_mse_strokes_v2", d, PRED_KEYS["masked_mse_strokes_v2"]))
    rng = np.random.default_rng(3)
    cost = rng.uniform(size=(2, 6, d["gt_stroke_mask"].shape[1])).astype(
        np.float32)
    want = np.asarray(hungarian_cost(jnp.asarray(cost),
                                     jnp.asarray(d["gt_stroke_mask"])))
    row4col, matched = hungarian(torch.from_numpy(cost),
                                 torch.from_numpy(d["gt_stroke_mask"]))
    got = torch.where(matched, torch.take_along_dim(
        torch.from_numpy(cost).transpose(1, 2), row4col[..., None],
        dim=-1)[..., 0], 0.0).sum(-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_masked_mse_strokes_v2_with_fewer_predictions_than_columns(
        stroke_data):
    """4 predicted strokes against 6 GT columns, at most 4 of them real:
    the LAP pads the problem with fake rows, which only padded columns
    take; loss and gradients as the JAX handler's."""
    d = dict(stroke_data["masked_mse_strokes_v2"])
    assert d["gt_stroke_mask"].sum(1).max() <= 4
    for k in PRED_KEYS["masked_mse_strokes_v2"]:
        d[k] = d[k][:, :4].copy()
    _assert_loss_and_gradient(*handler_both(
        "masked_mse_strokes_v2", d, PRED_KEYS["masked_mse_strokes_v2"]))


def test_masked_mse_strokes_v2_gradient_through_the_model(strokewise):
    """The gradient of ``masked_mse_strokes_v2`` through
    ``PointNet2StrokeWise`` in train mode (dropout off) against
    ``jax.value_and_grad`` of the same function: the loss within 1e-5
    relative and each parameter gradient within 5e-4 · max|ref|, each plus
    ROUNDING_FACTOR times the port's float32 error on it, the step tests'
    rule: at random init the train forward (BatchNorm over a batch of 2)
    amplifies rounding, the port's float32 outputs lie 1.5e-3 · max|out|
    from its float64 ones, and the JAX outputs as far."""
    import flax.linen as fnn

    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict
    from maskplanner_tpu_torch.losses import LossHandler

    model, variables, batch = strokewise
    B, M = batch["stroke_valid"].shape
    gt = dict(points_per_stroke=batch["points_per_stroke"].reshape(B, M, -1),
              gt_stroke_mask=batch["stroke_valid"])
    name = "masked_mse_strokes_v2"
    argv = _handler_argv(name)
    jh = JaxLossHandler([name], jax_load_args(argv=argv))
    jw = jh.init_weights()

    def jax_loss(params):
        (strokes, point_conf, stroke_conf), _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(batch["point_cloud"]), train=True,
            mutable=["batch_stats"])
        return jh.compute(jw, rng=None, pred_points_per_stroke=strokes,
                          pred_point_scores=point_conf,
                          pred_stroke_scores=stroke_conf,
                          **{k: jnp.asarray(v) for k, v in gt.items()})[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        ref, ref_g = jax.value_and_grad(jax_loss)(variables["params"])

    def port(dtype):
        net = _port_model(variables, dropout=0.0).to(dtype).train()
        h = LossHandler([name], load_args(argv=argv))
        strokes, point_conf, stroke_conf = net(
            torch.from_numpy(batch["point_cloud"]).to(dtype))
        loss = h.compute(
            h.init_weights(), pred_points_per_stroke=strokes,
            pred_point_scores=point_conf, pred_stroke_scores=stroke_conf,
            points_per_stroke=torch.from_numpy(gt["points_per_stroke"]).to(
                dtype),
            gt_stroke_mask=torch.from_numpy(gt["gt_stroke_mask"]))[0]
        loss.backward()
        return float(loss), _leaves(flax_tree_from_state_dict(
            {n: p.grad for n, p in net.named_parameters()})["params"])

    loss, grads = port(torch.float32)
    loss64, grads64 = port(torch.float64)
    np.testing.assert_allclose(loss, float(ref), rtol=0,
                               atol=1e-5 * abs(float(ref))
                               + ROUNDING_FACTOR * abs(loss - loss64))
    want = _leaves(ref_g)
    assert grads.keys() == want.keys()
    for key, b in want.items():
        own = np.abs(grads[key] - grads64[key]).max()
        np.testing.assert_allclose(
            grads[key], b, rtol=0, atol=5e-4 * np.abs(b).max()
            + ROUNDING_FACTOR * own, err_msg=key)


# ------------------------------------------------------ extras and items

@pytest.mark.parametrize("split,extra", [
    ("test", []),
    ("train", ["augmentations=[general_noise]", "sample_substroke_v2=true",
               "trasl_noise_stdev=0.02"]),
    ("test", ["stroke_prototype_kind=3d_bboxes",
              "load_extra_data=[stroke_prototypes]"]),
], ids=["every-extra", "noisy-histories", "bbox-prototypes"])
def test_dataset_items_with_extras_match_jax(split, extra):
    """Every ``load_extra_data`` item, the noisy teacher-forcing histories
    (drawn from ``default_rng(index)``) and the box prototypes, bit for
    bit."""
    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu_torch.data import PaintDataset

    argv = [*SMALL, *EXTRAS, *extra]
    ref_ds = JaxPaintDataset(jax_load_args(argv=argv), split=split, size=3)
    ds = PaintDataset(load_args(argv=argv), split=split, size=3)
    for i in range(3):
        a, b = ds[i], ref_ds[i]
        assert sorted(a) == sorted(b)
        assert "stroke_prototypes" in a
        for key in a:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_extras_functions_match_jax():
    """The per-stroke split and padding, both prototype kinds (a short
    stroke repeats its first half), the two history builders and the
    history noise, bit for bit on seeded strokes."""
    from maskplanner_tpu.data import extras as jax_extras
    from maskplanner_tpu_torch.data import extras

    rng = np.random.default_rng(11)
    traj = rng.normal(size=(40, OUTDIM)).astype(np.float32)
    ids = np.repeat([0, 1, -1, 2], [12, 15, 3, 10])
    mod_a, mod_b = extras, jax_extras
    a, oa = mod_a.get_vectors_per_stroke(traj, ids)
    b, ob = mod_b.get_vectors_per_stroke(traj, ids)
    np.testing.assert_array_equal(oa, ob)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for max_len in (None, 11):
        for x, y in zip(mod_a.pad_vectors_per_stroke(a, 5, max_len),
                        mod_b.pad_vectors_per_stroke(b, 5, max_len)):
            np.testing.assert_array_equal(x, y)
    for kind in ("3d_bboxes", "start_of_path_token"):
        pa, _ = mod_a.get_stroke_prototypes(traj, ids, kind, OUTDIM)
        pb, _ = mod_b.get_stroke_prototypes(traj, ids, kind, OUTDIM)
        np.testing.assert_array_equal(mod_a.pad_prototypes(pa, 5),
                                      mod_b.pad_prototypes(pb, 5))
    short = traj[:3]
    np.testing.assert_array_equal(
        mod_a.stroke_encoding(short, "start_of_path_token", OUTDIM, 4),
        mod_b.stroke_encoding(short, "start_of_path_token", OUTDIM, 4))
    ha = mod_a.history_batches_v1(a, 4, np.random.default_rng(2))
    hb = mod_b.history_batches_v1(b, 4, np.random.default_rng(2))
    for x, y in zip(ha[0] + ha[1], hb[0] + hb[1]):
        np.testing.assert_array_equal(x, y)
    va = mod_a.history_batches_v2(a, oa, 3)
    vb = mod_b.history_batches_v2(b, ob, 3)
    for x, y in zip(va, vb):
        np.testing.assert_array_equal(x, y)
    hist = va[0].reshape(-1, 3, OUTDIM)
    np.testing.assert_array_equal(
        mod_a.add_history_noise(hist, 1, OUTDIM, 0.01, 0.02, 1.0,
                                np.random.default_rng(5)),
        mod_b.add_history_noise(hist, 1, OUTDIM, 0.01, 0.02, 1.0,
                                np.random.default_rng(5)))


# ------------------------------------------------------------ postprocess

def test_strokewise_postprocess_matches_jax():
    """Confident strokes kept and cut at their first unconfident point (a
    stroke confident throughout kept whole), the flat points with their
    stroke ids, and the unpadded rows, bit for bit."""
    from maskplanner_tpu.postprocess import strokewise as jax_sw
    from maskplanner_tpu_torch.postprocess import strokewise as sw

    cfg = load_args(argv=SMALL)
    rng = np.random.default_rng(5)
    strokes = rng.normal(size=(3, 6, 60 * OUTDIM)).astype(np.float32)
    point_scores = rng.normal(size=(3, 6, 60)).astype(np.float32) + 2.0
    point_scores[0, :2] = 5.0                     # confident throughout
    stroke_scores = rng.normal(size=(3, 6)).astype(np.float32)
    for kwargs in ({}, dict(stroke_conf_threshold=0.3,
                            point_conf_threshold=0.8)):
        got = sw.postprocess_strokewise_predictions_into_strokes(
            strokes, point_scores, stroke_scores, cfg, **kwargs)
        want = jax_sw.postprocess_strokewise_predictions_into_strokes(
            strokes, point_scores, stroke_scores, cfg, **kwargs)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        rows = np.concatenate(got)
        for flags in ((True, True), (False, True), (True, False)):
            a = sw.from_strokewise_to_pointwise(rows, cfg, *flags)
            b = jax_sw.from_strokewise_to_pointwise(rows, cfg, *flags)
            for x, y in zip(a if flags[0] else [a], b if flags[0] else [b]):
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            sw.remove_padding_from_tensors(rows.reshape(-1, OUTDIM)),
            jax_sw.remove_padding_from_tensors(rows.reshape(-1, OUTDIM)))
