"""The port's start-of-path family against the JAX package's, on the CPU.

``PointNet2SoPs`` (with and without its confidences), ``pointnet2_3dbbox``
(always a BatchNorm encoder), the rollout head ``MLPRegressor`` and the
rollout itself, ``PointTransformer`` (teacher forcing and autoregressive
decoding), the IO sizes of every task, the ``hungarian_SoPs`` loss, the
SoP postprocess and metrics, and the beam search. The same seeded numpy
inputs go through both packages, with the JAX weights converted by
``convert.py``; the JAX distances take their fixed-order form
(``MASKPLANNER_DETERMINISTIC_NN``).

Tolerances: model outputs and the rollout within 1e-5 · max|ref|;
BatchNorm statistics within 1e-6 plus ``ROUNDING_FACTOR`` times the port's
own float32 error (the step tests' rule); the loss within 1e-5 relative,
its gradient within 1e-4 of the reference's norm; numpy functions and the
metrics exactly.
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
SMALL = [FLAGSHIP, "pc_points=256", "model.hidden_size=[64,64]",
         "n_pred_traj_points=120", "max_n_strokes=6",
         "start_of_path_token_length=4", "out_prototypes=12",
         "load_extra_data=[stroke_prototypes]"]
# the rollout head of the next-token recipe with its end-of-path logit
ROLLOUT = [*SMALL, "model.backbone=mlp_rollout", "stroke_prototype_dim=24",
           "rollout_loss=[mse_nexttoken_v2]", "substroke_points=4",
           "end_of_path_confidence=true"]
SOP_WEIGHTS = ["explicit_no_sop_weight=0.2",
               "explicit_weight_sop_confidence_loss=3.0",
               "weight_hungarian_SoPs=0.5"]
OUTDIM = 6
ROUNDING_FACTOR = 10
JAX_ROUNDING_FACTOR = 3


@pytest.fixture(scope="module")
def deterministic_nn():
    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    yield
    mp.undo()


def _perturbed(variables, seed=0):
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


def _port_model(variables, argv, dropout=0.3):
    from maskplanner_tpu_torch.convert import state_dict_from_flax
    from maskplanner_tpu_torch.models import get_model

    model = get_model(load_args(argv=argv), device="cpu", dropout=dropout)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def _flax(argv, *example, seed=0):
    from maskplanner_tpu.models import get_model as get_flax_model

    model = get_flax_model(jax_load_args(argv=argv))
    variables = _perturbed(model.init(jax.random.PRNGKey(seed),
                                      *map(jnp.asarray, example)), seed)
    return model, variables


def _assert_round_trip(variables):
    from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                               state_dict_from_flax)

    back = flax_tree_from_state_dict(state_dict_from_flax(variables))
    want, got = _leaves(variables), _leaves(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


MODEL_CASES = {
    # backbone, extra args, points
    "sops-conf": ("pointnet2_sops", ["sop_confidence_scores=true"], 256),
    "sops": ("pointnet2_sops", [], 256),
    "3dbbox": ("pointnet2_3dbbox", ["model.norm=layer"], 1024),
}


def _clouds(argv, n=2):
    """The small data's point clouds. On gaussian blobs sa1's balls hold
    few points, the grouped rows repeat, and the JAX float32 BatchNorm
    (E[x²] − E[x]² from in-order sums) lands 10x its own reordering
    spread from the float64 value; on the windows' surfaces it does not."""
    from maskplanner_tpu_torch.data import PaintDataset, collate

    ds = PaintDataset(load_args(argv=argv), split="test", size=n)
    return collate([ds[i] for i in range(n)])["point_cloud"]


@pytest.fixture(scope="module", params=sorted(MODEL_CASES))
def sop_model(request, deterministic_nn):
    backbone, extra, points = MODEL_CASES[request.param]
    argv = [*SMALL, f"pc_points={points}", f"model.backbone={backbone}",
            *extra]
    pc = _clouds(argv)
    model, variables = _flax(argv, pc, seed=1)
    return request.param, argv, model, variables, pc


def test_sop_models_match_jax(sop_model):
    """The eval tokens (and confidences) within 1e-5 · max|ref|; without
    ``sop_confidence_scores`` both give None beside the tokens; the
    3D-box model keeps its BatchNorm encoder under ``model.norm=layer``
    (the JAX factory passes no norm) and gives 6-value boxes."""
    from maskplanner_tpu_torch.models import PointNet2SoPs

    case, argv, model, variables, pc = sop_model
    ref = model.apply(variables, jnp.asarray(pc), train=False)
    port = _port_model(variables, argv)
    assert type(port) is PointNet2SoPs
    with torch.no_grad():
        got = port(torch.from_numpy(pc))
    assert len(got) == 2
    tokens = {"3dbbox": 6}.get(case, 4 * OUTDIM)
    assert got[0].shape == (2, 12, tokens)
    _close(got[0], ref[0])
    if case == "sops-conf":
        _close(got[1], ref[1])
    else:
        assert ref[1] is None and got[1] is None
    if case == "3dbbox":
        assert {k.split(".")[1] for k in port.state_dict()
                if k.startswith("sa")} == {"mlp_convs", "mlp_bns"}
    _assert_round_trip(variables)


def test_sop_models_train_batch_stats_match_jax(sop_model):
    """Train mode (dropout off, FPS from index 0): the outputs within
    1e-5 · max|ref| and the moved running statistics within 1e-6, each
    plus ROUNDING_FACTOR times the port's float32 error and
    JAX_ROUNDING_FACTOR times the JAX forward's own, sampled by the same
    forward on the batch in reverse order: the step test's rule (the
    3D-box model's BatchNorms take their moments over 2 x 512 x 32 rows
    at sa1)."""
    import flax.linen as fnn

    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    case, argv, model, variables, pc = sop_model
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        ref, mutated = model.apply(variables, jnp.asarray(pc), train=True,
                                   mutable=["batch_stats"])
        rev, rev_mutated = model.apply(variables, jnp.asarray(pc[::-1]),
                                       train=True, mutable=["batch_stats"])
    jax_own = {k: np.abs(a - b).max() for (k, a), b in zip(
        _leaves(mutated["batch_stats"]).items(),
        _leaves(rev_mutated["batch_stats"]).values())}

    def port(dtype):
        net = _port_model(variables, argv, dropout=0.0).to(dtype).train()
        with torch.no_grad():
            out = net(torch.from_numpy(pc).to(dtype))
        return ([None if t is None else t.double().numpy() for t in out],
                _leaves(flax_tree_from_state_dict(
                    net.state_dict())["batch_stats"]))

    (out, stats), (out64, stats64) = port(torch.float32), port(torch.float64)
    for a, b, exact, r in zip(ref, out, out64, rev):
        if a is None:
            assert b is None
            continue
        a = np.asarray(a)
        np.testing.assert_allclose(
            b, a, rtol=0, atol=1e-5 * np.abs(a).max()
            + ROUNDING_FACTOR * np.abs(b - exact).max()
            + JAX_ROUNDING_FACTOR * np.abs(a - np.asarray(r)[::-1]).max())
    want = _leaves(mutated["batch_stats"])
    assert stats.keys() == want.keys() and want
    for key, b in want.items():
        np.testing.assert_allclose(
            stats[key], b, rtol=0, atol=1e-6 + ROUNDING_FACTOR
            * np.abs(stats[key] - stats64[key]).max()
            + JAX_ROUNDING_FACTOR * jax_own[key], err_msg=key)


# ------------------------------------------------------------- IO sizes

@pytest.mark.parametrize("io_type,extra", [
    ("MaskPlanner", []), ("paintnet", []),
    ("StrokeWise", ["max_n_stroke_points=60"]),
    ("multipathregression", ["stroke_points=30", "n_strokes=5"]),
    ("ODv1_strokeProposal", []),
    ("ODv1_strokeRollout", ["rollout_loss=[mse_strokes]",
                            "stroke_points=30"]),
    ("ODv1_strokeRollout", ["rollout_loss=[chamfer_strokes]",
                            "out_segments_per_stroke=19",
                            "rollout_model.object_features=true"]),
    ("ODv1_strokeRollout", ["rollout_loss=[masked_mse_strokes]",
                            "out_points_per_stroke=60"]),
    ("ODv1_strokeRollout", ["rollout_loss=[masked_mse_strokes_from_segments]",
                            "out_points_per_stroke=60"]),
    ("ODv1_strokeRollout", ["rollout_loss=[mse_nexttoken]",
                            "substroke_points=4"]),
    ("ODv1_strokeRollout", ["rollout_loss=[mse_nexttoken_v2]",
                            "substroke_points=4",
                            "end_of_path_confidence=true"]),
])
def test_io_sizes_match_jax(io_type, extra):
    from maskplanner_tpu.models import get_io_info as jax_io
    from maskplanner_tpu_torch.models import get_io_info

    argv = [*SMALL, "stroke_prototype_dim=24", *extra]
    assert get_io_info(io_type, load_args(argv=argv)) == \
        jax_io(io_type, jax_load_args(argv=argv))


def test_unknown_rollout_loss_and_clustering_io_raise():
    """An unknown rollout loss raises; the clustering io (the segmenters',
    no longer raising) answers as the JAX package's."""
    from maskplanner_tpu.models import get_io_info as jax_io
    from maskplanner_tpu_torch.models import get_io_info

    cfg = load_args(argv=[*SMALL, "stroke_prototype_dim=24",
                          "rollout_loss=[chamfer]"])
    with pytest.raises(ValueError, match="rollout_loss"):
        get_io_info("ODv1_strokeRollout", cfg)
    # the segmenters' λ-segments: outdim · λ values
    assert get_io_info("ContrastiveClustering", cfg) == {
        "inputdim": jax_io("ContrastiveClustering",
                           jax_load_args(argv=[*SMALL]))["inputdim"]}


# ------------------------------------------------- rollout head, rollout

@pytest.fixture(scope="module")
def rollout_head():
    from maskplanner_tpu_torch.models import get_io_info

    info = get_io_info("ODv1_strokeRollout", load_args(argv=ROLLOUT))
    x = np.random.default_rng(3).normal(
        size=(8, info["input_size"])).astype(np.float32)
    model, variables = _flax(ROLLOUT, x, seed=2)
    return info, model, variables, x


def test_rollout_head_matches_jax(rollout_head):
    """Eval (also with relative translations) and train mode with its
    BatchNorm statistics; the weights both ways."""
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict
    from maskplanner_tpu_torch.models import MLPRegressor

    info, model, variables, x = rollout_head
    assert info["input_size"] == 24 + 4 * 24 and info["out_vectors"] == 1
    port = _port_model(variables, ROLLOUT)
    assert type(port) is MLPRegressor
    for relative in (False, True):
        ref = model.apply(variables, jnp.asarray(x), relative_pred=relative)
        with torch.no_grad():
            got = port(torch.from_numpy(x), relative_pred=relative)
        assert got[0].shape == (8, 1, 24) and got[1].shape == (8, 1, 1)
        for a, b in zip(ref, got):
            _close(b, a)
    ref, mutated = model.apply(variables, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
    port.train()
    got = port(torch.from_numpy(x))
    for a, b in zip(ref, got):
        _close(b, a)
    want = _leaves(mutated["batch_stats"])
    stats = _leaves(flax_tree_from_state_dict(
        port.state_dict())["batch_stats"])
    assert stats.keys() == want.keys() and len(want) == 4
    for key, b in want.items():
        np.testing.assert_allclose(stats[key], b, rtol=0, atol=1e-6,
                                   err_msg=key)
    _assert_round_trip(variables)


@pytest.mark.parametrize("object_features", [False, True])
def test_rollout_matches_jax(object_features):
    """``sample_autoregressive_inference_sop`` on a converted head, 6
    start-of-path tokens, 4-step histories, 9 steps, with and without the
    object features appended: paths and end-of-path logits within
    1e-5 · max|ref|."""
    from maskplanner_tpu.train.rollout import \
        sample_autoregressive_inference_sop as jax_rollout
    from maskplanner_tpu_torch.models import get_io_info
    from maskplanner_tpu_torch.train.rollout import \
        sample_autoregressive_inference_sop

    argv = ROLLOUT + (["rollout_model.object_features=true"]
                      if object_features else [])
    info = get_io_info("ODv1_strokeRollout", load_args(argv=argv))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, info["input_size"])).astype(np.float32)
    model, variables = _flax(argv, x, seed=5)
    sops = rng.normal(size=(6, 24)).astype(np.float32)
    obj = (rng.normal(size=(1024,)).astype(np.float32)
           if object_features else None)
    ref = jax_rollout(model.apply, variables, jnp.asarray(sops), 4, 24, 9,
                      None if obj is None else jnp.asarray(obj))
    port = _port_model(variables, argv)
    got = sample_autoregressive_inference_sop(
        port, torch.from_numpy(sops), 4, 24, 9,
        None if obj is None else torch.from_numpy(obj))
    assert got[0].shape == (6, 9, 24) and got[1].shape == (6, 9, 1)
    for a, b in zip(ref, got):
        _close(b, a)
    with pytest.raises(ValueError, match="eval mode"):
        sample_autoregressive_inference_sop(port.train(),
                                            torch.from_numpy(sops), 4, 24, 9)


# ------------------------------------------------------ point transformer

def test_point_transformer_matches_jax():
    """Teacher forcing and the autoregressive decoding over
    ``max_seq_len`` steps, each within 1e-5 · max|ref|; the attention
    kernels convert both ways."""
    from maskplanner_tpu_torch.models import PointTransformer

    argv = [*SMALL, "model.backbone=point_transformer", "max_seq_len=8"]
    rng = np.random.default_rng(6)
    src = rng.normal(size=(2, 11, 24)).astype(np.float32)
    tgt = rng.normal(size=(2, 5, 24)).astype(np.float32)
    model, variables = _flax(argv, src, tgt, seed=3)
    port = _port_model(variables, argv)
    assert type(port) is PointTransformer
    for inputs, length in (((src, tgt), 6), ((src,), 8)):
        ref = model.apply(variables, *map(jnp.asarray, inputs))
        with torch.no_grad():
            got = port(*map(torch.from_numpy, inputs))
        assert got[0].shape == (2, length, 24)
        assert got[1].shape == (2, length, 1)
        for a, b in zip(ref, got):
            _close(b, a)
    _assert_round_trip(variables)


# ------------------------------------------------------------ the loss

def _sop_batch(n_pred=12):
    """Start-of-path GT tokens of the small data (6 columns, 2-3 of them
    real and first, the rest −100) and ``n_pred`` predictions, those of
    the real tokens near them."""
    from maskplanner_tpu_torch.data import PaintDataset, collate

    ds = PaintDataset(load_args(argv=SMALL), split="test", size=2)
    gt = collate([ds[i] for i in range(2)])["stroke_prototypes"]
    rng = np.random.default_rng(8)
    pred = rng.normal(size=(2, n_pred, gt.shape[-1])).astype(np.float32)
    real = gt != -100.0
    k = min(n_pred, gt.shape[1])
    assert not real[:, k:].any()
    pred[:, :k] = np.where(real[:, :k],
                           gt[:, :k] + rng.normal(size=gt[:, :k].shape) * 0.05,
                           pred[:, :k])
    pred = pred[:, rng.permutation(n_pred)]
    return dict(sop_pred=pred.astype(np.float32), sop_gt=gt,
                pred_sop_conf_scores=rng.normal(size=(2, n_pred)).astype(
                    np.float32))


@pytest.mark.parametrize("case", ["padding", "explicit_mask", "square",
                                  "fewer_predictions"])
def test_hungarian_sops_and_its_gradient_match_jax(case, deterministic_nn):
    """Through each package's handler: more predicted tokens than GT
    columns, the padded columns found from the −100 rows or given as
    ``sop_mask``, a square problem with every column real, and fewer
    predicted tokens than GT columns but no fewer than real tokens (the
    LAP's fake rows then fall on padded columns). The loss within 1e-5
    relative, the gradients with respect to the tokens and their logits
    within 1e-4 of the reference's norm."""
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu_torch.losses import LossHandler

    d = _sop_batch({"square": 6, "fewer_predictions": 4}.get(case, 12))
    if case == "explicit_mask":
        d["sop_mask"] = d["sop_gt"][..., 0] != -100.0
    if case == "square":
        d["sop_gt"] = np.where(d["sop_gt"] == -100.0, 0.5,
                               d["sop_gt"]).astype(np.float32)
    argv = [*SMALL, *SOP_WEIGHTS]
    preds = ("sop_pred", "pred_sop_conf_scores")
    jh = JaxLossHandler(["hungarian_SoPs"], jax_load_args(argv=argv))
    jw = jh.init_weights()
    fixed = {k: jnp.asarray(v) for k, v in d.items() if k not in preds}
    ref, ref_g = jax.value_and_grad(
        lambda p: jh.compute(jw, rng=None, **fixed, **p)[0])(
        {k: jnp.asarray(d[k]) for k in preds})
    h = LossHandler(["hungarian_SoPs"], load_args(argv=argv))
    tb = {k: torch.from_numpy(v) for k, v in d.items()}
    for k in preds:
        tb[k].requires_grad_(True)
    total = h.compute(h.init_weights(), **tb)[0]
    total.backward()
    assert np.isfinite(float(ref))
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    for k in preds:
        want = np.asarray(ref_g[k], np.float64)
        err = np.sqrt(((tb[k].grad.numpy() - want) ** 2).sum())
        assert err <= 1e-4 * np.sqrt((want ** 2).sum()), k


# ------------------------------------------- postprocess, metrics, beams

def test_sop_postprocess_matches_jax():
    from maskplanner_tpu.postprocess import sop as jax_sop
    from maskplanner_tpu_torch.postprocess import sop

    rng = np.random.default_rng(9)
    tokens = rng.normal(size=(3, 12, 24)).astype(np.float32)
    conf = rng.normal(size=(3, 12)).astype(np.float32)
    for thr in (0.5, 0.2, 0.9):
        for a, b in zip(sop.postprocess_sop_predictions(tokens, conf, thr),
                        jax_sop.postprocess_sop_predictions(tokens, conf,
                                                            thr)):
            np.testing.assert_array_equal(a, b)
    rows = np.concatenate([tokens[0], np.full((3, 24), -100.0)])
    np.testing.assert_array_equal(sop.unpad_rows(rows),
                                  jax_sop.unpad_rows(rows))
    strokes = [rng.normal(size=(9, 24)) for _ in range(4)]
    logits = [rng.normal(size=(9,)) * 3 for _ in range(4)]
    logits[1][:] = -9.0                      # never ends: kept whole
    for a, b in zip(sop.truncate_autoregressive_eop(strokes, logits),
                    jax_sop.truncate_autoregressive_eop(strokes, logits)):
        np.testing.assert_array_equal(a, b)
    boxes = rng.uniform(size=(2, 10, 6)) * 0.2
    boxes[0, 3] = boxes[0, 1] + 0.001        # a near duplicate
    for a, b in zip(sop.select_top_bboxes(boxes, 0.05),
                    jax_sop.select_top_bboxes(boxes, 0.05)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", ["sop_metrics", "sop_metrics_v2"])
def test_sop_metrics_match_jax(metric):
    """Every output of the SoP family through each package's
    ``MetricsHandler``, with the confidence threshold swept both ways
    (tensors on the port's side), exactly."""
    from maskplanner_tpu.metrics import MetricsHandler as JaxMetricsHandler
    from maskplanner_tpu_torch.metrics import MetricsHandler
    from maskplanner_tpu_torch.postprocess.sop import \
        postprocess_sop_predictions

    d = _sop_batch()
    kw = dict(sop_pred=d["sop_pred"], sop_gt=d["sop_gt"],
              pred_sop_conf_scores=d["pred_sop_conf_scores"],
              sop_conf_threshold=0.4,
              processed_sop_pred=postprocess_sop_predictions(
                  d["sop_pred"], d["pred_sop_conf_scores"], 0.4))
    want = JaxMetricsHandler(jax_load_args(argv=SMALL), [metric]).compute(
        **kw)
    got = MetricsHandler(load_args(argv=SMALL), [metric]).compute(
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    assert got == want and len(got) in (7, 8)


def test_beam_search_matches_jax():
    """Per-group argmin selection, and a beam search's advances,
    backpointers and tours on seeded log-probabilities, exactly."""
    from maskplanner_tpu.postprocess import beam_search as jax_bs
    from maskplanner_tpu_torch.postprocess import beam_search as bs

    rng = np.random.default_rng(10)
    seqs = [rng.permutation(5) for _ in range(7)]
    cost = rng.uniform(size=7)
    ids = np.array([0, 0, 1, 1, 1, 3, 3])
    assert repr(bs.get_best(seqs, cost)) == repr(jax_bs.get_best(seqs, cost))
    assert repr(bs.get_best(seqs, cost, ids, 4)) == \
        repr(jax_bs.get_best(seqs, cost, ids, 4))
    n = 6
    starts = rng.integers(0, n, size=(2, 3))
    a, b = bs.Beamsearch(3, 2, n, starts), jax_bs.Beamsearch(3, 2, n, starts)
    for _ in range(n - 1):
        probs = np.log(rng.uniform(size=(2, 3, n)))
        a.advance(probs)
        b.advance(probs)
        np.testing.assert_array_equal(a.get_current_state(),
                                      b.get_current_state())
        np.testing.assert_array_equal(a.get_current_origin(),
                                      b.get_current_origin())
    for x, y in zip(a.get_best(), b.get_best()):
        np.testing.assert_array_equal(x, y)
    k = np.zeros((2, 1), np.int64)
    np.testing.assert_array_equal(a.get_hypothesis(k), b.get_hypothesis(k))
