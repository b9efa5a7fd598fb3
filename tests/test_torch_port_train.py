"""The PyTorch port's training step against the JAX package's, on the CPU.

The flagship configuration at small widths (``pc_points=64``, hidden
32x32, 120 poses, 6 stroke masks), the same converted weights on both
sides, FPS starting at index 0, dropout off (the port's rate 0; Flax's
``Dropout`` patched to the identity) and the loss weights after the
delayed activation, so that every head has a gradient. The loss agrees
within 1e-5 relative, every parameter gradient within 5e-4 · max|ref|
(through ``flax_tree_from_state_dict``) and the BatchNorm running
statistics after the step within 1e-6, each plus the port's own float32
rounding error on the tensor (see the step test). The JAX distances take
their fixed-order form, which the port uses. The step runs with the
shipped hybrid norm and with the reference BatchNorm recipe
(``model.norm=batch``: sa1 and sa2 group with the ball-group gather and
normalise with batch statistics).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
SMALL = [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]",
         "n_pred_traj_points=120", "max_n_strokes=6", "batch_size=4"]
STEP_BATCH = 4


def _small(norm):
    """The small step configuration with ``norm``. The BatchNorm recipe runs
    at 1024 points: at 64, sa1's 512 centroids are 448 copies of point 0
    (FPS repeats index 0 once every point is taken), its BatchNorm then
    normalises nearly constant rows, and the JAX float32 variance
    (E[x²] − E[x]²) lands 140x further from the float64 value than the
    port's (0.144 against 0.001 of max|out| 23.8 at sa1; ROADMAP.md,
    Queue 3). At 1024 points the centroids are distinct."""
    pc = ["pc_points=1024"] if norm == "batch" else []
    return [*SMALL, *pc, f"model.norm={norm}"]


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    yield mp
    mp.undo()


def _active_weights(weights_fn, config):
    """The loss weights after the delayed stroke-mask activation."""
    return weights_fn(config, dict(), 10 ** 6)


@pytest.fixture(scope="module", params=["layer+layer+batch", "batch"])
def step_case(request, monkeypatch_module):
    import flax.linen as fnn

    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu.data import collate
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train.schedulers import \
        apply_delayed_activations as jax_delayed
    from maskplanner_tpu.train.trainer import build_loss_batch as jax_blb

    norm = request.param
    cfg = jax_load_args(argv=_small(norm))
    batch = collate([JaxPaintDataset(cfg, split="train", size=STEP_BATCH)[i]
                     for i in range(STEP_BATCH)])
    rng = np.random.default_rng(0)
    model = get_flax_model(cfg)
    variables = model.init(jax.random.PRNGKey(1),
                           jnp.asarray(batch["point_cloud"]), train=False)
    # Flax starts every bias at 0, so a centroid's own row (offset 0) makes
    # sa1's first LayerNorm see a constant row: inverse std 1/sqrt(1e-6),
    # which multiplies the rounding of its gradient by 1000. Seeded
    # non-zero biases and scales keep the comparison about the port.
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1
                      ).astype(np.float32)
        if p[-1].key in ("bias", "scale", "mean") else
        (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
         if p[-1].key == "var" else np.asarray(a)), variables)

    handler = JaxLossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(_active_weights(jax_delayed, cfg))
    monkeypatch_module.setattr(fnn.Dropout, "__call__",
                               lambda self, x, *a, **k: x)

    def jax_step(b):
        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(b["point_cloud"]), train=True,
                mutable=["batch_stats"])
            lb = jax_blb(out, jax.tree_util.tree_map(jnp.asarray, b), cfg)
            total, _ = handler.compute(weights, rng=None, **lb)
            return total, mutated["batch_stats"]

        # eager, as the port runs: under jit XLA fuses the fixed-order
        # distance sums and the near-ties of the nearest-neighbour matching
        # can fall the other way
        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
        return dict(loss=float(loss),
                    grads=jax.tree_util.tree_map(np.asarray, grads),
                    stats=jax.tree_util.tree_map(np.asarray, new_stats))

    ref = jax_step(batch)
    ref["own"] = None
    if norm == "batch":
        # the JAX step's own float32 rounding, sampled: the same step on the
        # batch in reverse order sums every reduction in another order
        rev = jax_step({k: v[::-1] for k, v in batch.items()})
        ref["own"] = dict(
            loss=abs(rev["loss"] - ref["loss"]),
            grads=jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(),
                                         ref["grads"], rev["grads"]),
            stats=jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(),
                                         ref["stats"], rev["stats"]))
    return variables, batch, ref, norm


def _port_step(variables, batch, dtype, norm):
    """One port train step on the CPU in ``dtype`` with Adam at lr 0 ->
    (loss, gradients and BatchNorm statistics as Flax trees)."""
    from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                               state_dict_from_flax)
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import (apply_delayed_activations,
                                             batch_to_device, train_step)

    cfg = load_args(argv=_small(norm))
    model = get_model(cfg, device="cpu", dropout=0.0)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.to(dtype)
    handler = LossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(_active_weights(apply_delayed_activations, cfg))
    b = batch_to_device(batch, "cpu")
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
    # lr 0: the step's gradients stay in .grad and the weights do not move
    optimizer = torch.optim.Adam(model.parameters(), lr=0.0)
    loss, terms = train_step(model, optimizer, handler, b, weights)
    assert list(terms) == ["asymm_v6_chamfer_with_stroke_masks"]
    grads = flax_tree_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})["params"]
    stats = flax_tree_from_state_dict(model.state_dict())["batch_stats"]
    return float(loss), grads, stats


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float64)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


# The JAX step's float32 error, against the same step in float64, measured
# 4-10x the port's on the ill-conditioned tensors (Flax's LayerNorm and
# BatchNorm take the variance as E[x²] − E[x]²; the port's CPU path centres
# first). So the allowance for float32 rounding is this many times the
# port's own float32 error on each tensor.
ROUNDING_FACTOR = 10
# One sample of the JAX step's own rounding (the reversed batch) gives its
# size only roughly; at the BatchNorm recipe's small case the largest gap
# measured 1.5 such samples (the sm_head BatchNorm statistics).
JAX_ROUNDING_FACTOR = 3


def test_one_train_step_matches_jax(step_case):
    """Loss within 1e-5 relative, each gradient within 5e-4 · max|ref| and
    the BatchNorm running statistics within 1e-6, each plus a float32
    rounding allowance: ROUNDING_FACTOR times the port's own float32 error
    on that value, measured against the same step in float64 (with the
    matching decisions of the float32 distances). At random init this
    network amplifies rounding a thousandfold on its way down to the
    encoder (BatchNorm over a batch of 4, LayerNorm on near-constant rows),
    and a Dense bias followed by a BatchNorm has an exact gradient of 0, so
    both its values are rounding noise. A porting fault moves a value by
    far more than that allowance.

    Under ``model.norm=batch`` the JAX step's own rounding is larger than
    that: its BatchNorms over sa1's 65536 and sa2's 32768 rows take the
    variance as E[x²] − E[x]² from sums XLA accumulates in order, and the
    same JAX step on the batch in reverse order moves the loss by 1e-4
    relative and the mask-head gradients by up to 2e-3 · max|ref|, where the
    port's float32 step lies 2e-7 from its float64 step. So that case also
    allows JAX_ROUNDING_FACTOR times the JAX step's own rounding, sampled by
    that reversal, tensor by tensor (ROADMAP.md, Queue 3)."""
    variables, batch, ref, norm = step_case
    loss, grads, stats = _port_step(variables, batch, torch.float32, norm)
    loss64, grads64, stats64 = _port_step(variables, batch, torch.float64,
                                          norm)
    jax_own = ref["own"] or dict(loss=0.0, grads=None, stats=None)
    np.testing.assert_allclose(
        loss, ref["loss"], rtol=0,
        atol=1e-5 * abs(ref["loss"]) + ROUNDING_FACTOR * abs(loss - loss64)
        + JAX_ROUNDING_FACTOR * jax_own["loss"])
    for got, exact, want, ref_own, tol in (
            (_leaves(grads), _leaves(grads64), _leaves(ref["grads"]),
             jax_own["grads"], lambda b: 5e-4 * np.abs(b).max()),
            (_leaves(stats), _leaves(stats64), _leaves(ref["stats"]),
             jax_own["stats"], lambda b: 1e-6)):
        assert sorted(got) == sorted(want)
        ref_own = {} if ref_own is None else _leaves(ref_own)
        for key, b in want.items():
            own = np.abs(got[key] - exact[key]).max()
            np.testing.assert_allclose(
                got[key], b, rtol=0, atol=tol(b) + ROUNDING_FACTOR * own
                + JAX_ROUNDING_FACTOR * ref_own.get(key, 0.0), err_msg=key)


def test_v6_loss_and_its_gradients_match_jax(monkeypatch_module):
    from maskplanner_tpu.losses.mask_losses import \
        asymm_v6_chamfer_with_stroke_masks as jax_v6
    from maskplanner_tpu_torch.data import PaintDataset, collate
    from maskplanner_tpu_torch.losses.mask_losses import \
        asymm_v6_chamfer_with_stroke_masks

    cfg = load_args(argv=SMALL)
    batch = collate([PaintDataset(cfg, split="test", size=2)[i]
                     for i in range(2)])
    rng = np.random.default_rng(4)
    S = batch["traj"].shape[1]
    y_pred = (batch["traj"] + rng.normal(size=batch["traj"].shape) * 0.05)
    y_pred = np.where(batch["traj"] == -100.0,
                      rng.normal(size=y_pred.shape), y_pred).astype(np.float32)
    masks = rng.normal(size=(2, 6, S)).astype(np.float32)
    scores = rng.normal(size=(2, 6)).astype(np.float32)
    weights = dict(weight_asymm_segment_chamfer=1.0,
                   weight_reverse_asymm_point_chamfer=100.0,
                   weight_reverse_asymm_segment_chamfer=0.01,
                   explicit_weight_stroke_masks=1.0,
                   explicit_weight_stroke_masks_confidence=100.0,
                   explicit_no_stroke_weight=1.0)
    fixed = dict(y=batch["traj"], y_mask=batch["stroke_ids"] >= 0,
                 traj_as_pc=batch["traj_as_pc"],
                 pc_mask=batch["stroke_ids_as_pc"] >= 0,
                 stroke_ids=batch["stroke_ids"], seg_logits=None, outdim=6,
                 weights=weights)

    def jax_loss(yp, m, s):
        return jax_v6(yp, pred_stroke_masks=m, mask_scores=s,
                      **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v) for k, v in fixed.items()})

    ref, ref_g = jax.value_and_grad(jax_loss, (0, 1, 2))(
        jnp.asarray(y_pred), jnp.asarray(masks), jnp.asarray(scores))
    t = [torch.from_numpy(a).requires_grad_(True)
         for a in (y_pred, masks, scores)]
    got = asymm_v6_chamfer_with_stroke_masks(
        t[0], pred_stroke_masks=t[1], mask_scores=t[2],
        **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in fixed.items()})
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    got.backward()
    for a, b in zip(t, ref_g):
        b = np.asarray(b)
        np.testing.assert_allclose(a.grad.numpy(), b,
                                   atol=1e-5 * (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("mask", ["y_mask", "padding"])
def test_v6_loss_searches_three_times_and_is_unchanged(mask, monkeypatch):
    """The forward segment term searches only the direction it uses: the
    v6 loss's value and gradients are bitwise those of the four-search
    form (the term through ``chamfer_distance(..., asymmetric=True,
    return_matching=True)``, whose reverse matching it discarded), with 3
    ``nn_argmin`` calls instead of 4; with ``y_mask`` given, and with the
    mask taken from the -100 padding."""
    from maskplanner_tpu_torch.data import PaintDataset, collate
    from maskplanner_tpu_torch.losses import mask_losses
    from maskplanner_tpu_torch.ops import chamfer

    cfg = load_args(argv=SMALL)
    batch = collate([PaintDataset(cfg, split="test", size=2)[i]
                     for i in range(2)])
    rng = np.random.default_rng(8)
    S = batch["traj"].shape[1]
    y_pred = (batch["traj"] + rng.normal(size=batch["traj"].shape) * 0.05)
    y_pred = np.where(batch["traj"] == -100.0,
                      rng.normal(size=y_pred.shape), y_pred).astype(np.float32)
    inputs = (y_pred, rng.normal(size=(2, 6, S)).astype(np.float32),
              rng.normal(size=(2, 6)).astype(np.float32))
    weights = dict(weight_asymm_segment_chamfer=1.0,
                   weight_reverse_asymm_point_chamfer=100.0,
                   weight_reverse_asymm_segment_chamfer=0.01,
                   explicit_weight_stroke_masks=1.0,
                   explicit_weight_stroke_masks_confidence=100.0,
                   explicit_no_stroke_weight=1.0)
    fixed = dict(y=torch.from_numpy(batch["traj"]),
                 y_mask=(torch.from_numpy(batch["stroke_ids"] >= 0)
                         if mask == "y_mask" else None),
                 traj_as_pc=torch.from_numpy(batch["traj_as_pc"]),
                 pc_mask=torch.from_numpy(batch["stroke_ids_as_pc"] >= 0),
                 stroke_ids=torch.from_numpy(batch["stroke_ids"]),
                 seg_logits=None, outdim=6, weights=weights)
    searches = []
    search = chamfer.nn_argmin
    monkeypatch.setattr(chamfer, "nn_argmin",
                        lambda *a: (searches.append(a), search(*a))[1])

    def loss_and_grads():
        t = [torch.from_numpy(a).requires_grad_(True) for a in inputs]
        searches.clear()
        loss = mask_losses.asymm_v6_chamfer_with_stroke_masks(
            t[0], pred_stroke_masks=t[1], mask_scores=t[2], **fixed)
        loss.backward()
        return loss.detach(), [a.grad for a in t], len(searches)

    loss, grads, n = loss_and_grads()

    def four_search_term(y_pred, y, y_mask):
        nn_dist, _, match, _ = chamfer.chamfer_distance(
            y_pred, y, padded=True, y_mask=y_mask, asymmetric=True,
            return_matching=True, point_reduction=None, batch_reduction=None)
        return nn_dist, match

    monkeypatch.setattr(mask_losses, "_forward_segment_chamfer_with_matching",
                        four_search_term)
    ref_loss, ref_grads, ref_n = loss_and_grads()
    assert (n, ref_n) == (3, 4)
    assert torch.equal(loss, ref_loss)
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)


def test_lr_psacd_and_delayed_activations_match_over_epochs():
    import optax  # noqa: F401  (the JAX schedule is an optax schedule)

    from maskplanner_tpu.train.schedulers import (PSACDScheduler as JaxPSACD,
                                                  apply_delayed_activations
                                                  as jax_delayed, lr_schedule)
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.train import (PSACDScheduler,
                                             apply_delayed_activations,
                                             make_lr_scheduler)

    argv = [FLAGSHIP, "epochs=40", "lr_sched.step_sizes=[5,12,12,30]",
            "psacd_scheduler.milestones=[7,20]",
            "start_stroke_masks_loss_at=9"]
    cfg, ref_cfg = load_args(argv=argv), jax_load_args(argv=argv)
    spe = 3
    sched = lr_schedule(ref_cfg, spe)
    opt = torch.optim.Adam([torch.zeros(1, requires_grad=True)],
                           lr=float(cfg["lr"]))
    lr_sched = make_lr_scheduler(opt, cfg)
    weights = LossHandler(cfg["loss"], cfg).init_weights()
    ref_weights = dict(weights)
    psacd = PSACDScheduler(cfg["psacd_scheduler"])
    ref_psacd = JaxPSACD(ref_cfg["psacd_scheduler"])
    epochs = int(cfg["epochs"])
    for epoch in range(epochs):
        for step in (epoch * spe, epoch * spe + spe - 1):
            np.testing.assert_allclose(opt.param_groups[0]["lr"],
                                       float(sched(step)), rtol=1e-6)
        opt.step()
        lr_sched.step()
        if psacd.is_time_to_step(epoch, epochs):
            weights = psacd.step_loss_weights(weights)
        if ref_psacd.is_time_to_step(epoch, epochs):
            ref_weights = ref_psacd.step_loss_weights(ref_weights)
        weights = apply_delayed_activations(cfg, weights, epoch)
        ref_weights = jax_delayed(ref_cfg, ref_weights, epoch)
        assert weights.keys() == ref_weights.keys()
        for k in weights:
            np.testing.assert_allclose(weights[k], float(ref_weights[k]),
                                       rtol=1e-6, err_msg=f"{k} @ {epoch}")
    assert weights["explicit_weight_stroke_masks_confidence"] == 100.0
    # a constant rate needs no scheduler
    const = load_args(argv=[FLAGSHIP, "lr_sched.step_sizes=null"])
    assert make_lr_scheduler(opt, const) is None


def test_driver_trains_and_the_predictor_serves(tmp_path):
    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.serve import Predictor

    run_dir, model = train_maskplanner.main([
        *SMALL, "batch_size=2", "device=cpu", "epochs=2", "eval_freq=1",
        "dataset_size=4",
        "test_dataset_size=2", "seed=3", f"output_dir={tmp_path}"])
    assert not model.training
    assert os.path.isfile(os.path.join(run_dir, "last_checkpoint.torch.pt"))
    logs = (tmp_path / os.path.basename(run_dir) / "logs.jsonl").read_text()
    assert logs.count('"eval_loss"') == 2
    mesh = tmp_path / "box.obj"
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], float) * [450.0, 60.0, 550.0]
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
             (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
             (1, 5, 7), (1, 7, 3)]
    mesh.write_text("".join(f"v {a} {b} {c}\n" for a, b, c in corners)
                    + "".join(f"f {a + 1} {b + 1} {c + 1}\n"
                              for a, b, c in faces))
    pred = Predictor(run_dir, model="last", device="cpu")
    assert pred.epoch == 2
    rows = pred.predict_program(str(mesh), postprocess=False)
    assert rows.ndim == 2 and rows.shape[1] == 7 and np.isfinite(rows).all()


def test_driver_writes_best_and_intermediate_checkpoints(tmp_path):
    import json

    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.serve import Predictor

    run_dir, _ = train_maskplanner.main([
        *SMALL, "batch_size=2", "device=cpu", "epochs=2", "eval_freq=1",
        "dataset_size=4", "test_dataset_size=2", "seed=3", "no_save=false",
        "save_intermediate_models=true", "save_intermediate_models_freq=1",
        f"output_dir={tmp_path}"])
    for name in ("last_checkpoint", "best_model",
                 "intermediate_checkpoint_epoch1",
                 "intermediate_checkpoint_epoch2"):
        assert os.path.isfile(os.path.join(run_dir, f"{name}.torch.pt")), name
    with open(os.path.join(run_dir, "summary.json")) as fh:
        best_epoch = json.load(fh)["best_epoch"]
    assert best_epoch in (1, 2)
    assert Predictor(run_dir, model="best", device="cpu").epoch == best_epoch
    assert Predictor(run_dir, model="intermediate_epoch1",
                     device="cpu").epoch == 1
    # no_save writes no checkpoint at all
    run_dir, _ = train_maskplanner.main([
        *SMALL, "batch_size=2", "device=cpu", "epochs=1", "eval_freq=1",
        "dataset_size=4", "test_dataset_size=2", "seed=3", "no_save=true",
        "save_intermediate_models=true", "save_intermediate_models_freq=1",
        f"output_dir={tmp_path / 'nosave'}"])
    assert not [f for f in os.listdir(run_dir) if f.endswith(".torch.pt")]


@pytest.mark.parametrize("profile", [True, False],
                         ids=["profile", "no-profile"])
def test_profile_traces_the_second_epoch(profile, tmp_path):
    """``profile=true`` leaves a chrome trace of the second epoch's steps
    under ``<run_dir>/profile/`` (the JAX package's ``profile_trace``);
    without it the run leaves none; with one epoch there is no second to
    trace, and the run raises rather than ignore the flag."""
    import json

    from maskplanner_tpu_torch import train_maskplanner

    args = [*SMALL, "batch_size=2", "device=cpu", "eval_freq=1",
            "dataset_size=4", "test_dataset_size=2", "seed=3",
            "no_save=true", f"profile={str(profile).lower()}",
            f"output_dir={tmp_path}"]
    run_dir, _ = train_maskplanner.main([*args, "epochs=2"])
    trace_dir = os.path.join(run_dir, "profile")
    if not profile:
        assert not os.path.exists(trace_dir)
        return
    assert os.listdir(trace_dir) == ["trace.json"]
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    # the second epoch's two steps: forward, loss and Adam's ops
    names = {e.get("name", "") for e in events}
    assert any("Optimizer.step" in n for n in names), sorted(names)[:20]
    with pytest.raises(ValueError, match="second epoch"):
        train_maskplanner.main([*args, "epochs=1"])


def test_driver_refuses_what_is_not_ported(tmp_path):
    from maskplanner_tpu_torch import train_maskplanner

    # a JAX run's orbax checkpoint cannot warm-start the port
    (tmp_path / "jax_run" / "last_checkpoint").mkdir(parents=True)
    for extra in ([f"model.pretrained_custom={tmp_path / 'jax_run'}"],
                  ["loss=[chamfer]"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            train_maskplanner.main([*SMALL, "device=cpu", "epochs=1",
                                    f"output_dir={tmp_path}", *extra])


def test_driver_cuda_without_a_card_raises(tmp_path):
    from maskplanner_tpu_torch import train_maskplanner

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_maskplanner.main([*SMALL, "epochs=1",
                                f"output_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_maskplanner.main([*SMALL, "device=cuda", "epochs=1",
                                f"output_dir={tmp_path}"])
