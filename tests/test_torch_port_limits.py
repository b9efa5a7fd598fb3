"""The port at the shapes past its kernels' small paths, against the JAX
package on the CPU: FPS above 8192 points, the segment chamfer above 128
coordinates (``lambda_points=22``: d = 132), the exact LAP above 128 rows
(``emd``'s 200 predictions against 50 GT rows). On the card these shapes
take the kernels' large paths (``csrc/fps.cu``, ``csrc/nn_argmin.cu``,
``csrc/lap.cu``); here the wrappers' plain versions run, which the card's
check (``chip_smoke.py`` phase 25) holds those paths against.

The JAX distances take their fixed-order form (``MASKPLANNER_DETERMINISTIC_
NN``), which the port uses.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args
from test_torch_port_train import (FLAGSHIP, JAX_ROUNDING_FACTOR,
                                   ROUNDING_FACTOR, STEP_BATCH,
                                   _active_weights, _leaves)

torch.set_num_threads(1)

# the small step of test_torch_port_train.py at λ = 22 (overlap 1: 5
# segments of 132 values from 120 poses)
LAMBDA = ["lambda_points=22", "overlapping=1"]
SMALL = [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]",
         "n_pred_traj_points=120", "max_n_strokes=6", "batch_size=4",
         *LAMBDA]


@pytest.fixture(autouse=True)
def deterministic_nn(monkeypatch):
    monkeypatch.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")


def test_fps_above_8192_points_matches_jax():
    """16384 points, npoint 512, batch 2: identical indices."""
    from maskplanner_tpu.ops.sampling import farthest_point_sample as jax_fps
    from maskplanner_tpu_torch.ops.sampling import farthest_point_sample

    xyz = np.random.default_rng(0).random((2, 16384, 3), dtype=np.float32)
    ref = np.asarray(jax_fps(jnp.asarray(xyz), 512))
    got = farthest_point_sample(torch.from_numpy(xyz), 512)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_segment_chamfer_at_132_coordinates_matches_jax(masked):
    """The segment chamfer at d = 132 (−100-padded GT rows, and a mask):
    values within 1e-5 relative, both directions' indices identical."""
    from maskplanner_tpu.ops.chamfer import chamfer_distance as jax_chamfer
    from maskplanner_tpu_torch.ops.chamfer import chamfer_distance

    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 132)).astype(np.float32)
    y = rng.normal(size=(2, 40, 132)).astype(np.float32)
    y[:, 31:] = -100.0
    kw = dict(padded=True, return_matching=True)
    if masked:
        mask = rng.random((2, 40)) > 0.3
        kw = dict(y_mask=mask, return_matching=True)
    ref = jax_chamfer(jnp.asarray(x), jnp.asarray(y),
                      **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                         else v for k, v in kw.items()})
    got = chamfer_distance(torch.from_numpy(x), torch.from_numpy(y),
                           **{k: torch.from_numpy(v)
                              if isinstance(v, np.ndarray) else v
                              for k, v in kw.items()})
    np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-5)
    for i in (2, 3):
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.asarray(ref[i]).astype(np.int64))


@pytest.fixture(scope="module")
def emd_inputs():
    rng = np.random.default_rng(2)
    y_pred = rng.normal(size=(2, 200, 24)).astype(np.float32)
    y = rng.normal(size=(2, 50, 24)).astype(np.float32)
    mask = rng.random((2, 50)) > 0.2
    mask[:, 0] = True
    return y_pred, y, mask


def test_hungarian_at_200_rows_matches_jax(emd_inputs):
    """200 predictions against 50 masked GT rows (a 200 x 200 LAP, JAX's
    vmapped ``_solve_square`` route): equal total cost within 1e-5
    relative, the same columns matched."""
    from maskplanner_tpu.losses.common import euclid_cdist as jax_cdist
    from maskplanner_tpu.ops.hungarian import hungarian as jax_hungarian
    from maskplanner_tpu_torch.losses.common import euclid_cdist
    from maskplanner_tpu_torch.ops.hungarian import hungarian

    y_pred, y, mask = emd_inputs
    cost = np.asarray(jax_cdist(jnp.asarray(y_pred), jnp.asarray(y)))
    ref_rows, ref_matched = jax_hungarian(jnp.asarray(cost),
                                          jnp.asarray(mask))
    got_rows, got_matched = hungarian(
        euclid_cdist(torch.from_numpy(y_pred), torch.from_numpy(y)),
        torch.from_numpy(mask))
    np.testing.assert_array_equal(got_matched.numpy(),
                                  np.asarray(ref_matched))

    def total(rows, matched):
        picked = np.take_along_axis(cost.transpose(0, 2, 1),
                                    np.asarray(rows)[..., None], -1)[..., 0]
        return np.where(matched, picked, 0.0).astype(np.float64).sum(-1)

    np.testing.assert_allclose(total(got_rows.numpy(), mask),
                               total(ref_rows, mask), rtol=1e-5)


def test_emd_at_200_by_50_matches_jax(emd_inputs):
    """``emd`` on the exact route at 200 x 50: the same value (1e-5
    relative)."""
    from maskplanner_tpu.losses.stroke_losses import emd as jax_emd
    from maskplanner_tpu_torch.losses.stroke_losses import emd

    y_pred, y, mask = emd_inputs
    ref = float(jax_emd(jnp.asarray(y_pred), jnp.asarray(y),
                        jnp.asarray(mask)))
    got = float(emd(torch.from_numpy(y_pred), torch.from_numpy(y),
                    torch.from_numpy(mask)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.fixture(scope="module")
def lambda_step():
    """The JAX step at λ = 22 on converted weights, eager, dropout off."""
    import flax.linen as fnn

    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu.data import collate
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.train.schedulers import \
        apply_delayed_activations as jax_delayed
    from maskplanner_tpu.train.trainer import build_loss_batch as jax_blb

    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    cfg = jax_load_args(argv=SMALL)
    batch = collate([JaxPaintDataset(cfg, split="train", size=STEP_BATCH)[i]
                     for i in range(STEP_BATCH)])
    rng = np.random.default_rng(0)
    model = get_flax_model(cfg)
    variables = model.init(jax.random.PRNGKey(1),
                           jnp.asarray(batch["point_cloud"]), train=False)
    # seeded non-zero biases and scales, as test_torch_port_train.py's
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1
                      ).astype(np.float32)
        if p[-1].key in ("bias", "scale", "mean") else
        (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
         if p[-1].key == "var" else np.asarray(a)), variables)
    handler = JaxLossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(_active_weights(jax_delayed, cfg))

    def jax_step(b):
        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(b["point_cloud"]), train=True,
                mutable=["batch_stats"])
            lb = jax_blb(out, jax.tree_util.tree_map(jnp.asarray, b), cfg)
            assert lb["y_pred"].shape[-1] == 132
            total, _ = handler.compute(weights, rng=None, **lb)
            return total, mutated["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        return dict(loss=float(loss),
                    grads=jax.tree_util.tree_map(np.asarray, grads),
                    stats=jax.tree_util.tree_map(np.asarray, stats))

    ref = jax_step(batch)
    # the JAX step's own float32 rounding, sampled as the step test does
    # for its BatchNorm case: the batch in reverse order
    rev = jax_step({k: v[::-1] for k, v in batch.items()})
    ref["own"] = dict(
        loss=abs(rev["loss"] - ref["loss"]),
        grads=jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(),
                                     ref["grads"], rev["grads"]),
        stats=jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(),
                                     ref["stats"], rev["stats"]))
    yield variables, batch, ref
    mp.undo()


def _port_step(variables, batch, dtype):
    from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                               state_dict_from_flax)
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import (apply_delayed_activations,
                                             batch_to_device, train_step)

    cfg = load_args(argv=SMALL)
    model = get_model(cfg, device="cpu", dropout=0.0)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.to(dtype)
    handler = LossHandler(cfg["loss"], cfg)
    weights = handler.init_weights()
    weights.update(_active_weights(apply_delayed_activations, cfg))
    b = batch_to_device(batch, "cpu")
    b = {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}
    optimizer = torch.optim.Adam(model.parameters(), lr=0.0)
    loss, _ = train_step(model, optimizer, handler, b, weights)
    grads = flax_tree_from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})["params"]
    stats = flax_tree_from_state_dict(model.state_dict())["batch_stats"]
    return float(loss), grads, stats


def test_train_step_at_lambda_22_matches_jax(lambda_step):
    """One step at λ = 22 (the segment chamfer at d = 132) under
    ``test_torch_port_train.py``'s rule for its BatchNorm case: the loss
    within 1e-5 relative, each gradient within 5e-4 · max|ref| and the
    BatchNorm statistics within 1e-6, each plus ROUNDING_FACTOR times the
    port's own float32 error on that value (against the same step in
    float64) and JAX_ROUNDING_FACTOR times the JAX step's own (sampled by
    the reversed batch). At λ = 22 the JAX step's rounding is the larger:
    at sa3's first Dense kernel (after its train-mode BatchNorm, whose JAX
    variance is E[x²] − E[x]²) the port's float64 step lies 21.6 from the
    JAX step, its float32 step 1.7 from its float64 step, of max|ref| 1e4."""
    variables, batch, ref = lambda_step
    loss, grads, stats = _port_step(variables, batch, torch.float32)
    loss64, grads64, stats64 = _port_step(variables, batch, torch.float64)
    jax_own = ref["own"]
    np.testing.assert_allclose(
        loss, ref["loss"], rtol=0,
        atol=1e-5 * abs(ref["loss"]) + ROUNDING_FACTOR * abs(loss - loss64)
        + JAX_ROUNDING_FACTOR * jax_own["loss"])
    for got, exact, want, ref_own, tol in (
            (_leaves(grads), _leaves(grads64), _leaves(ref["grads"]),
             _leaves(jax_own["grads"]), lambda b: 5e-4 * np.abs(b).max()),
            (_leaves(stats), _leaves(stats64), _leaves(ref["stats"]),
             _leaves(jax_own["stats"]), lambda b: 1e-6)):
        assert sorted(got) == sorted(want)
        for key, b in want.items():
            own = np.abs(got[key] - exact[key]).max()
            np.testing.assert_allclose(
                got[key], b, rtol=0, atol=tol(b) + ROUNDING_FACTOR * own
                + JAX_ROUNDING_FACTOR * ref_own[key], err_msg=key)
