"""The port's loss terms against the JAX package's, on the CPU.

The same seeded inputs go through the JAX function, run eagerly with its
fixed-order distances (``MASKPLANNER_DETERMINISTIC_NN``, the form the port
uses), and through the port's: the flagship's small data (``SMALL``:
windows, λ=4 segments of 6-value poses) with predictions near the GT,
and the same data cut into λ=1 segments for the terms the JAX handler
allows only there. Every term's value agrees within 1e-5 relative and its
gradient with respect to ``y_pred`` within 1e-5 · max|ref|, as the v6
loss's does (``tests/test_torch_port_train.py``); the singular-value
terms (``align``, ``intra_align``) within ``SVD_RTOL`` (see there). Every
``chamfer_distance`` variant returns the JAX package's matching indices
exactly, and the registry accepts exactly what the JAX handler accepts
among the names it ports and raises ``NotImplementedError`` for the rest.
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
SMALL = [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]",
         "n_pred_traj_points=120", "max_n_strokes=6"]
OUTDIM = 6
# Sinkhorn divides the normalised cost by eps = 0.005 in every one of its
# 60 iterations, which magnifies float32 rounding: each package's float32
# value lies 3e-5 to 6e-5 relative from the port's float64 one. Its terms
# allow, on top of the 1e-5, this many times the port's own float32 error
# (its float32 result against its float64 result), as the step test does.
ROUNDING_FACTOR = 10
# LAPACK's singular values of the small centred windows differ between
# the two packages' builds by a few float32 ulps of the largest one, and
# their gradient (u vᵀ) by as much relative to its largest entry; generic
# (non-planar) inputs keep the third singular value away from 0, where
# its gradient's sign is not defined
SVD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _deterministic_nn(monkeypatch):
    monkeypatch.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")


def _weights():
    return dict(weight_asymm_segment_chamfer=1.0,
                weight_reverse_asymm_point_chamfer=100.0,
                weight_reverse_asymm_segment_chamfer=0.01,
                weight_symm_segment_chamfer=0.01,
                weight_symm_point_chamfer=100.0,
                explicit_weight_stroke_masks=1.0,
                explicit_weight_stroke_masks_confidence=100.0,
                explicit_no_stroke_weight=1.0)


@pytest.fixture(scope="module")
def data():
    """Two windows of the small flagship data, predictions near the GT
    (random rows where the GT is padding), and random mask logits."""
    from maskplanner_tpu_torch.data import PaintDataset, collate

    cfg = load_args(argv=SMALL)
    batch = collate([PaintDataset(cfg, split="test", size=2)[i]
                     for i in range(2)])
    rng = np.random.default_rng(4)
    S = batch["traj"].shape[1]
    y_pred = batch["traj"] + rng.normal(size=batch["traj"].shape) * 0.05
    y_pred = np.where(batch["traj"] == -100.0,
                      rng.normal(size=y_pred.shape), y_pred)
    return dict(y_pred=y_pred.astype(np.float32), y=batch["traj"],
                y_mask=batch["stroke_ids"] >= 0,
                traj_as_pc=batch["traj_as_pc"],
                pc_mask=batch["stroke_ids_as_pc"] >= 0,
                stroke_ids=batch["stroke_ids"],
                pred_stroke_masks=rng.normal(size=(2, 6, S)).astype(
                    np.float32),
                mask_scores=rng.normal(size=(2, 6)).astype(np.float32))


def _lambda1(d):
    """The data cut into λ=1 segments (one pose each)."""
    B = d["y"].shape[0]
    return dict(d, y_pred=d["y_pred"].reshape(B, -1, OUTDIM),
                y=d["y"].reshape(B, -1, OUTDIM),
                y_mask=np.repeat(d["y_mask"], 4, axis=1))


def _jax_modules():
    from maskplanner_tpu.losses import chamfer_losses as C
    from maskplanner_tpu.losses import mask_losses as M
    from maskplanner_tpu.losses import regularizers as R
    from maskplanner_tpu.losses import stroke_losses as S
    return C, M, R, S


def _port_modules():
    from maskplanner_tpu_torch.losses import chamfer_losses as C
    from maskplanner_tpu_torch.losses import mask_losses as M
    from maskplanner_tpu_torch.losses import regularizers as R
    from maskplanner_tpu_torch.losses import stroke_losses as S
    return C, M, R, S


def _std(d):
    return dict(y=d["y"], y_mask=d["y_mask"], traj_as_pc=d["traj_as_pc"],
                pc_mask=d["pc_mask"], outdim=OUTDIM)


def _masks(d):
    return dict(pred_stroke_masks=d["pred_stroke_masks"],
                mask_scores=d["mask_scores"], stroke_ids=d["stroke_ids"],
                weights=_weights())


# name -> (λ=1 data?, the term on (modules C, M, R, S, y_pred, data))
TERMS = {
    "chamfer": (False, lambda C, M, R, S, yp, d: C.chamfer(yp, **_std(d))),
    "chamfer_min_centroids": (False, lambda C, M, R, S, yp, d: C.chamfer(
        yp, min_centroids=True, **_std(d))),
    "chamfer_velocities": (True, lambda C, M, R, S, yp, d: C.chamfer(
        yp, velocities=True, **_std(d))),
    "symm_segment_chamfer": (False, lambda C, M, R, S, yp, d:
                             C.symm_segment_chamfer(yp, **_std(d))),
    "symm_point_chamfer": (False, lambda C, M, R, S, yp, d:
                           C.symm_point_chamfer(yp, **_std(d))),
    "asymm_segment_chamfer": (False, lambda C, M, R, S, yp, d:
                              C.asymm_segment_chamfer(yp, **_std(d))),
    "attraction_chamfer": (False, lambda C, M, R, S, yp, d:
                           C.attraction_chamfer(yp)),
    "rich_attraction_chamfer": (False, lambda C, M, R, S, yp, d:
                                C.rich_attraction_chamfer(yp, OUTDIM)),
    "rich_attraction_chamfer_soft": (False, lambda C, M, R, S, yp, d:
                                     C.rich_attraction_chamfer(
                                         yp, OUTDIM, soft_attraction=True)),
    "chamfer_bbox": (False, lambda C, M, R, S, yp, d: C.chamfer_bbox(
        yp, d["y"], bbox_mask=d["y_mask"])),
    "repulsion": (False, lambda C, M, R, S, yp, d: R.repulsion(
        yp, knn_repulsion=2, lambda_points=4, **_std(d))),
    "repulsion_padding_mask": (False, lambda C, M, R, S, yp, d: R.repulsion(
        yp, lambda_points=4, **dict(_std(d), y_mask=None))),
    "repulsion_lambda1_unmasked": (True, lambda C, M, R, S, yp, d:
                                   R.repulsion(yp, lambda_points=1, **dict(
                                       _std(d), y_mask=None))),
    "repulsion_rep_target": (False, lambda C, M, R, S, yp, d: R.repulsion(
        yp, rep_target=0.05, lambda_points=4, **_std(d))),
    "velcosine": (True, lambda C, M, R, S, yp, d: R.velcosine(
        yp, knn_repulsion=3)),
    "mse": (False, lambda C, M, R, S, yp, d: R.mse(yp, d["y"])),
    "emd_exact": (False, lambda C, M, R, S, yp, d: S.emd(
        yp[:, :40], d["y"], y_mask=d["y_mask"])),
    "emd_exact_padding": (False, lambda C, M, R, S, yp, d: S.emd(
        yp[:, :30], d["y"])),
    "emd_sinkhorn": (True, lambda C, M, R, S, yp, d: S.emd(
        yp, d["y"], y_mask=d["y_mask"])),
    "chamfer_with_stroke_masks": (False, lambda C, M, R, S, yp, d:
                                  M.chamfer_with_stroke_masks(
                                      yp, d["y"], y_mask=d["y_mask"],
                                      **_masks(d))),
    "asymm_v11_chamfer_with_stroke_masks": (
        False, lambda C, M, R, S, yp, d:
        M.asymm_v11_chamfer_with_stroke_masks(
            yp, seg_logits=None, **_std(d), **_masks(d))),
    "symm_v1_chamfer_with_stroke_masks": (
        False, lambda C, M, R, S, yp, d: M.symm_v1_chamfer_with_stroke_masks(
            yp, **_std(d), **_masks(d))),
}
SVD_TERMS = {
    "align": (True, lambda C, M, R, S, yp, d: R.align(yp, knn_repulsion=3)),
    "intra_align": (False, lambda C, M, R, S, yp, d: R.intra_align(yp)),
}


def _to(lib, value):
    if not isinstance(value, np.ndarray):
        return value
    return jnp.asarray(value) if lib == "jax" else torch.from_numpy(value)


SINKHORN_TERMS = ("emd_sinkhorn",)


def _port(fn, y_pred, d, dtype=torch.float32):
    """The port's value and gradient of ``fn`` at ``y_pred`` in ``dtype``
    (the float inputs cast to it)."""
    td = {k: _to("torch", v) for k, v in d.items()}
    td = {k: v.to(dtype) if isinstance(v, torch.Tensor)
          and v.is_floating_point() else v for k, v in td.items()}
    yp = torch.from_numpy(y_pred).to(dtype).requires_grad_(True)
    got = fn(*_port_modules(), yp, td)
    got.backward()
    return float(got), yp.grad.numpy()


def _both(term, d, exact=False):
    """(JAX value, JAX gradient, port value, port gradient) of ``term``;
    with ``exact`` also the port's float32 error on each (against its
    float64 evaluation)."""
    lam1, fn = term
    if lam1:
        d = _lambda1(d)
    jd = {k: _to("jax", v) for k, v in d.items()}
    ref, ref_g = jax.value_and_grad(
        lambda yp: fn(*_jax_modules(), yp, jd))(jnp.asarray(d["y_pred"]))
    got, got_g = _port(fn, d["y_pred"], d)
    out = [float(ref), np.asarray(ref_g), got, got_g]
    if exact:
        got64, got64_g = _port(fn, d["y_pred"], d, torch.float64)
        out += [abs(got - got64), np.abs(got_g - got64_g).max()]
    return out


@pytest.mark.parametrize("name", sorted(TERMS))
def test_term_and_its_gradient_match_jax(name, data):
    """Value within 1e-5 relative, gradient within 1e-5 · max|ref| (the
    Sinkhorn EMD with its rounding allowance, ``ROUNDING_FACTOR``)."""
    if name in SINKHORN_TERMS:
        ref, ref_g, got, got_g, own, own_g = _both(TERMS[name], data, True)
    else:
        (ref, ref_g, got, got_g), own, own_g = _both(TERMS[name], data), 0, 0
    assert np.isfinite(ref) and np.abs(ref_g).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * abs(ref)
                               + ROUNDING_FACTOR * own)
    np.testing.assert_allclose(got_g, ref_g, rtol=0,
                               atol=1e-5 * np.abs(ref_g).max()
                               + ROUNDING_FACTOR * own_g)


@pytest.mark.parametrize("name", sorted(SVD_TERMS))
def test_singular_value_terms_match_jax(name, data):
    ref, ref_g, got, got_g = _both(SVD_TERMS[name], data)
    assert ref > 1e-3
    np.testing.assert_allclose(got, ref, rtol=SVD_RTOL)
    np.testing.assert_allclose(got_g, ref_g,
                               atol=SVD_RTOL * np.abs(ref_g).max())


def test_stochastic_term_is_the_reverse_chamfer_on_its_subset(data):
    """The port draws its subset from the step's generator (JAX's key-based
    permutation cannot be reproduced), so the term is held with the subset
    given: JAX's reverse segment chamfer on the same rows. The draw itself
    gives distinct rows per sample, the same for the same generator
    state, and all rows when the GT has fewer than the predictions."""
    from maskplanner_tpu.losses.chamfer_losses import \
        reverse_asymm_segment_chamfer as jax_reverse
    from maskplanner_tpu_torch.losses.chamfer_losses import (
        random_subset, stoch_reverse_asymm_segment_chamfer)

    y_pred = data["y_pred"][:, :20]
    S = data["y"].shape[1]
    perm = random_subset(S, 20, 2, "cpu", torch.Generator().manual_seed(3))
    assert perm.shape == (2, 20)
    for row in perm:
        assert len(set(row.tolist())) == 20 and int(row.max()) < S
    assert torch.equal(perm, random_subset(
        S, 20, 2, "cpu", torch.Generator().manual_seed(3)))
    sel = np.take_along_axis(data["y"], perm.numpy()[..., None], axis=1)
    sel_mask = np.take_along_axis(data["y_mask"], perm.numpy(), axis=1)
    ref, ref_g = jax.value_and_grad(lambda yp: jax_reverse(
        yp, jnp.asarray(sel), y_mask=jnp.asarray(sel_mask)))(
            jnp.asarray(y_pred))
    yp = torch.from_numpy(y_pred).requires_grad_(True)
    got = stoch_reverse_asymm_segment_chamfer(
        yp, torch.from_numpy(data["y"]),
        y_mask=torch.from_numpy(data["y_mask"]), perm=perm)
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(yp.grad.numpy(), ref_g,
                               atol=1e-5 * np.abs(ref_g).max())
    # drawn from the generator: the same value for the same state
    gen = torch.Generator().manual_seed(3)
    drawn = stoch_reverse_asymm_segment_chamfer(
        yp.detach(), torch.from_numpy(data["y"]),
        y_mask=torch.from_numpy(data["y_mask"]), generator=gen)
    assert torch.equal(drawn, got.detach())
    # fewer GT segments than predictions: every GT segment is taken
    full = random_subset(5, 5, 2, "cpu", torch.Generator().manual_seed(0))
    assert all(sorted(r.tolist()) == list(range(5)) for r in full)


CHAMFER_FLAGS = {
    "symmetric": {},
    "asymmetric": dict(asymmetric=True),
    "reverse": dict(reverse_asymmetric=True),
    "velocities": dict(velocities=True),
    "min_centroids": dict(min_centroids=True),
    "unreduced": dict(point_reduction=None, batch_reduction=None),
    "sum": dict(point_reduction="sum", batch_reduction="sum"),
    "x_mask": dict(x_mask=True),
    "attraction": dict(avoid_in_sequence_collapsing=True),
    "attraction_soft": dict(avoid_in_sequence_collapsing=True,
                            soft_attraction=True, point_reduction=None,
                            batch_reduction=None),
}


@pytest.mark.parametrize("case", sorted(CHAMFER_FLAGS))
def test_chamfer_distance_variant_matches_jax(case, data):
    """Each variant's distance within 1e-5 relative, its gradient within
    1e-5 · max|ref|, and, with ``return_matching``, the matching indices
    of both directions equal to the JAX package's."""
    from maskplanner_tpu.ops.chamfer import chamfer_distance as jax_cd
    from maskplanner_tpu_torch.ops.chamfer import chamfer_distance

    flags = dict(CHAMFER_FLAGS[case])
    attraction = flags.get("avoid_in_sequence_collapsing", False)
    x, y, y_mask = data["y_pred"], data["y"], data["y_mask"]
    if attraction:
        y = x[:, ::-1] + np.float32(0.01)    # P1 == P2, no padding
        y_mask = None
    else:
        flags.update(padded=True, return_matching=True)
    x_mask = None
    if flags.pop("x_mask", False):
        x_mask = np.arange(x.shape[1])[None].repeat(2, 0) < [[30], [17]]
        flags["x_mask"] = x_mask
    jflags = {k: _to("jax", v) for k, v in flags.items()}
    tflags = {k: _to("torch", v) for k, v in flags.items()}

    def jax_value(xx):
        out = jax_cd(xx, jnp.asarray(y), y_mask=None if y_mask is None
                     else jnp.asarray(y_mask), **jflags)
        return jnp.sum(out[0]), out

    (ref, ref_out), ref_g = jax.value_and_grad(jax_value, has_aux=True)(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = chamfer_distance(xt, torch.from_numpy(np.ascontiguousarray(y)),
                           y_mask=None if y_mask is None
                           else torch.from_numpy(y_mask), **tflags)
    np.testing.assert_allclose(out[0].detach().numpy(),
                               np.asarray(ref_out[0]), rtol=1e-5)
    out[0].sum().backward()
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(xt.grad.numpy(), ref_g,
                               atol=1e-5 * np.abs(ref_g).max())
    assert len(out) == len(ref_out)
    if not attraction:
        for got_idx, want_idx in zip(out[2:], ref_out[2:]):
            np.testing.assert_array_equal(got_idx.numpy(),
                                          np.asarray(want_idx))


def test_attraction_breaks_ties_to_the_lower_index():
    """Exact ties in the top-2: the lower index comes first, as
    ``jax.lax.top_k`` orders them, so a tie with the own index counts as a
    self-match only where the own index is the lower one."""
    from maskplanner_tpu.ops.chamfer import chamfer_distance as jax_cd
    from maskplanner_tpu_torch.ops.chamfer import chamfer_distance

    pts = np.array([[[0, 0, 0], [1, 0, 0], [0, 0, 0], [1, 0, 0],
                     [5, 5, 5]]], np.float32)
    for soft in (False, True):
        kw = dict(avoid_in_sequence_collapsing=True, soft_attraction=soft)
        ref = jax_cd(jnp.asarray(pts), jnp.asarray(pts), **kw)[0]
        got = chamfer_distance(torch.from_numpy(pts), torch.from_numpy(pts),
                               **kw)[0]
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_sinkhorn_emd_matches_jax(data):
    """The soft EMD with both masks, its value within 1e-5 relative and
    its gradients with respect to both sets within 1e-5 · max|ref|, each
    plus ``ROUNDING_FACTOR`` times the port's own float32 error."""
    from maskplanner_tpu.ops.sinkhorn import sinkhorn_emd as jax_sinkhorn
    from maskplanner_tpu_torch.ops.sinkhorn import sinkhorn_emd

    x, y, y_mask = data["y_pred"], data["y"], data["y_mask"]
    x_mask = np.arange(x.shape[1])[None].repeat(2, 0) < [[35], [20]]
    ref, ref_g = jax.value_and_grad(
        lambda a, b: jax_sinkhorn(a, b, y_mask=jnp.asarray(y_mask),
                                  x_mask=jnp.asarray(x_mask)), (0, 1))(
        jnp.asarray(x), jnp.asarray(y))

    def port(dtype):
        xt, yt = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (x, y))
        got = sinkhorn_emd(xt, yt, y_mask=torch.from_numpy(y_mask),
                           x_mask=torch.from_numpy(x_mask))
        got.backward()
        return float(got), [xt.grad.numpy(), yt.grad.numpy()]

    (got, grads), (got64, grads64) = port(torch.float32), port(torch.float64)
    np.testing.assert_allclose(got, float(ref), rtol=0, atol=1e-5 * abs(
        float(ref)) + ROUNDING_FACTOR * abs(got - got64))
    for a, a64, g in zip(grads, grads64, ref_g):
        g = np.asarray(g)
        np.testing.assert_allclose(a, g, rtol=0, atol=1e-5 * np.abs(g).max()
                                   + ROUNDING_FACTOR * np.abs(a - a64).max())


def test_emd_takes_sinkhorn_above_the_exact_limit(data, monkeypatch):
    """Up to 128 x 128 pairs the exact assignment (the LAP), above them
    Sinkhorn, as in the JAX package (both solvers recorded, not run)."""
    from maskplanner_tpu_torch.losses import stroke_losses

    calls = []

    def hungarian(cost, col_mask):
        calls.append("exact")
        return (torch.zeros(col_mask.shape, dtype=torch.long),
                torch.ones(col_mask.shape, dtype=torch.bool))

    monkeypatch.setattr(stroke_losses, "hungarian", hungarian)
    monkeypatch.setattr(stroke_losses, "sinkhorn_emd",
                        lambda *a, **k: calls.append("sinkhorn"))
    y = torch.from_numpy(data["y"])
    rows = 128 * 128 // y.shape[1]
    for n in (rows, rows + 1):
        stroke_losses.emd(torch.zeros(2, n, y.shape[2]), y)
    assert calls == ["exact", "sinkhorn"]


def _handler_config(load, name, extra):
    return load(argv=[*SMALL, f"weight_{name}=1.0", *extra])


REGISTRY_CONFIGS = {
    "lambda4": [],
    "lambda1_knn3": ["lambda_points=1", "overlapping=0", "knn_repulsion=3"],
}


@pytest.mark.parametrize("name", [
    "chamfer", "repulsion", "mse", "align", "velcosine", "intra_align",
    "discriminator", "wdiscriminator", "attraction_chamfer",
    "rich_attraction_chamfer", "contrastive_v1", "asymm_segment_chamfer",
    "reverse_asymm_point_chamfer", "stoch_reverse_asymm_segment_chamfer",
    "reverse_asymm_segment_chamfer", "chamfer_bbox", "mse_strokes",
    "chamfer_strokes", "asymm_v6_chamfer_strokes", "masked_mse_strokes",
    "masked_mse_strokes_v2", "symm_segment_chamfer", "symm_point_chamfer",
    "mse_nexttoken", "mse_nexttoken_v2", "emd", "chamfer_with_stroke_masks",
    "asymm_v6_chamfer_with_stroke_masks",
    "asymm_v11_chamfer_with_stroke_masks",
    "symm_v1_chamfer_with_stroke_masks", "masked_mse_strokes_from_segments",
    "hungarian_SoPs"])
def test_registry_accepts_what_the_jax_handler_accepts(name):
    from maskplanner_tpu.losses import LOSS_NAMES as JAX_NAMES
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu_torch.losses import (LOSS_NAMES, PORTED, WAITING,
                                              LossHandler)

    assert LOSS_NAMES == JAX_NAMES and len(LOSS_NAMES) == 32
    assert len(PORTED) == 32 and WAITING == {}
    for extra in REGISTRY_CONFIGS.values():
        jcfg = _handler_config(jax_load_args, name, extra)
        cfg = _handler_config(load_args, name, extra)
        try:
            JaxLossHandler([name], jcfg)
            jax_ok = True
        except AssertionError:
            jax_ok = False
        if name in WAITING:
            with pytest.raises(NotImplementedError, match=WAITING[name][:20]):
                LossHandler([name], cfg)
            continue
        try:
            LossHandler([name], cfg)
            ok = True
        except AssertionError:
            ok = False
        assert ok == jax_ok, (name, extra)


def test_registry_checks_the_jax_handlers_combinations():
    """No ``chamfer`` with ``mse``, no missing weight, an unknown name
    raises, and the handler sums its terms by their weights."""
    from maskplanner_tpu_torch.losses import LossHandler

    cfg = load_args(argv=[*SMALL, "lambda_points=1", "overlapping=0"])
    with pytest.raises(AssertionError):
        LossHandler(["chamfer", "mse"], cfg)
    with pytest.raises(AssertionError, match="invalid"):
        LossHandler(["not_a_loss"], cfg)
    with pytest.raises(AssertionError, match="missing weight_chamfer_bbox"):
        LossHandler(["chamfer_bbox"], cfg)
    handler = LossHandler(["chamfer", "repulsion"], cfg)
    weights = dict(handler.init_weights(), weight_repulsion=0.5)
    rng = np.random.default_rng(0)
    y_pred = torch.from_numpy(rng.normal(size=(2, 12, 6)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(2, 10, 6)).astype(np.float32))
    total, terms = handler.compute(weights, y_pred=y_pred, y=y,
                                   y_mask=torch.ones(2, 10, dtype=bool))
    assert list(terms) == ["chamfer", "repulsion"]
    torch.testing.assert_close(
        total, terms["chamfer"] + 0.5 * terms["repulsion"], rtol=0, atol=0)


def test_registry_names_the_terms_a_graph_cannot_capture():
    """The handler says which of its terms a CUDA graph cannot capture (the
    singular values of ``align`` and ``intra_align``), and why; the driver
    asks it before it builds the graphed device-resident epoch."""
    from maskplanner_tpu_torch.losses import UNCAPTURABLE, LossHandler

    assert set(UNCAPTURABLE) == {"align", "intra_align"}
    extra = ["weight_align=1.0", "weight_intra_align=1.0",
             "weight_repulsion=1.0", "knn_repulsion=3"]
    cfg = load_args(argv=[*SMALL, *extra])          # λ = 4
    cfg1 = load_args(argv=[*SMALL, *extra, "lambda_points=1",
                           "overlapping=0"])
    for handler, want in (
            (LossHandler(["intra_align", "repulsion"], cfg), ["intra_align"]),
            (LossHandler(["repulsion", "align"], cfg1), ["align"])):
        assert list(handler.uncapturable) == want
        assert "svdvals" in handler.uncapturable[want[0]]
    assert LossHandler(["chamfer_with_stroke_masks", "repulsion"],
                       cfg).uncapturable == {}


@pytest.mark.parametrize("k", [1, 2, 4])
def test_smallest_k_takes_jax_top_k_order_and_leaves_its_input(k):
    """Ties go to the lower index, as ``jax.lax.top_k`` orders them, with
    one masked copy of the distances (the input stays as it was)."""
    from maskplanner_tpu_torch.ops.distance import smallest_k

    rng = np.random.default_rng(k)
    d = rng.integers(0, 4, size=(3, 7, 9)).astype(np.float32)   # many ties
    neg, ref_idx = jax.lax.top_k(-jnp.asarray(d), k)
    t = torch.from_numpy(d.copy())
    values, idx = smallest_k(t, k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(values.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(t.numpy(), d)
