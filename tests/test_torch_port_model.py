"""The PyTorch port's MaskPlanner model against the Flax model, on the CPU.

A Flax ``PointNet2StrokeMasks`` is initialised, its parameters and BatchNorm
running statistics are perturbed with numpy noise (so that the conversion of
every tensor shows in the outputs), the tree is converted with
``state_dict_from_flax``, and all four eval outputs are compared.

Tolerance rtol 1e-4, atol 1e-5: Flax's LayerNorm takes the variance as
E[x²] − E[x]² while the port centres first, and the two frameworks sum the
matmuls in different orders; both differences are f32 rounding.

The BatchNorm recipe (``model.norm=batch``) and a hybrid with BatchNorm at
sa2 are held against two JAX references: the plain XLA path, and the path
the JAX package takes on its accelerator (``_use_pallas`` patched to True,
the Pallas kernels in interpret mode): the ball-group gather kernel, and at
sa2 the Dense/ReLU chain with the BatchNorm folded into its weights.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu.utils.args import load_args
from maskplanner_tpu_torch.convert import state_dict_from_flax
from maskplanner_tpu_torch.models import (compute_out_vectors, get_io_info,
                                          get_model)
from maskplanner_tpu_torch.models.pointnet2 import level_norms

torch.set_num_threads(1)

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"


def _small_config(pc_points, seg_conf, norm="layer+layer+batch"):
    return load_args(argv=[
        FLAGSHIP, f"pc_points={pc_points}",
        f"per_segment_confidence={str(seg_conf).lower()}",
        "model.hidden_size=[32,32]", "n_pred_traj_points=40",
        "max_n_strokes=4", f"model.norm={norm}"])


def _perturb(variables, rng):
    def noise(path, a):
        leaf = path[-1].key
        if leaf in ("bias", "mean"):
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if leaf == "scale":
            return (1.0 + rng.normal(size=a.shape) * 0.1).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return np.asarray(a)
    return jax.tree_util.tree_map_with_path(noise, variables)


@pytest.fixture(scope="module", params=[
    (64, True, "layer+layer+batch", "xla"),
    (1024, False, "layer+layer+batch", "xla"),
    (256, False, "none+batch+layer", "xla"),
    (256, False, "batch", "xla"),
    (256, False, "batch", "folded"),
    (256, True, "layer+batch+batch", "xla"),
    (256, True, "layer+batch+batch", "folded")],
    ids=["pc64-segconf", "pc1024", "pc256-none-batch-layer", "pc256-batch",
         "pc256-batch-folded", "pc256-layer-batch-batch",
         "pc256-layer-batch-batch-folded"])
def both_models(request, monkeypatch_module):
    from jax.experimental import pallas as pl

    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.models import pointnet2 as flax_pointnet2

    # the port's distances are the JAX package's fixed-order form
    monkeypatch_module.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    pc_points, seg_conf, norm, reference = request.param
    cfg = _small_config(pc_points, seg_conf, norm)
    rng = np.random.default_rng(pc_points)
    pc = (rng.normal(size=(2, pc_points, 3)) * 0.5).astype(np.float32)
    flax_model = get_flax_model(cfg)
    variables = flax_model.init(jax.random.PRNGKey(1), jnp.asarray(pc),
                                train=False)
    variables = _perturb(variables, rng)
    ref = flax_model.apply(variables, jnp.asarray(pc), train=False)
    ref_error = None
    if reference == "folded":
        with pytest.MonkeyPatch.context() as mp:
            orig = pl.pallas_call
            mp.setattr(pl, "pallas_call",
                       lambda *a, **k: orig(*a, **{**k, "interpret": True}))
            mp.setattr(flax_pointnet2, "_use_pallas", lambda: True)
            xla, ref = ref, flax_model.apply(variables, jnp.asarray(pc),
                                             train=False)
        # the accelerator path's own distance from the XLA path
        ref_error = {f: None if getattr(ref, f) is None else
                     np.abs(np.asarray(getattr(ref, f))
                            - np.asarray(getattr(xla, f)))
                     for f in ("traj", "stroke_masks", "mask_scores",
                               "seg_conf")}

    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    with torch.inference_mode():
        out = model(torch.from_numpy(pc))
    return cfg, ref, out, ref_error


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("field", ["traj", "stroke_masks", "mask_scores",
                                   "seg_conf"])
def test_forward_matches_flax(both_models, field):
    """Within rtol 1e-4, atol 1e-5 of the reference. Against the JAX
    accelerator path the allowance grows by that path's own distance from
    the XLA path, element by element: its LayerNorm level (``fused_sa_train``)
    gathers through a hi/lo bf16 split, which at pc256 moves the
    ``layer+batch+batch`` outputs by up to 5.5e-5 · max|traj|, where the
    port lies within 4.3e-6 · max|traj| of the XLA path (ROADMAP.md,
    Queue 3)."""
    cfg, ref, out, ref_error = both_models
    a, b = getattr(ref, field), getattr(out, field)
    if a is None:
        assert b is None
        return
    b = b.numpy()
    a = np.asarray(a)
    assert b.shape == a.shape and np.isfinite(b).all()
    if ref_error is None:
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_array_less(
            np.abs(b - a), 1e-5 + 1e-4 * np.abs(a) + ref_error[field] + 1e-12)


def test_output_shapes(both_models):
    cfg, _, out, _ = both_models
    info = get_io_info("MaskPlanner", cfg)
    v, m = info["out_vectors"], info["n_stroke_masks"]
    assert out.traj.shape == (2, v, cfg["lambda_points"] * 6)
    assert out.stroke_masks.shape == (2, m, v)
    assert out.mask_scores.shape == (2, m)


def test_state_dict_names_follow_the_original_repo():
    model = get_model(_small_config(64, True), device="cpu")
    names = set(model.state_dict())
    for name in ["sa1.mlp_convs.0.weight", "sa1.mlp_lns.2.bias",
                 "sa3.mlp_bns.1.running_var", "fc1.weight", "bn2.bias",
                 "fc3.weight", "fc_normals.bias", "sm_fc3.weight",
                 "sm_bn1.running_mean", "mask_conf_out.weight",
                 "seg_conf_fc2.weight", "seg_conf_out.bias"]:
        assert name in names, name


def test_flagship_io_sizes_match_jax():
    from maskplanner_tpu.models import compute_out_vectors as jax_cov
    from maskplanner_tpu.models import get_io_info as jax_io

    cfg = load_args(argv=[FLAGSHIP])
    assert compute_out_vectors(cfg) == jax_cov(cfg) == 449
    assert get_io_info("MaskPlanner", cfg) == jax_io("MaskPlanner", cfg)


def test_seeded_init_is_reproducible():
    cfg = _small_config(64, False)
    a = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = get_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), k


def test_unported_backbone_and_norm_spec_raise():
    cfg = _small_config(64, False)
    cfg["model"]["backbone"] = "pointnet2"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(cfg, device="cpu")
    with pytest.raises(ValueError):
        level_norms("layer+batch")


def test_training_forward_of_every_norm_gives_gradients():
    """The train forward runs for the fused (LayerNorm / no-norm) levels and
    for the grouped BatchNorm levels, and every encoder weight gets a
    gradient; an unknown norm raises."""
    for norm in ("layer+layer+batch", "batch"):
        model = get_model(_small_config(64, False, norm=norm),
                          device="cpu").train()
        out = model(torch.randn(2, 64, 3) * 0.5,
                    generator=torch.Generator().manual_seed(0))
        assert out.traj.requires_grad
        out.traj.square().sum().backward()
        for name, p in model.named_parameters():
            if name.startswith(("sa1.", "sa2.")) and name.endswith("weight"):
                assert p.grad is not None and bool(p.grad.abs().sum() > 0), \
                    (norm, name)
    with pytest.raises(ValueError, match="unknown norm"):
        get_model(_small_config(64, False, norm="group"), device="cpu")
