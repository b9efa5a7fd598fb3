"""The port's bf16 serving path against the JAX package's bf16 mode, on the
CPU.

Inputs are made with numpy from a seed and go through both packages. The
JAX side takes its accelerator path (``_use_pallas`` patched to True, the
Pallas kernels in interpret mode), whose dtype rules the port follows on
every device. On the CPU, ``Precision.DEFAULT`` on float32 operands is a
full float32 product, so the interpret-mode JAX level rounds only its
feature gathers to bf16, not its products; hence two level comparisons:

- the port's bf16 level with float32 products (features gathered rounded
  to bf16 as the JAX kernel gathers them) equals the JAX
  ``fused_sa_train(precision="default")`` within the float32 level tests'
  2e-5 · max|ref| (measured 1.6e-5 for sa1's layout with LayerNorm, at
  most 2.1e-6 otherwise);
- with the port's own bf16 products (``matmul_bf16``) it lies within the
  JAX package's bf16 tolerance, 2e-2 · max|ref|
  (``tests/test_fused_sa_train.py``; measured 3.7e-3 to 5.9e-3).

The single-pass grouping equals ``ball_group_pallas(single_pass=True)``
rounded to bf16, bit for bit: the casts are explicit, and a one-hot
contraction of a bf16 value is exact.

The whole bf16 model against the JAX bf16 model, each output field, within
2e-2 · max|ref| (measured: ``layer+layer+batch`` traj 8.5e-3, masks
7.0e-3, mask scores 6.6e-3, segment confidences 7.3e-3, where the JAX
level's products are float32; ``batch`` traj 1.4e-3, the rest 0), and
against the port's own float32 model on the same converted weights within
3e-2 · max|ref| (measured 2.7e-3 to 1.34e-2, the largest traj of
``layer+layer+batch``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from maskplanner_tpu.utils.args import load_args
from maskplanner_tpu_torch.convert import state_dict_from_flax
from maskplanner_tpu_torch.models import get_model
from maskplanner_tpu_torch.ops.fused_sa import (_gather_plain, _mlp_plain,
                                                bf16_round,
                                                fused_sa_forward,
                                                fused_sa_forward_plain)
from maskplanner_tpu_torch.ops.group_gather import (ball_group,
                                                    ball_group_plain)
from maskplanner_tpu_torch.ops.sampling import ball_query_plain

torch.set_num_threads(1)

RADIUS, K = 0.35, 16
FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
FIELDS = ("traj", "stroke_masks", "mask_scores", "seg_conf")


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _sa_case(norm, with_features, B=2, N=256, S=64, chans=(32, 48)):
    rng = np.random.default_rng(1)
    xyz = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    new_xyz = xyz[:, :S].copy()
    new_xyz[:, ::7] += 50.0            # some balls empty
    # 29 features: more than 16 channels, the JAX kernel's sa2 gather
    # (xyz rows hi/lo, features single-pass bf16), not its blocked one
    feats = (rng.normal(size=(B, N, 29)).astype(np.float32)
             if with_features else None)
    ci = 3 + (29 if with_features else 0)
    params = []
    for co in chans:
        layer = [(rng.normal(size=(co, ci)) * 0.3).astype(np.float32),
                 (rng.normal(size=(co,)) * 0.1).astype(np.float32)]
        if norm == "layer":
            layer += [(rng.normal(size=(co,)) * 0.2 + 1.0).astype(np.float32),
                      (rng.normal(size=(co,)) * 0.1).astype(np.float32)]
        params.append(tuple(layer))
        ci = co
    return xyz, new_xyz, feats, tuple(params)


@pytest.mark.parametrize("product", ["f32", "bf16"])
@pytest.mark.parametrize("norm", ["layer", "none"])
@pytest.mark.parametrize("with_features", [False, True],
                         ids=["xyz", "features"])
def test_level_matches_jax_default_precision(product, norm, with_features,
                                             interpret_mode):
    from maskplanner_tpu.ops.pallas.fused_sa_train import fused_sa_train

    xyz, new_xyz, feats, params = _sa_case(norm, with_features)
    ref = np.asarray(fused_sa_train(
        RADIUS, K, norm, _j(xyz), _j(new_xyz), _j(feats),
        tuple(tuple(_j(a) for a in layer) for layer in params),
        precision="default"))
    tparams = [tuple(_t(a) for a in layer) for layer in params]
    if product == "bf16":
        got, _ = fused_sa_forward(RADIUS, K, norm, _t(xyz), _t(new_xyz),
                                  _t(feats), tparams, precision="bf16")
        tol = 2e-2
    else:
        # the interpret-mode JAX level's arithmetic: float32 products on
        # rows whose features are gathered in bf16, except the first 5,
        # which share the xyz rows' 8-row hi/lo block (``_Gather.split``;
        # on the accelerator its product rounds them to bf16 all the same)
        f = None if feats is None else torch.cat(
            [_t(feats)[..., :5], bf16_round(_t(feats)[..., 5:])], -1)
        idx = ball_query_plain(RADIUS, K, _t(xyz), _t(new_xyz))
        rows = _gather_plain(_t(xyz), _t(new_xyz), f, idx)
        got = _mlp_plain(rows, tparams, norm, torch.matmul)[-1][3].amax(2)
        tol = 2e-5
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=tol * np.abs(ref).max())


# name: (N, S, K, F, radius), as tests/test_torch_port_group.py's cases
GROUP_CASES = {"xyz-only": (384, 64, 8, 0, 0.5),
               "f5": (256, 64, 8, 5, 0.5),
               "f29": (256, 32, 4, 29, 0.5),
               "sparse": (256, 64, 8, 5, 0.15)}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_single_pass_group_matches_pallas_interpret(case, interpret_mode):
    from maskplanner_tpu.ops.pallas.group_gather import ball_group_pallas

    N, S, K_, F, r = GROUP_CASES[case]
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(2, N, 3)).astype(np.float32)
    q = xyz[:, :S].copy()
    feats = rng.normal(size=(2, N, F)).astype(np.float32) if F else None
    ref, ref_idx = ball_group_pallas(r, K_, _j(xyz), _j(q), _j(feats),
                                     single_pass=True)
    got, idx = ball_group(r, K_, _t(xyz), _t(q), _t(feats),
                          single_pass=True)
    assert got.dtype == torch.bfloat16 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    want = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


def _model_config(norm, bf16, seg_conf):
    argv = [FLAGSHIP, "pc_points=256", "model.hidden_size=[32,32]",
            "n_pred_traj_points=40", "max_n_strokes=4", f"model.norm={norm}",
            f"per_segment_confidence={str(seg_conf).lower()}"]
    return load_args(argv=argv + (["model.bf16=true"] if bf16 else []))


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


@pytest.fixture(scope="module", params=[("layer+layer+batch", True),
                                        ("batch", False)],
                ids=["layer-layer-batch-segconf", "batch"])
def bf16_models(request):
    """The JAX bf16 model on its accelerator path, and the port's bf16 and
    float32 models on the same converted weights, on 2 clouds of 256
    points -> (JAX bf16 outputs, port bf16 outputs, port float32 outputs,
    the converted state dict)."""
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.models import pointnet2 as flax_pointnet2

    norm, seg_conf = request.param
    mp = pytest.MonkeyPatch()
    # the port's distances are the JAX package's fixed-order form
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    rng = np.random.default_rng(256)
    pc = (rng.normal(size=(2, 256, 3)) * 0.5).astype(np.float32)
    flax_model = get_flax_model(_model_config(norm, True, seg_conf))
    variables = flax_model.init(jax.random.PRNGKey(1), jnp.asarray(pc),
                                train=False)
    variables = _perturb(variables, rng)
    orig = pl.pallas_call
    mp.setattr(pl, "pallas_call",
               lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    mp.setattr(flax_pointnet2, "_use_pallas", lambda: True)
    try:
        ref = flax_model.apply(variables, jnp.asarray(pc), train=False)
    finally:
        mp.undo()
    state = state_dict_from_flax(variables)
    outs = []
    for bf16 in (True, False):
        model = get_model(_model_config(norm, bf16, seg_conf), device="cpu")
        model.load_state_dict(state, strict=True)
        with torch.inference_mode():
            outs.append(model(torch.from_numpy(pc)))
    return ref, outs[0], outs[1], state


def _compare(a, b, rel):
    if a is None:
        assert b is None
        return
    a, b = np.asarray(a), b.numpy()
    assert b.shape == a.shape and b.dtype == np.float32
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b, a, atol=rel * np.abs(a).max())


@pytest.mark.parametrize("field", FIELDS)
def test_bf16_model_matches_jax_bf16_model(bf16_models, field):
    ref, got, _, _ = bf16_models
    _compare(getattr(ref, field), getattr(got, field), 2e-2)


@pytest.mark.parametrize("field", FIELDS)
def test_bf16_model_against_its_own_f32(bf16_models, field):
    _, got, f32, _ = bf16_models
    a = getattr(f32, field)
    _compare(None if a is None else a.numpy(), getattr(got, field), 3e-2)


def test_bf16_model_loads_the_f32_parameters(bf16_models):
    """``state_dict_from_flax`` of the JAX bf16 model loads the port's bf16
    model unchanged: the parameters are float32 in both packages."""
    *_, state = bf16_models
    assert all(t.dtype == torch.float32 for t in state.values()
               if t.is_floating_point())
    model = get_model(_model_config("layer+layer+batch", True, True),
                      device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.cuda
class TestKernelsOnCard:
    """The bf16 kernel modes against their plain versions on the card, as
    chip_smoke.py's bf16 phases."""

    @pytest.fixture
    def cuda_device(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda")

    @pytest.mark.parametrize("norm", ["layer", "none"])
    @pytest.mark.parametrize("with_features", [False, True],
                             ids=["xyz", "features"])
    def test_bf16_level_kernel_matches_plain(self, norm, with_features,
                                             cuda_device):
        """Indices equal; pooled within 3x the plain level's spread between
        float32 and float64 sums of the same bf16 operands."""
        from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_bf16_cuda

        xyz, new_xyz, feats, params = _sa_case(norm, with_features)
        args = [None if a is None else _t(a).to(cuda_device)
                for a in (xyz, new_xyz, feats)]
        tparams = [tuple(_t(a).to(cuda_device) for a in layer)
                   for layer in params]
        got, idx = fused_sa_bf16_cuda(RADIUS, K, norm == "layer", *args,
                                      tparams)
        ref, ref_idx = fused_sa_forward_plain(RADIUS, K, norm, *args,
                                              tparams, precision="bf16")
        ref64, _ = fused_sa_forward_plain(
            RADIUS, K, norm, *(None if a is None else a.double()
                               for a in args),
            [tuple(a.double() for a in layer) for layer in tparams],
            precision="bf16")
        assert torch.equal(idx, ref_idx)
        spread = float((ref.double() - ref64).abs().max())
        assert float((got.double() - ref64).abs().max()) <= 3.0 * spread

    @pytest.mark.parametrize("case", sorted(GROUP_CASES))
    def test_single_pass_kernel_matches_plain(self, case, cuda_device):
        from maskplanner_tpu_torch.ops.cuda.group_gather import \
            ball_group_single_cuda

        N, S, K_, F, r = GROUP_CASES[case]
        rng = np.random.default_rng(0)
        xyz = rng.normal(size=(2, N, 3)).astype(np.float32)
        feats = rng.normal(size=(2, N, F)).astype(np.float32) if F else None
        args = [None if a is None else _t(a).to(cuda_device)
                for a in (xyz, xyz[:, :S].copy(), feats)]
        got, idx = ball_group_single_cuda(r, K_, *args)
        ref, ref_idx = ball_group_plain(r, K_, *args, single_pass=True)
        assert torch.equal(idx, ref_idx) and torch.equal(got, ref)
