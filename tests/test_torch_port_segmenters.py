"""The port's segmenters and PointNet family against the JAX package's, on
the CPU.

``ops.sampling.knn`` (masked, with ties), ``FeaturePropagation``, the
PointNet models (``STNkd``, ``PointNetFeat``, the regressor with its
batch-1 bypass, both segmenters), both PointNet++ segmenters (sa1's
``full_points`` grouping with ``ball_in_xyz_space``, and FPS asked for more
centres than there are points), ``contrastive_v1`` (alone and through the
segmenter), the factory's new names and raises, and the weights both ways.
The same seeded numpy inputs go through both packages, with the JAX
weights carried over by ``convert.py``; the JAX distances take their
fixed-order form (``MASKPLANNER_DETERMINISTIC_NN``), which the port uses,
and nothing here reaches a Pallas kernel on the CPU.

Tolerances: eval outputs within 1e-5 · max|ref|; in train mode the
outputs and the moved BatchNorm statistics within 1e-5 · max|ref| (1e-6
for the statistics) plus ``ROUNDING_FACTOR`` times the port's own float32
error on the tensor (its float32 result against its float64 one), the
step tests' rule for Flax's E[x²] − E[x]² variance, plus 3 x the JAX
forward's own float32 rounding, sampled by the same forward on the
reversed batch (the λ = 22 step's rule: on the segmenters the JAX f32
BatchNorm statistics lie many times further from the port's float64 ones
than the port's float32 ones do, and the heads' BatchNorms over few rows
amplify that); kNN indices identical
and distances bit for bit; a loss within 1e-5 relative, its gradient
within 1e-4 of the reference's norm.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

ROUNDING_FACTOR = 10
LAMBDA1 = ["config=[pointWise,cuboids_v2,longx_v2]", "latent_dim=5"]
LAMBDA4 = ["config=[segmentWise,cuboids_v2,longx_v2]", "latent_dim=5"]


@pytest.fixture(scope="module", autouse=True)
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


def _init(module, *args, **kw):
    return _perturbed(module.init(jax.random.PRNGKey(0), *args, train=False,
                                  **kw))


def _port(module, variables):
    from maskplanner_tpu_torch.convert import state_dict_from_flax

    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    return module.eval()


def _no_dropout(mp):
    import flax.linen as fnn

    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def assert_eval_matches(flax_module, variables, port, args, jax_kw=None,
                        port_kw=None):
    """Eval outputs within 1e-5 · max|ref|."""
    ref = flax_module.apply(variables, *(jnp.asarray(a) for a in args),
                            train=False, **(jax_kw or {}))
    with torch.no_grad():
        got = port.eval()(*(torch.from_numpy(a) for a in args),
                          **(port_kw or {}))
    for a, b in zip(_as_list(ref), _as_list(got)):
        a = np.asarray(a)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-5 * np.abs(a).max())


def _port_train(port, args, dtype, kw):
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    m = copy.deepcopy(port).to(dtype).train()
    with torch.no_grad():
        out = m(*(torch.from_numpy(a).to(dtype) for a in args), **kw)
    stats = flax_tree_from_state_dict(m.state_dict()).get("batch_stats", {})
    return [t.double().numpy() for t in _as_list(out)], stats


def _jax_train(flax_module, variables, args, kw, reverse=False):
    """The JAX train forward (dropout off) -> (outputs, moved statistics);
    with ``reverse`` on the batch in reverse order, its outputs put back in
    order (a sample of JAX's own float32 rounding: its reductions sum in
    another order)."""
    flip = (lambda a: a[::-1]) if reverse else (lambda a: a)
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        ref, mutated = flax_module.apply(
            variables, *(jnp.asarray(flip(a)) for a in args), train=True,
            mutable=["batch_stats"],
            **{k: jnp.asarray(flip(np.asarray(v))) for k, v in kw.items()})
    return ([flip(np.asarray(a)) for a in _as_list(ref)],
            _leaves(mutated.get("batch_stats", {})))


def assert_train_matches(flax_module, variables, port, args, jax_kw=None,
                         port_kw=None, n_stats=None):
    """Train mode (dropout off, FPS from index 0): outputs within
    1e-5 · max|ref| and the moved statistics within 1e-6, each plus
    ROUNDING_FACTOR times the port's float32 error and 3 x the JAX
    forward's own (its distance from itself on the reversed batch) -> the
    port's moved statistics."""
    jax_kw = jax_kw or {}
    ref, want = _jax_train(flax_module, variables, args, jax_kw)
    ref_r, want_r = _jax_train(flax_module, variables, args, jax_kw, True)
    out, stats = _port_train(port, args, torch.float32, port_kw or {})
    out64, stats64 = _port_train(port, args, torch.float64, port_kw or {})
    for a, a_r, b, exact in zip(ref, ref_r, out, out64):
        np.testing.assert_allclose(
            b, a, rtol=0, atol=1e-5 * np.abs(a).max()
            + ROUNDING_FACTOR * np.abs(b - exact).max()
            + 3.0 * np.abs(a - a_r).max())
    got, exact = _leaves(stats), _leaves(stats64)
    assert got.keys() == want.keys()
    if n_stats is not None:
        assert len(want) == n_stats
    for key, b in want.items():
        np.testing.assert_allclose(
            got[key], b, rtol=0, atol=1e-6 + ROUNDING_FACTOR
            * np.abs(got[key] - exact[key]).max()
            + 3.0 * np.abs(b - want_r[key]).max(), err_msg=key)
    return got


def assert_round_trip(variables):
    from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                               state_dict_from_flax)

    back = flax_tree_from_state_dict(state_dict_from_flax(variables))
    want, got = _leaves(variables), _leaves(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------------- knn

def _knn_inputs(ties: bool, seed=0):
    rng = np.random.default_rng(seed)
    if ties:    # a small integer grid: many exactly equal distances
        q = rng.integers(0, 3, (2, 7, 3)).astype(np.float32)
        p = rng.integers(0, 3, (2, 19, 3)).astype(np.float32)
    else:
        q = rng.normal(size=(2, 7, 5)).astype(np.float32)
        p = rng.normal(size=(2, 19, 5)).astype(np.float32)
    mask = rng.random((2, 19)) > 0.3
    return q, p, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_knn_matches_jax(masked, ties):
    """Indices identical (ties to the lower index), squared distances bit
    for bit, masked points at the JAX ``_BIG``."""
    from maskplanner_tpu.ops.sampling import knn as jax_knn
    from maskplanner_tpu_torch.ops.sampling import knn

    q, p, mask = _knn_inputs(ties)
    m = mask if masked else None
    ref_d, ref_i = jax_knn(6, jnp.asarray(q), jnp.asarray(p),
                           None if m is None else jnp.asarray(m))
    d, i = knn(6, torch.from_numpy(q), torch.from_numpy(p),
               None if m is None else torch.from_numpy(m))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))
    assert bool((d[:, :, 1:] >= d[:, :, :-1]).all())


def test_knn_expanded_matches_jax_default_form(monkeypatch):
    """The matmul expansion (the DGCNN graph's form) against the JAX
    package's default form: the same indices, distances within 1e-5 of
    their largest."""
    from maskplanner_tpu.ops.sampling import knn as jax_knn
    from maskplanner_tpu_torch.ops.sampling import knn

    monkeypatch.delenv("MASKPLANNER_DETERMINISTIC_NN")
    q, p, _ = _knn_inputs(False)
    ref_d, ref_i = jax_knn(6, jnp.asarray(q), jnp.asarray(p))
    d, i = knn(6, torch.from_numpy(q), torch.from_numpy(p), expanded=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref_d)).max())


# ---------------------------------------------------- feature propagation

def _fp_state(variables):
    """The Flax FeaturePropagation tree -> the port's state dict."""
    sd = {}
    for col, leaf_of in (("params", {"kernel": "weight", "scale": "weight",
                                     "bias": "bias"}),
                         ("batch_stats", {"mean": "running_mean",
                                          "var": "running_var"})):
        for mod, leaves in variables[col]["PointMLP_0"].items():
            kind, j = mod.split("_")
            name = ("mlp_convs" if kind == "Dense" else "mlp_bns") + f".{j}"
            for leaf, arr in leaves.items():
                arr = np.asarray(arr)
                sd[f"{name}.{leaf_of[leaf]}"] = torch.tensor(
                    arr.T if leaf == "kernel" else arr)
            if col == "batch_stats":
                sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.mark.parametrize("s", [1, 9])
@pytest.mark.parametrize("with_feat1", [False, True])
def test_feature_propagation_matches_jax(s, with_feat1):
    """S = 1 (broadcast) and S > 1 (inverse-distance 3-NN), with and
    without ``feat1``: eval and train outputs and statistics."""
    from maskplanner_tpu.models.pointnet2 import FeaturePropagation as JaxFP
    from maskplanner_tpu_torch.models.pointnet2 import FeaturePropagation

    # 4 clouds: at S = 1 without feat1 a cloud's rows are all one row
    rng = np.random.default_rng(1)
    xyz1 = rng.normal(size=(4, 23, 3)).astype(np.float32)
    xyz2 = rng.normal(size=(4, s, 3)).astype(np.float32)
    feat1 = rng.normal(size=(4, 23, 4)).astype(np.float32)
    feat2 = rng.normal(size=(4, s, 6)).astype(np.float32)
    f1 = feat1 if with_feat1 else None
    flax_fp = JaxFP(mlp=(16, 8))
    variables = _perturbed(flax_fp.init(
        jax.random.PRNGKey(0), jnp.asarray(xyz1), jnp.asarray(xyz2),
        None if f1 is None else jnp.asarray(f1), jnp.asarray(feat2),
        train=False))
    port = FeaturePropagation(6 + (4 if with_feat1 else 0), (16, 8))
    port.load_state_dict(_fp_state(variables), strict=True)
    jargs = (jnp.asarray(xyz1), jnp.asarray(xyz2),
             None if f1 is None else jnp.asarray(f1), jnp.asarray(feat2))
    targs = (torch.from_numpy(xyz1), torch.from_numpy(xyz2),
             None if f1 is None else torch.from_numpy(f1),
             torch.from_numpy(feat2))
    ref = np.asarray(flax_fp.apply(variables, *jargs, train=False))
    with torch.no_grad():
        got = port.eval()(*targs).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    ref, mutated = flax_fp.apply(variables, *jargs, train=True,
                                 mutable=["batch_stats"])
    ref = np.asarray(ref)
    outs = {}
    for dtype in (torch.float32, torch.float64):
        m = copy.deepcopy(port).to(dtype).train()
        with torch.no_grad():
            outs[dtype] = (m(*(None if t is None else t.to(dtype)
                               for t in targs)).double().numpy(),
                           m.mlp_bns[1].running_var.double().numpy())
    (out, var), (out64, var64) = outs.values()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max()
                               + ROUNDING_FACTOR * np.abs(out - out64).max())
    want = np.asarray(mutated["batch_stats"]["PointMLP_0"]["BatchNorm_1"]
                      ["var"])
    np.testing.assert_allclose(var, want, rtol=0, atol=1e-6 + ROUNDING_FACTOR
                               * np.abs(var - var64).max())


# ----------------------------------------------------------- PointNet

def _cloud(n=40, b=2, d=3, seed=2):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, n, d)).astype(np.float32)


REGRESSORS = {
    # affine and feature transforms, the plain and the deeper extractor
    "transforms": dict(affinetrans=True, feature_transform=True),
    "deeper": dict(deeper=True),
}


@pytest.fixture(scope="module", params=sorted(REGRESSORS))
def regressor(request):
    from maskplanner_tpu.models.pointnet import PointNetRegressor as Jax
    from maskplanner_tpu_torch.models.pointnet import PointNetRegressor

    kw = REGRESSORS[request.param]
    flax_m = Jax(out_vectors=4, outdim=3, hidden_size=(32, 32), **kw)
    variables = _init(flax_m, jnp.asarray(_cloud()))
    port = _port(PointNetRegressor(4, 3, hidden_size=(32, 32), dropout=0.0,
                                   **kw), variables)
    return flax_m, variables, port


def test_pointnet_regressor_eval_matches_jax(regressor):
    flax_m, variables, port = regressor
    assert_eval_matches(flax_m, variables, port, (_cloud(),))


def test_pointnet_regressor_train_matches_jax(regressor):
    flax_m, variables, port = regressor
    assert_train_matches(flax_m, variables, port, (_cloud(),))


def test_pointnet_regressor_batch_one_bypass(regressor):
    """At batch 1 the head's BatchNorms are bypassed: the outputs and every
    statistic as in JAX, and the head's statistics unmoved."""
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    flax_m, variables, port = regressor
    x = _cloud(b=1)
    assert_eval_matches(flax_m, variables, port, (x,))
    got = assert_train_matches(flax_m, variables, port, (x,))
    before = _leaves(flax_tree_from_state_dict(port.state_dict())
                     ["batch_stats"])
    for k in ("['BatchNorm_0']['mean']", "['BatchNorm_1']['var']"):
        np.testing.assert_array_equal(got[k], before[k])
    # the extractor's BatchNorms run in train mode and move theirs
    key = "['feat']['bn3']['mean']"
    assert not np.array_equal(got[key], before[key])


def test_pointnet_regressor_weights_convert_both_ways(regressor):
    assert_round_trip(regressor[1])


@pytest.fixture(scope="module")
def pointnet_segmenter():
    from maskplanner_tpu.models.pointnet import PointNetSegmenter as Jax
    from maskplanner_tpu_torch.models.pointnet import PointNetSegmenter

    x = _cloud(d=6)
    one_hot = np.eye(3, dtype=np.float32)[[0, 2]]
    flax_m = Jax(outdim=5, affinetrans=False)
    variables = _init(flax_m, jnp.asarray(x),
                      one_hot_encoding_sample=jnp.asarray(one_hot))
    port = _port(PointNetSegmenter(5, augment_point_features_by=3,
                                   inputdim=6), variables)
    return flax_m, variables, port, x, one_hot


def test_pointnet_segmenter_matches_jax(pointnet_segmenter):
    """With its one-hot conditioning, eval and train."""
    flax_m, variables, port, x, one_hot = pointnet_segmenter
    jkw = dict(one_hot_encoding_sample=jnp.asarray(one_hot))
    tkw = dict(one_hot_encoding_sample=torch.from_numpy(one_hot))
    assert_eval_matches(flax_m, variables, port, (x,), jkw, tkw)
    assert_train_matches(flax_m, variables, port, (x,), jkw, tkw, n_stats=12)
    assert_round_trip(variables)


@pytest.mark.parametrize("normals_only", [False, True])
def test_pointnet_segmenter_conv1d_matches_jax(normals_only):
    """λ = 2 segments of two 6-value poses; with ``input_normals_only`` the
    orientations alone."""
    from maskplanner_tpu.models.pointnet import (
        PointNetSegmenterConv1d as Jax)
    from maskplanner_tpu_torch.models.pointnet import PointNetSegmenterConv1d

    x = _cloud(d=12)
    flax_m = Jax(outdim=5, lambda_points=2, input_normals_only=normals_only)
    variables = _init(flax_m, jnp.asarray(x))
    port = _port(PointNetSegmenterConv1d(5, 2, normals_only, inputdim=12),
                 variables)
    assert_eval_matches(flax_m, variables, port, (x,))
    assert_train_matches(flax_m, variables, port, (x,))
    assert_round_trip(variables)


# ------------------------------------------------- PointNet++ segmenters

def _segment_cloud(n, d, half=0.3, seed=3):
    """(4, n, d) λ-segments of poses in a cube of side 2 · ``half`` (4
    clouds: the heads' train-mode BatchNorms see the global feature of each
    cloud as one row repeated, and normalise over those few values)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(-half, half, (4, n, d))).astype(np.float32)


# (backbone, config, N, the cube's half side): λ=4 segments of 6-value
# poses grouped in full (``ball_in_xyz_space``), λ=1 poses as sa1's points
# (6 coordinates, on the CPU), the PaintNet segmenter on 3-d points; N
# below and above sa1's 512 centres. The balls of sa1 (radius 0.2) must hold
# several points, else its rows are nearly constant and its train-mode
# BatchNorm amplifies any rounding
V1 = "pointnet2_segmenter_v1"
PAINTNET = "pointnet2_segmenter_paintnet_v1"
SEGMENTER_CASES = {
    "v1_ball_in_xyz_N48": (V1, [*LAMBDA4, "ball_in_xyz_space=true"], 48,
                           0.3),
    "v1_ball_in_xyz_N600": (V1, [*LAMBDA4, "ball_in_xyz_space=true"], 600,
                            0.3),
    "v1_poses_as_points_N48": (V1, LAMBDA1, 48, 0.05),
    "v1_poses_as_points_N600": (V1, LAMBDA1, 600, 0.05),
    "paintnet_N48": (PAINTNET, LAMBDA4, 48, 0.3),
    "paintnet_N600": (PAINTNET, LAMBDA4, 600, 0.3),
}
# train mode where N > 512: with fewer points FPS repeats index 0 for the
# rest of sa1's centres, and the JAX float32 BatchNorm sums over those
# hundreds of identical groups drift from the float64 truth far further
# than the port's float32 sums do, past what the reversed batch samples
# (ROADMAP.md, Queue 3: the segmenters)
TRAIN_CASES = [k for k in SEGMENTER_CASES if k.endswith("N600")]


def _segmenter_pair(which, argv, n, half=0.3):
    from maskplanner_tpu.models import get_io_info as jax_io
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu_torch.models import get_model

    io = "ContrastiveClustering" if which == "pointnet2_segmenter_v1" \
        else "MaskPlanner"
    jcfg = jax_load_args(argv=[*argv, f"model.backbone={which}"])
    cfg = load_args(argv=[*argv, f"model.backbone={which}"])
    d = jax_io(io, jcfg)["inputdim"] if io != "MaskPlanner" else 3
    x = _segment_cloud(n, d, half)
    flax_m = get_flax_model(jcfg)
    variables = _init(flax_m, jnp.asarray(x))
    port = _port(get_model(cfg, device="cpu", io_type=io), variables)
    return flax_m, variables, port, x


@pytest.fixture(scope="module")
def segmenter(request):
    return _segmenter_pair(*SEGMENTER_CASES[request.param])


@pytest.mark.parametrize("segmenter", sorted(SEGMENTER_CASES),
                         indirect=True)
def test_pointnet2_segmenter_eval_matches_jax(segmenter):
    """Eval outputs; the PaintNet segmenter's orientations of length
    ``weight_orient``."""
    from maskplanner_tpu_torch.models import (PointNet2Segmenter,
                                              PointNet2SegmenterPaintNet)

    flax_m, variables, port, x = segmenter
    assert type(port) in (PointNet2Segmenter, PointNet2SegmenterPaintNet)
    assert_eval_matches(flax_m, variables, port, (x,))
    if type(port) is PointNet2SegmenterPaintNet:
        with torch.no_grad():
            out = port(torch.from_numpy(x)).reshape(*x.shape[:2], 4, 6)
        torch.testing.assert_close(
            torch.linalg.vector_norm(out[..., 3:], dim=-1),
            torch.full(out.shape[:3], port.weight_orient))


@pytest.mark.parametrize("segmenter", TRAIN_CASES, indirect=True)
def test_pointnet2_segmenter_train_matches_jax(segmenter):
    flax_m, variables, port, x = segmenter
    assert_train_matches(flax_m, variables, port, (x,), n_stats=24)


@pytest.mark.parametrize("segmenter", TRAIN_CASES, indirect=True)
def test_pointnet2_segmenter_weights_convert_both_ways(segmenter):
    assert_round_trip(segmenter[1])


def test_full_points_grouping_is_not_centred():
    """sa1 with ``full_points`` groups the neighbours' full vectors as they
    are (the JAX quirk), found by FPS and the ball on the R³ centroids."""
    from maskplanner_tpu_torch.models.pointnet2 import SetAbstraction
    from maskplanner_tpu_torch.ops.sampling import (ball_query_plain,
                                                    index_points)

    x = torch.from_numpy(_segment_cloud(40, 24))
    xyz = x.reshape(4, 40, 4, 6)[..., :3].mean(-2)
    sa = SetAbstraction(16, 0.2, 8, 24, (8,), False, "batch").eval()
    seen = {}
    sa.run_mlp = lambda g: seen.setdefault("g", g)
    sa(xyz, None, None, full_points=x)
    new_xyz = index_points(xyz, torch.zeros(4, 1, dtype=torch.int64))
    idx = ball_query_plain(0.2, 8, xyz, new_xyz)
    torch.testing.assert_close(seen["g"][:, :1], index_points(x, idx),
                               rtol=0, atol=0)


# -------------------------------------------------------- contrastive_v1

def _latents_and_ids(seed=4):
    rng = np.random.default_rng(seed)
    lat = rng.normal(size=(2, 30, 5)).astype(np.float32)
    ids = rng.integers(0, 4, (2, 30)).astype(np.int32)
    ids[:, -5:] = -1                 # padding: zero one-hot rows
    return lat, ids


@pytest.mark.parametrize("balance", [False, True])
def test_contrastive_v1_matches_jax(balance):
    """Value and gradient with respect to the latents through each
    package's handler term; the balanced negatives from one uniform draw
    (JAX's, fed to the port)."""
    from maskplanner_tpu.losses import regularizers as JR
    from maskplanner_tpu_torch.losses import regularizers as R

    lat, ids = _latents_and_ids()
    key = jax.random.PRNGKey(7)
    uniform = np.array(jax.random.uniform(key, (2, 30, 30)))
    ref, ref_g = jax.value_and_grad(lambda z: JR.contrastive_v1(
        z, jnp.asarray(ids), key, margin=0.3, balance_negatives=balance,
        n_strokes_max=6))(jnp.asarray(lat))
    t = torch.from_numpy(lat).requires_grad_(True)
    got = R.contrastive_v1(t, torch.from_numpy(ids), margin=0.3,
                           balance_negatives=balance, n_strokes_max=6,
                           uniform=torch.from_numpy(uniform))
    got.backward()
    _assert_loss_and_gradient(float(ref), np.asarray(ref_g), got.item(),
                              t.grad.numpy())


def _assert_loss_and_gradient(ref, ref_g, got, got_g):
    assert np.isfinite(ref) and ref != 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    norm = np.sqrt((np.asarray(ref_g, np.float64) ** 2).sum())
    assert norm > 0
    err = np.sqrt(((got_g - ref_g).astype(np.float64) ** 2).sum())
    assert err <= 1e-4 * norm, (err, norm)


# the contrastive task's segmenter: λ=4 segments, ``ball_in_xyz_space``
@pytest.mark.parametrize("segmenter", ["v1_ball_in_xyz_N48"], indirect=True)
def test_contrastive_v1_through_handler_and_segmenter(segmenter):
    """The registry's ``contrastive_v1`` on the segmenter's latents: value
    and the gradient of all parameters (eval mode) within 1e-4 of its norm
    against JAX's, the uniform draw fed to both."""
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict
    from maskplanner_tpu_torch.losses import LossHandler, regularizers as R

    flax_m, variables, port, x = segmenter
    argv = [*LAMBDA4, "loss=[contrastive_v1]", "weight_contrastive_v1=0.5",
            "max_n_strokes=6"]
    ids = np.random.default_rng(5).integers(
        -1, 4, x.shape[:2]).astype(np.int32)
    key = jax.random.PRNGKey(9)
    jh = JaxLossHandler(["contrastive_v1"], jax_load_args(argv=argv))

    def jax_loss(params):
        lat = flax_m.apply({**variables, "params": params},
                           jnp.asarray(x), train=False)
        return jh.compute(jh.init_weights(), rng=key, latent_segments=lat,
                          stroke_ids=jnp.asarray(ids))[0]

    ref, ref_g = jax.value_and_grad(jax_loss)(variables["params"])
    h = LossHandler(["contrastive_v1"], load_args(argv=argv))
    uniform = torch.from_numpy(np.array(jax.random.uniform(
        key, (x.shape[0], x.shape[1], x.shape[1]))))
    real = R.contrastive_v1
    port.zero_grad()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(R, "contrastive_v1",
                   lambda *a, **k: real(*a, **k, uniform=uniform))
        total, _ = h.compute(h.init_weights(),
                             latent_segments=port.eval()(
                                 torch.from_numpy(x)),
                             stroke_ids=torch.from_numpy(ids))
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    grads = _leaves(flax_tree_from_state_dict(
        {n: p.grad for n, p in port.named_parameters()})["params"])
    want = _leaves(ref_g)
    assert grads.keys() == want.keys()
    # the whole gradient's norm (a bias whose gradient nearly cancels, as
    # conv4's here, has no norm of its own to be held to)
    norm = np.sqrt(sum((g ** 2).sum() for g in want.values()))
    err = np.sqrt(sum(((grads[k] - g) ** 2).sum() for k, g in want.items()))
    assert norm > 0 and err <= 1e-4 * norm, (err, norm)


# ----------------------------------------------------- factory, io, raises

NEW_BACKBONES = {
    "pointnet": (["extra_data=[]"], "PointNetRegressor"),
    "pointnet_deeper": (["extra_data=[]"], "PointNetRegressor"),
    "pointnet_segmenter": ([], "PointNetSegmenter"),
    "pointnet_segmenter_conv1d": ([], "PointNetSegmenterConv1d"),
    "pointnet2_segmenter_v1": (["ball_in_xyz_space=true"],
                               "PointNet2Segmenter"),
    "pointnet2_segmenter_paintnet_v1": ([], "PointNet2SegmenterPaintNet"),
    "mlp_generator": (["extra_data=[]"], "MLPGenerator"),
    "dgcnn": ([], "DGCNNDiscriminator"),
}


@pytest.mark.parametrize("which", sorted(NEW_BACKBONES))
def test_get_model_builds_every_new_name(which):
    """The port's module has the JAX module's class name."""
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu_torch.models import get_model

    extra, cls = NEW_BACKBONES[which]
    argv = [*LAMBDA1, f"model.backbone={which}", *extra]
    assert type(get_flax_model(jax_load_args(argv=argv))).__name__ == cls
    model = get_model(load_args(argv=argv), device="cpu")
    assert type(model).__name__ == cls and not model.training


RAISES = [
    # (backbone, config arguments, the error both factories raise)
    ("pointnet", [], AssertionError),              # with orientations
    ("pointnet_deeper", [], AssertionError),
    ("mlp_generator", [], AssertionError),
    ("samplenet", [], NotImplementedError),
    ("gnn", [], NotImplementedError),
    ("transformer", [], NotImplementedError),
    ("no_such_backbone", [], ValueError),
]


@pytest.mark.parametrize("which,extra,error", RAISES)
def test_get_model_raises_where_jax_raises(which, extra, error):
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu_torch.models import get_model

    argv = [*LAMBDA1, f"model.backbone={which}", *extra]
    with pytest.raises(error):
        get_flax_model(jax_load_args(argv=argv))
    with pytest.raises(error):
        get_model(load_args(argv=argv), device="cpu")


@pytest.mark.parametrize("which", ["pointnet_segmenter",
                                   "pointnet_segmenter_conv1d",
                                   "pointnet2_segmenter_v1"])
def test_segmenters_need_latent_dim(which):
    """No shipped default: both factories fail without it."""
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu_torch.models import get_model

    argv = ["config=[pointWise,cuboids_v2,longx_v2]",
            f"model.backbone={which}"]
    with pytest.raises(KeyError):
        get_flax_model(jax_load_args(argv=argv))
    with pytest.raises(KeyError):
        get_model(load_args(argv=argv), device="cpu")


@pytest.mark.parametrize("argv", [LAMBDA1, LAMBDA4])
def test_contrastive_clustering_io_matches_jax(argv):
    from maskplanner_tpu.models import get_io_info as jax_io
    from maskplanner_tpu_torch.models import get_io_info

    want = jax_io("ContrastiveClustering", jax_load_args(argv=argv))
    assert get_io_info("ContrastiveClustering", load_args(argv=argv)) == want
    assert want["inputdim"] in (6, 24)
