"""The port's ``SetAbstractionMsg`` and ``LegacyPaintDataset`` against the
JAX package's, on the CPU.

``SetAbstractionMsg`` (two scales over one FPS draw, with and without input
features, BatchNorm and LayerNorm MLPs): the JAX level's weights carried
over by ``convert.py``, the same seeded numpy inputs through both. Eval
outputs within 1e-5 · max|ref|; in train mode (FPS from index 0, as the
JAX level draws without an ``fps`` key) the outputs and the moved
BatchNorm statistics by ``test_torch_port_segmenters.py``'s rule
(``assert_train_matches``); the weights both ways bit for bit; the centres
bitwise and every scale's ball indices identical to the JAX ball query's.

``LegacyPaintDataset``: the port's copy against the JAX package's on the
fixture corpus (``data/fixture_category.py``, written once for each
package, since the disk reader caches what it read beside the mesh), item
for item and bit for bit, in each of the loader's modes (segments at λ 4,
velocities at λ 1, per-stroke downsampling, per-dataset normalisation, a
train portion, the rotation augmentations from one seeded global numpy
state).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_port_segmenters import (_init, _port, assert_eval_matches,
                                        assert_round_trip,
                                        assert_train_matches)

torch.set_num_threads(1)

B, N, C = 3, 96, 5
NPOINT = 16
RADII = (0.3, 0.6)
NSAMPLES = (8, 16)
MLPS = ((8, 12), (8, 16))


def _cloud(seed=6):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    return xyz, feats


def _msg_pair(norm: str, with_features: bool):
    from maskplanner_tpu.models.pointnet2 import \
        SetAbstractionMsg as JaxMsg
    from maskplanner_tpu_torch.models.pointnet2 import SetAbstractionMsg

    xyz, feats = _cloud()
    args = (xyz, feats if with_features else None)
    flax_m = JaxMsg(npoint=NPOINT, radii=RADII, nsamples=NSAMPLES,
                    mlps=MLPS, norm=norm)
    variables = _init(flax_m, *(None if a is None else jnp.asarray(a)
                                for a in args))
    port = _port(SetAbstractionMsg(NPOINT, RADII, NSAMPLES,
                                   C if with_features else 0, MLPS, norm),
                 variables)
    return flax_m, variables, port, args


MSG_CASES = [("batch", True), ("batch", False), ("layer", True)]


@pytest.fixture(scope="module", params=MSG_CASES,
                ids=[f"{n}-{'feats' if f else 'xyz'}" for n, f in MSG_CASES])
def msg(request):
    return _msg_pair(*request.param)


class _XyzOnly:
    """The JAX level called without input features (its ``features`` is
    positional), for the helpers that pass the inputs as positionals."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, xyz, **kw):
        return self.module.apply(variables, xyz, None, **kw)


def _as_called(msg):
    """(JAX level, port kwargs, inputs) for the helpers."""
    flax_m, _, _, (xyz, feats) = msg
    if feats is None:
        return _XyzOnly(flax_m), dict(features=None), (xyz,)
    return flax_m, {}, (xyz, feats)


def test_msg_eval_matches_jax(msg):
    flax_m, port_kw, args = _as_called(msg)
    assert_eval_matches(flax_m, msg[1], msg[2], args, port_kw=port_kw)


def test_msg_train_matches_jax(msg):
    flax_m, port_kw, args = _as_called(msg)
    port = msg[2]
    # each BatchNorm layer moves its mean and its variance
    n_stats = (2 * sum(len(m) for m in MLPS)
               if port.mlps[0].norm == "batch" else 0)
    assert_train_matches(flax_m, msg[1], port, args, port_kw=port_kw,
                         n_stats=n_stats)


def test_msg_weights_convert_both_ways(msg):
    assert_round_trip(msg[1])


def test_msg_centres_and_balls_match_jax():
    """One FPS draw serves both scales: the centres bitwise JAX's, and each
    scale's ball indices (the ball query, #7 on the card) identical."""
    from maskplanner_tpu.ops import sampling as jax_sampling
    from maskplanner_tpu_torch.models import pointnet2

    xyz, feats = _cloud()
    port = pointnet2.SetAbstractionMsg(NPOINT, RADII, NSAMPLES, C,
                                       MLPS).eval()
    seen = []
    query = pointnet2.query_ball_point

    def record(radius, nsample, x, q):
        idx = query(radius, nsample, x, q)
        seen.append((radius, nsample, q, idx))
        return idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pointnet2, "query_ball_point", record)
        with torch.no_grad():
            new_xyz, out = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    assert out.shape == (B, NPOINT, sum(m[-1] for m in MLPS))
    fps = jax_sampling.farthest_point_sample(jnp.asarray(xyz), NPOINT)
    want_xyz = np.asarray(jax_sampling.index_points(jnp.asarray(xyz), fps))
    np.testing.assert_array_equal(new_xyz.numpy(), want_xyz)
    assert [(r, k) for r, k, _, _ in seen] == list(zip(RADII, NSAMPLES))
    for radius, nsample, q, idx in seen:
        assert q is seen[0][2]
        want = jax_sampling.query_ball_point(radius, nsample,
                                             jnp.asarray(xyz),
                                             jnp.asarray(want_xyz))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want))


def test_msg_rejects_unequal_scales():
    from maskplanner_tpu_torch.models.pointnet2 import SetAbstractionMsg

    with pytest.raises(ValueError, match="differ in length"):
        SetAbstractionMsg(NPOINT, RADII, NSAMPLES[:1], C, MLPS)


# ------------------------------------------------------------------ legacy

CATEGORY = "cuboids-v2"


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The fixture corpus, written once for each package."""
    from maskplanner_tpu_torch.data.fixture_category import write_category

    roots = {}
    for pkg in ("jax", "port"):
        root = tmp_path_factory.mktemp(f"legacy_{pkg}")
        write_category(str(root), CATEGORY, n_train=3, n_test=1, seed=2)
        roots[pkg] = str(root)
    return roots


LEGACY_CASES = {
    "segments": dict(lambda_points=4, extra_data=("orientnorm",)),
    "segments-overlap": dict(lambda_points=4, overlapping=1,
                             extra_data=("orientnorm",)),
    "velocities": dict(lambda_points=1, extra_data=("vel",)),
    "stroke_pred": dict(lambda_points=1, stroke_pred=True, stroke_points=16,
                        extra_data=("orientnorm",)),
    "per-dataset": dict(lambda_points=4, extra_data=("orientnorm",),
                        normalization="per-dataset"),
    "portion": dict(lambda_points=4, extra_data=("orientnorm",),
                    train_portion=0.67, seed=1),
    "rot": dict(lambda_points=4, extra_data=("orientnorm",),
                augmentations=("rot",)),
    "roty-lambda1": dict(lambda_points=1, extra_data=("orientnorm",),
                         augmentations=("roty",)),
    "rotx-vel": dict(lambda_points=1, extra_data=("vel",),
                     augmentations=("rotx",)),
    "test-split": dict(lambda_points=4, extra_data=("orientnorm",),
                       split="test"),
}


def _legacy_items(cls, root, case):
    kw = dict(categories=CATEGORY, split="train", pc_points=128,
              traj_points=120)
    kw.update(LEGACY_CASES[case])
    ds = cls(root, **kw)
    items = []
    # every item twice: the second access reads the loader's cache (and,
    # under an augmentation, draws a fresh rotation)
    np.random.seed(11)
    for _ in range(2):
        items += [ds[i] for i in range(len(ds))]
    return len(ds), ds.dataset_mean_max_distance, items


@pytest.mark.parametrize("case", sorted(LEGACY_CASES))
def test_legacy_items_are_the_jax_loaders(corpora, case):
    from maskplanner_tpu.data.legacy import LegacyPaintDataset as JaxLegacy
    from maskplanner_tpu_torch.data import LegacyPaintDataset

    n, scale, got = _legacy_items(LegacyPaintDataset, corpora["port"], case)
    n_ref, scale_ref, want = _legacy_items(JaxLegacy, corpora["jax"], case)
    assert n == n_ref and n >= 1 and scale == scale_ref
    for a, b in zip(got, want):
        assert len(a) == len(b) == 5 and a[4] == b[4]
        for x, y in zip(a[:4], b[:4]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
