"""The port's bf16 training against the JAX package's bf16 model, on the CPU.

Inputs are made with numpy from a seed and go through both packages. The
JAX side takes its accelerator path (``_use_pallas`` patched to True, the
Pallas kernels in interpret mode), whose dtype rules the port follows. On
the CPU, ``Precision.DEFAULT`` on float32 operands is a full float32
product, where the TPU's MXU makes one bf16 pass; so the fused level is
compared twice:

(a) the port's plain bf16 backward with float32 products
    (``fused_sa_backward_plain(..., precision="bf16")`` with the test's
    ``PRODUCTS["bf16"]`` patched to ``torch.matmul``: gather and scatter
    rounding kept) against
    ``jax.vjp`` of ``fused_sa_train(precision="default")`` in interpret
    mode, within the float32 backward tests' 5e-4 · max|ref| (measured at
    most 1.0e-4, with LayerNorm and without features: the JAX kernel keeps
    sa1's coordinates as a hi/lo pair of bf16 values, 16 bits, where the
    port keeps float32);
(b) the port's bf16 level on the CPU (its own bf16 products, the gradient
    from ``PlainBf16Level``) against the same JAX level with the kernel's
    ``_dot`` at "default" made the MXU's single bf16 pass (``mxu_default``:
    operands rounded to bf16, float32 sums; the test patches it, the JAX
    package is unchanged), within the JAX package's bf16 tolerance
    2e-2 · max|ref| (measured 2.4e-3 with LayerNorm and without features,
    again sa1's coordinates, 7.6e-4 with features, at most 2.7e-6 without
    LayerNorm).

In both, the JAX kernel gathers the first 5 feature channels with the
coordinates' hi/lo pair (``_Gather.split``), which its product rounds to
bf16 on the accelerator but not in interpret mode; the cases make those
channels bf16 values, on which both gathers agree.

(c) The rounding places against a float64 emulation of the single-pass
    definition, written out here, by each gradient's relative L2 error (a
    float32 sum that rounds to the other bf16 neighbour moves one element
    by 2^-8 of itself): the port's bf16 backward within 1e-5 (measured at
    most 2.7e-6), autograd through ``matmul_bf16`` (which rounds each input
    gradient's result and not d_pre) beyond 1e-3 (measured 3.8e-3 to
    4.9e-3).
(d) The single-pass grouping's backward: a bf16 cotangent is summed in
    float32, equal to ``jax.vjp`` of ``ball_group_pallas(single_pass=
    True)`` within 1e-6 · max|ref| (measured: equal, bit for bit).
(e) The bf16 training step on each recipe, stage by stage against the
    eager JAX bf16 step on the same converted weights (see
    ``test_bf16_step_stage_matches_jax`` for why stage by stage).
(f) ``train_maskplanner`` trains ``model.bf16=true`` for 2 epochs on the
    CPU, and the run's ``Predictor`` serves it in bf16.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.convert import (flax_tree_from_state_dict,
                                           state_dict_from_flax)
from maskplanner_tpu_torch.models import get_model
from maskplanner_tpu_torch.models.maskplanner import f32_accumulation
from maskplanner_tpu_torch.ops.fused_sa import (bf16_round,
                                                fused_sa_backward_plain,
                                                fused_sa_forward,
                                                fused_sa_forward_plain)
from maskplanner_tpu_torch.ops.group_gather import (ball_group,
                                                    ball_group_backward)
from maskplanner_tpu_torch.ops.sampling import ball_query_plain
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

RADIUS, K = 0.35, 16
FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
BF16_TOL = 2e-2


def _interpret(mp):
    orig = pl.pallas_call
    mp.setattr(pl, "pallas_call",
               lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _mxu_default(mp):
    """The JAX kernel's "default" products as the MXU makes them: one pass
    on operands rounded to bf16, float32 sums."""
    import maskplanner_tpu.ops.pallas.fused_sa_train as fst

    dot = fst._dot

    def single_pass(a, b, dims, prec):
        if prec == "default":
            a, b = a.astype(jnp.bfloat16), b.astype(jnp.bfloat16)
        return dot(a, b, dims, prec)

    mp.setattr(fst, "_dot", single_pass)


@pytest.fixture
def interpret_mode(monkeypatch):
    # the level's raw calls are jitted: no trace made under other patches
    # is reused, and none made here outlives the test
    jax.clear_caches()
    _interpret(monkeypatch)
    yield
    jax.clear_caches()


@pytest.fixture
def mxu_default(interpret_mode, monkeypatch):
    _mxu_default(monkeypatch)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bf16_values(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _sa_case(norm, with_features, B=2, N=256, S=64, chans=(32, 48)):
    """As ``tests/test_torch_port_bf16.py``'s level case, the first 5
    feature channels bf16 values (see the module's docstring), and a
    cotangent."""
    rng = np.random.default_rng(1)
    xyz = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    new_xyz = xyz[:, :S].copy()
    new_xyz[:, ::7] += 50.0            # some balls empty
    # 29 features: more than 16 channels, the JAX kernel's sa2 gather; none:
    # its blocked sa1 gather
    feats = None
    if with_features:
        feats = rng.normal(size=(B, N, 29)).astype(np.float32)
        feats[..., :5] = _bf16_values(feats[..., :5])
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
    ct = np.random.default_rng(2).normal(size=(B, S, chans[-1])) \
        .astype(np.float32)
    return xyz, new_xyz, feats, tuple(params), ct


def _jax_level_grads(norm, xyz, new_xyz, feats, params, ct):
    from maskplanner_tpu.ops.pallas import fused_sa_train as fst

    def loss(x, q, f, p):
        return jnp.sum(fst.fused_sa_train(RADIUS, K, norm, x, q, f, p,
                                          precision="default") * ct)

    args = (_j(xyz), _j(new_xyz), _j(feats),
            jax.tree_util.tree_map(jnp.asarray, params))
    argnums = (0, 1, 3) if feats is None else (0, 1, 2, 3)
    return [np.asarray(g) for g in jax.tree_util.tree_leaves(
        jax.grad(loss, argnums)(*args))]


def _flat(d_xyz, d_new, d_feat, grads):
    return [t for t in (d_xyz, d_new, d_feat) if t is not None] + [
        g for layer in grads for g in layer]


def _assert_close(got, ref, tol):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=tol * (np.abs(r).max() + 1e-9))


LEVEL_CASES = pytest.mark.parametrize(
    "norm,with_features", [("layer", False), ("layer", True),
                           ("none", False), ("none", True)],
    ids=["layer-xyz", "layer-features", "none-xyz", "none-features"])


@LEVEL_CASES
def test_plain_bf16_backward_matches_jax_f32_products(norm, with_features,
                                                      interpret_mode,
                                                      monkeypatch):
    """(a): the rounding of the gathered features and of the scattered
    rows, with the JAX level's interpret-mode float32 products (the port's
    bf16 layer product patched to ``torch.matmul`` to match)."""
    from maskplanner_tpu_torch.ops import fused_sa

    xyz, new_xyz, feats, params, ct = _sa_case(norm, with_features)
    ref = _jax_level_grads(norm, xyz, new_xyz, feats, params, ct)
    tparams = [tuple(_t(a) for a in layer) for layer in params]
    leaves = [_t(xyz), _t(new_xyz), _t(feats)]
    rounded = None if feats is None else bf16_round(_t(feats))
    pooled, idx = fused_sa_forward_plain(RADIUS, K, norm, leaves[0],
                                         leaves[1], rounded, tparams)
    monkeypatch.setitem(fused_sa.PRODUCTS, "bf16", torch.matmul)
    got = _flat(*fused_sa_backward_plain(
        K, norm, *leaves, tparams, idx, pooled, _t(ct), splits=3,
        precision="bf16"))
    _assert_close(got, ref, 5e-4)


@LEVEL_CASES
def test_bf16_level_gradient_matches_jax_mxu_products(norm, with_features,
                                                      mxu_default):
    """(b): the port's CPU bf16 level (its own bf16 products, the gradient
    from ``PlainBf16Level``) against the JAX level with the MXU's
    single-pass products."""
    xyz, new_xyz, feats, params, ct = _sa_case(norm, with_features)
    ref = _jax_level_grads(norm, xyz, new_xyz, feats, params, ct)
    leaves = [None if a is None else _t(a).requires_grad_(True)
              for a in (xyz, new_xyz, feats)]
    tparams = [tuple(_t(a).requires_grad_(True) for a in layer)
               for layer in params]
    pooled, _ = fused_sa_forward(RADIUS, K, norm, *leaves, tparams,
                                 precision="bf16")
    assert type(pooled.grad_fn).__name__ == "PlainBf16LevelBackward"
    flat = [t for t in leaves if t is not None] + [
        t for layer in tparams for t in layer]
    got = torch.autograd.grad((pooled * _t(ct)).sum(), flat)
    _assert_close(got, ref, BF16_TOL)


def _definition_f64(norm, xyz, new_xyz, feats, params, ct):
    """The single-pass level and its backward in float64, from the JAX
    kernel's definition: features gathered rounded to bf16; every product
    on operands rounded to bf16 (the recompute, dW = bf16(d_pre)ᵀ ·
    bf16(in), d_in = bf16(d_pre) · bf16(W)); the LayerNorm, db, dgamma and
    dbeta from the unrounded gradient; the first winner of the max takes
    the cotangent; scattered rows rounded to bf16; d_new_xyz from the
    unrounded offsets' gradient -> the gradients in ``_flat`` order."""
    def r(a):
        return a.to(torch.bfloat16).to(torch.float64)

    x64 = torch.from_numpy(xyz).double()
    q64 = torch.from_numpy(new_xyz).double()
    B, N, _ = xyz.shape
    idx = ball_query_plain(RADIUS, K, torch.from_numpy(xyz),
                           torch.from_numpy(new_xyz)).long()
    b = torch.arange(B)[:, None, None]
    h = x64[b, idx] - q64[:, :, None, :]
    if feats is not None:
        h = torch.cat([h, r(torch.from_numpy(feats).double())[b, idx]], -1)
    ps = [[torch.from_numpy(a).double() for a in layer] for layer in params]
    saved = []
    for w, bias, *ln in ps:
        inp = h
        h = r(inp) @ r(w).t() + bias
        xhat = inv = None
        if norm == "layer":
            mu = h.mean(-1, keepdim=True)
            inv = 1.0 / torch.sqrt(((h - mu) ** 2).mean(-1, keepdim=True)
                                   + 1e-6)
            xhat = (h - mu) * inv
            h = xhat * ln[0] + ln[1]
        h = torch.relu(h)
        saved.append((inp, xhat, inv, h))
    act = h
    win = act.argmax(2, keepdim=True)          # the first maximum
    ct64 = torch.from_numpy(ct).double()[:, :, None]
    d = torch.zeros_like(act).scatter_(2, win, ct64)
    d = torch.where(act > 0, d, 0.0)
    grads = []
    for layer in range(len(ps) - 1, -1, -1):
        inp, xhat, inv, _ = saved[layer]
        w, _, *ln = ps[layer]
        extra = []
        if norm == "layer":
            extra = [(d * xhat).sum((0, 1, 2)), d.sum((0, 1, 2))]
            dx = d * ln[0]
            d = inv * (dx - dx.mean(-1, keepdim=True)
                       - xhat * (dx * xhat).mean(-1, keepdim=True))
        grads.insert(0, [torch.einsum("bskc,bski->ci", r(d), r(inp)),
                         d.sum((0, 1, 2)), *extra])
        d = r(d) @ r(w)
        if layer > 0:
            d = torch.where(saved[layer - 1][3] > 0, d, 0.0)
    rows = (idx + N * b).reshape(-1)
    d_xyz = torch.zeros(B * N, 3, dtype=torch.float64).index_add_(
        0, rows, r(d[..., :3]).reshape(-1, 3)).view(B, N, 3)
    out = [d_xyz, -d[..., :3].sum(2)]
    if feats is not None:
        F = feats.shape[-1]
        out.append(torch.zeros(B * N, F, dtype=torch.float64).index_add_(
            0, rows, r(d[..., 3:]).reshape(-1, F)).view(B, N, F))
    return [t.numpy() for t in out + [g for layer in grads for g in layer]]


@LEVEL_CASES
def test_rounding_places_against_float64_definition(norm, with_features):
    """(c): the port's bf16 level gradient sits on the definition; autograd
    through ``matmul_bf16`` does not."""
    xyz, new_xyz, feats, params, ct = _sa_case(norm, with_features)
    ref = _definition_f64(norm, xyz, new_xyz, feats, params, ct)

    def grads(level):
        leaves = [None if a is None else _t(a).requires_grad_(True)
                  for a in (xyz, new_xyz, feats)]
        tparams = [tuple(_t(a).requires_grad_(True) for a in layer)
                   for layer in params]
        pooled, _ = level(RADIUS, K, norm, *leaves, tparams,
                          precision="bf16")
        flat = [t for t in leaves if t is not None] + [
            t for layer in tparams for t in layer]
        return torch.autograd.grad((pooled * _t(ct)).sum(), flat)

    def worst(got):
        return max(float(np.linalg.norm(g.numpy() - r) / np.linalg.norm(r))
                   for g, r in zip(got, ref))

    assert worst(grads(fused_sa_forward)) <= 1e-5
    assert worst(grads(fused_sa_forward_plain)) > 1e-3


# name: (N, S, K, F, radius), as tests/test_torch_port_bf16.py's cases
GROUP_CASES = {"xyz-only": (384, 64, 8, 0, 0.5),
               "f5": (256, 64, 8, 5, 0.5),
               "f29": (256, 32, 4, 29, 0.5)}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_single_pass_group_backward_sums_in_f32(case, interpret_mode):
    """(d): the bf16 cotangent of the single-pass rows scatters into
    float32 sums, through ``ball_group_backward`` (the card's backward) and
    through autograd of the CPU path, equal to ``jax.vjp`` of
    ``ball_group_pallas(single_pass=True)`` on the same bf16 values."""
    from maskplanner_tpu.ops.pallas.group_gather import ball_group_pallas

    N, S, K_, F, r = GROUP_CASES[case]
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(2, N, 3)).astype(np.float32)
    q = xyz[:, :S].copy()
    feats = rng.normal(size=(2, N, F)).astype(np.float32) if F else None
    ct = _bf16_values(rng.normal(size=(2, S, K_, 3 + F)))

    def group(x, q_, f):
        return ball_group_pallas(r, K_, x, q_, f, single_pass=True)[0]

    primals = (_j(xyz), _j(q)) + ((_j(feats),) if F else ())
    _, vjp = jax.vjp(lambda *a: group(*a[:2], a[2] if F else None), *primals)
    ref = [np.asarray(g) for g in vjp(jnp.asarray(ct))]

    d_ct = _t(ct).to(torch.bfloat16)
    grouped, idx = ball_group(r, K_, _t(xyz), _t(q), _t(feats),
                              single_pass=True)
    got = [t for t in ball_group_backward(idx, d_ct, N, True, True, bool(F))
           if t is not None]
    leaves = [_t(a).requires_grad_(True) for a in (xyz, q, feats)
              if a is not None]
    grouped, _ = ball_group(r, K_, *leaves[:2], leaves[2] if F else None,
                            single_pass=True)
    assert grouped.dtype == torch.bfloat16
    auto = torch.autograd.grad(grouped, leaves, d_ct)
    for got_ in (got, auto):
        _assert_close(got_, ref, 1e-6)


# -- (e) the training step ---------------------------------------------------

SMALL = [FLAGSHIP, "pc_points=64", "model.hidden_size=[32,32]",
         "n_pred_traj_points=120", "max_n_strokes=6", "batch_size=4",
         "model.bf16=true"]
STAGES = ("sa1", "sa2", "sa3", "heads")
# as tests/test_torch_port_train.py's: the allowance for float32 rounding
# is ROUNDING_FACTOR times the port's own float32 error on each tensor,
# measured against the same stage with its float32 parts in float64 (the
# bf16 roundings kept), plus JAX_ROUNDING_FACTOR times the JAX stage's own,
# sampled by the same stage on the batch in reverse order
ROUNDING_FACTOR = 10
JAX_ROUNDING_FACTOR = 3
# the allowance itself is held within this share of the reference's norm,
# so that a zero gradient fails
ALLOWANCE_SHARE = 0.25


def _small(norm):
    """As ``tests/test_torch_port_train.py``: the BatchNorm recipe at 1024
    points (at 64, sa1's centroids repeat point 0)."""
    pc = ["pc_points=1024"] if norm == "batch" else []
    return [*SMALL, *pc, f"model.norm={norm}"]


def _cotangent(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module", params=["layer+layer+batch", "batch"])
def bf16_step(request):
    """The JAX bf16 model on its accelerator path (interpret mode, the
    MXU's single-pass products), seeded non-zero biases and scales as in
    ``tests/test_torch_port_train.py``, dropout off, on 4 clouds of the
    train split: its train-mode forward's stage inputs and outputs, and
    each stage's VJP for a fixed cotangent -> (norm, clouds, variables,
    {stage: (inputs, outputs, (param grads, input grads))})."""
    import flax.linen as fnn

    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu.data import collate
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.models import maskplanner as flax_maskplanner
    from maskplanner_tpu.models import pointnet2 as flax_pointnet2

    norm = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    cfg = jax_load_args(argv=_small(norm))
    clouds = collate([JaxPaintDataset(cfg, split="train", size=4)[i]
                      for i in range(4)])["point_cloud"]
    rng = np.random.default_rng(0)
    model = get_flax_model(cfg)
    variables = model.init(jax.random.PRNGKey(1), jnp.asarray(clouds),
                           train=False)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng.normal(size=a.shape) * 0.1
                      ).astype(np.float32)
        if p[-1].key in ("bias", "scale", "mean") else
        (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
         if p[-1].key == "var" else np.asarray(a)), variables)
    jax.clear_caches()
    _interpret(mp)
    _mxu_default(mp)
    mp.setattr(flax_pointnet2, "_use_pallas", lambda: True)
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    params, stats = variables["params"], variables["batch_stats"]
    enc_p, enc_s = params["encoder"], stats["encoder"]
    n1, n2, n3 = norm.split("+") if "+" in norm else [norm] * 3
    bf = jnp.bfloat16
    levels = {
        "sa1": flax_pointnet2.SetAbstraction(512, 0.2, 32, (64, 64, 128),
                                             dtype=bf, norm=n1),
        "sa2": flax_pointnet2.SetAbstraction(128, 0.4, 64, (128, 128, 256),
                                             dtype=bf, norm=n2),
        "sa3": flax_pointnet2.SetAbstraction(None, None, None,
                                             (256, 512, 1024),
                                             group_all=True, dtype=bf,
                                             norm=n3)}
    out = {}

    def flip(a):
        return None if a is None else np.asarray(a)[::-1]

    try:
        x = jnp.asarray(clouds)
        feats = None
        for seed, (name, level) in enumerate(levels.items()):
            def f(p, f_, xyz, name=name, level=level):
                (new, pooled), _ = level.apply(
                    {"params": p, "batch_stats": enc_s.get(name, {})}, xyz,
                    f_, True, mutable=["batch_stats"])
                return pooled, new

            pooled, new = f(enc_p[name], feats, x)
            ct = _cotangent(pooled.shape, seed)
            grads = []
            # the same stage on the batch in reverse order samples its own
            # rounding
            for xyz_, f_, ct_ in ((x, feats, ct),
                                  (flip(x), flip(feats), ct[::-1])):
                _, vjp = jax.vjp(lambda p, g: f(p, g, xyz_)[0], enc_p[name],
                                 f_)
                d_p, d_f = vjp(jnp.asarray(ct_))
                grads += [jax.tree_util.tree_map(np.asarray, d_p),
                          None if d_f is None else np.asarray(d_f)]
            grads[3] = flip(grads[3])
            out[name] = ((np.asarray(x), None if feats is None
                          else np.asarray(feats)), [np.asarray(pooled)],
                         [ct], grads)
            x, feats = new, pooled
        feature = jnp.asarray(out["sa3"][1][0][:, 0, :])

        class FixedEncoder(fnn.Module):
            """The encoder's place in the model: the given feature."""
            dtype: jnp.dtype = jnp.float32
            norm: str = "batch"

            @fnn.compact
            def __call__(self, xyz, train, fps_keys=None):
                return box[0]

        box = [feature]
        mp.setattr(flax_maskplanner, "PointNet2Encoder", FixedEncoder)

        def heads(p, feat, pc):
            box[0] = feat
            o, _ = model.apply({"params": p, "batch_stats": stats}, pc,
                               train=True, mutable=["batch_stats"])
            return o

        o = heads(params, feature, jnp.asarray(clouds))
        cts = [None if t is None else _cotangent(t.shape, 10 + i)
               for i, t in enumerate(o)]
        grads = []
        for feat_, pc_, cts_ in ((feature, clouds, cts),
                                 (flip(feature), clouds[::-1],
                                  [flip(c) for c in cts])):
            _, vjp = jax.vjp(lambda p, g: heads(p, g, jnp.asarray(pc_)),
                             params, feat_)
            d_p, d_f = vjp(type(o)(*(None if c is None else jnp.asarray(c)
                                     for c in cts_)))
            grads += [jax.tree_util.tree_map(np.asarray, d_p),
                      np.asarray(d_f)]
        grads[3] = flip(grads[3])
        out["heads"] = ((np.asarray(feature),),
                        [None if t is None else np.asarray(t) for t in o],
                        cts, grads)
    finally:
        mp.undo()
        jax.clear_caches()
    return norm, clouds, variables, out


def _port_model(norm, variables, bf16=True):
    argv = [a for a in _small(norm) if a != "model.bf16=true"]
    flag = "model.bf16=true" if bf16 else "model.bf16=false"
    model = get_model(load_args(argv=[*argv, flag]), device="cpu",
                      dropout=0.0)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model.train()


def _leaves(tree, prefix=""):
    return {prefix + jax.tree_util.keystr(p): np.asarray(a)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)
            if a is not None}


def _port_stage(norm, variables, stage, inputs, cts, clouds, monkeypatch,
                dtype=torch.float32, bf16=True):
    """One stage of the port's bf16 step in train mode (of its f32 step if
    not ``bf16``), its forward and backward for the cotangents ``cts``, its
    f32 parts in ``dtype`` (the bf16 roundings kept) -> (outputs, parameter
    gradients as Flax leaves, the input features' gradient or None)."""
    from maskplanner_tpu_torch.models.pointnet2 import PointNet2Encoder

    def t(a):
        return None if a is None else _t(a).to(dtype)

    model = _port_model(norm, variables, bf16).to(dtype)
    if stage == "heads":
        feat = t(inputs[0]).requires_grad_(True)
        monkeypatch.setattr(PointNet2Encoder, "forward",
                            lambda self, xyz, generator=None: feat)
        with f32_accumulation():
            outs = list(model(t(clouds)))
    else:
        feat = None if inputs[1] is None \
            else t(inputs[1]).requires_grad_(True)
        with f32_accumulation():
            outs = [getattr(model, stage)(t(inputs[0]), feat)[1]]
    with f32_accumulation():
        sum((o * t(c)).sum() for o, c in zip(outs, cts)
            if c is not None).backward()
    monkeypatch.undo()
    grads = {k: np.asarray(v, np.float64) for k, v in _leaves(
        flax_tree_from_state_dict({n: p.grad for n, p in
                                   model.named_parameters()
                                   if p.grad is not None})).items()}
    return ([None if o is None else o.detach().numpy() for o in outs],
            grads, None if feat is None else feat.grad.numpy())


def _stage_allowances(bf16_step, stage, monkeypatch):
    """The port's bf16 stage against the JAX stage -> (port outputs, JAX
    outputs, {gradient key: (port gradient, allowance, JAX gradient)}):
    the allowance is 2e-2 of the JAX gradient's norm, plus ROUNDING_FACTOR
    times the port's own float32 error (the same stage with its float32
    parts in float64, the bf16 roundings kept) and JAX_ROUNDING_FACTOR
    times the JAX stage's own (sampled by the batch in reverse order). A
    Dense bias that feeds a BatchNorm has an exact gradient of 0 (the
    BatchNorm subtracts the batch mean), so both its values are rounding
    noise: its allowance is None (held finite only)."""
    norm, clouds, variables, ref = bf16_step
    inputs, outs, cts, (ref_dp, ref_df, rev_dp, rev_df) = ref[stage]
    got_outs, grads, got_df = _port_stage(norm, variables, stage, inputs,
                                          cts, clouds, monkeypatch)
    _, exact, exact_df = _port_stage(norm, variables, stage, inputs, cts,
                                     clouds, monkeypatch, torch.float64)
    prefix = ("['params']" if stage == "heads"
              else f"['params']['encoder']['{stage}']")
    want = {k: v for k, v in _leaves(ref_dp, prefix).items()
            if stage != "heads" or "['encoder']" not in k}
    rev = _leaves(rev_dp, prefix)
    assert sorted(want) == sorted(grads)
    pairs = {key: (grads[key], exact[key], r, rev[key])
             for key, r in want.items()}
    if ref_df is not None:
        pairs["input features"] = (got_df, exact_df, ref_df, rev_df)
    rows = {}
    for key, (g, g64, r, r_rev) in pairs.items():
        tol = (BF16_TOL * np.linalg.norm(r)
               + ROUNDING_FACTOR * np.linalg.norm(g - g64)
               + JAX_ROUNDING_FACTOR * np.linalg.norm(r - r_rev))
        if key.endswith("']['bias']") and "['Dense_" in key and \
                key.replace("Dense_", "BatchNorm_") in pairs:
            tol = None
        rows[key] = (g, tol, r)
    return got_outs, outs, rows


@pytest.mark.parametrize("stage", STAGES)
def test_bf16_step_stage_matches_jax(bf16_step, stage, monkeypatch):
    """(e): each stage of the bf16 training step, sa1, sa2, sa3 and the
    heads in train mode, forward and backward, on the JAX step's own
    inputs to that stage and with fixed cotangents on its outputs, against
    the JAX stage. The outputs within 2e-2 · max|ref| (the JAX package's
    bf16 tolerance). Each gradient (the parameters' and the stage's input
    features') by its L2 error within the allowance of
    ``_stage_allowances``, as the float32 step test holds its own; and that
    allowance within ALLOWANCE_SHARE of the reference's norm, so that a
    zero gradient fails. Measured: the allowance is at most 0.21 of the
    reference's norm (the BatchNorm recipe's sa3, whose float32 parts in
    float64 move its BatchNorm statistics; at most 0.17 on the default
    recipe, its sa3; 0.020-0.095 at the fused levels, at most 0.032 at the
    heads); the error at most 0.74 of the allowance (the BatchNorm recipe's
    sa1, 4.6e-2 to 7.6e-2 of the norm, whose BatchNorms normalise 65536
    rows of bf16 Dense outputs by E[x²] − E[x]² in float32; at most 7.6e-3
    of the norm at the fused levels and 1.3e-2 at the heads). A stage run
    in float32 fails this check
    (``test_bf16_step_stage_check_fails_an_f32_stage``); autograd through
    ``matmul_bf16``, whose rounding places move the fused level's
    gradients by about 4e-3 of their norm, is within it and is told apart
    by (c).

    Stage by stage, not the whole step as the float32 step test does: at
    this size and random init, the bf16 step amplifies any difference in a
    bf16 rounding (the JAX kernel keeps sa1's coordinates as a 16-bit
    hi/lo pair; two products summed in other orders round to bf16 apart
    now and then) through BatchNorms over a batch of 4 and LayerNorms of
    near-constant rows to O(0.1-0.3) of max|ref| at the outputs, and the
    loss's matchings (the LAP, the nearest-neighbour argmins) then fall
    apart and move the step's gradients by O(1): so do, between the port's
    own float32 and bf16 steps or under a 1e-4 perturbation of the weights
    in float32. Given the same inputs, each stage agrees."""
    got_outs, outs, rows = _stage_allowances(bf16_step, stage, monkeypatch)
    for g, r in zip(got_outs, outs):
        if r is None:
            assert g is None
            continue
        assert g.dtype == np.float32 and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=BF16_TOL * np.abs(r).max())
    for key, (g, tol, r) in rows.items():
        assert np.isfinite(g).all(), key
        if tol is None:
            continue
        assert tol <= ALLOWANCE_SHARE * np.linalg.norm(r), key
        assert np.linalg.norm(g - r) <= tol, key


@pytest.mark.parametrize("stage", STAGES)
def test_bf16_step_stage_check_fails_an_f32_stage(bf16_step, stage,
                                                  monkeypatch):
    """(e)'s check has teeth: the same stage run by the port's float32
    model (the bf16 roundings left out) lies beyond the bf16 stage's
    allowance on some gradient, on every stage of both recipes (measured:
    on 6 to 16 of a stage's 8 to 20 held gradients, by up to 1.06 of the
    reference's norm at the heads and 0.38 at the encoder's levels)."""
    norm, clouds, variables, ref = bf16_step
    inputs, _, cts, _ = ref[stage]
    _, _, rows = _stage_allowances(bf16_step, stage, monkeypatch)
    _, grads, got_df = _port_stage(norm, variables, stage, inputs, cts,
                                   clouds, monkeypatch, bf16=False)
    grads["input features"] = got_df
    beyond = [key for key, (_, tol, r) in rows.items()
              if tol is not None and np.linalg.norm(grads[key] - r) > tol]
    assert beyond


@pytest.mark.parametrize("norm", ["layer+layer+batch", "batch"])
def test_bf16_step_trains_f32_parameters(norm):
    """The port's whole bf16 step: a finite loss, every parameter f32 with
    a finite f32 gradient, Adam moving the f32 parameters, and the
    BatchNorm running statistics moved."""
    from maskplanner_tpu_torch.data import PaintDataset, collate
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.train import (batch_to_device, make_optimizer,
                                             train_step)

    cfg = load_args(argv=_small(norm))
    model = get_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16
    before = {n: t.clone() for n, t in model.state_dict().items()}
    ds = PaintDataset(cfg, split="train", size=4)
    batch = batch_to_device(collate([ds[i] for i in range(4)]), "cpu")
    handler = LossHandler(cfg["loss"], cfg)
    loss, _ = train_step(model, make_optimizer(model, cfg), handler, batch,
                         handler.init_weights(),
                         torch.Generator().manual_seed(0))
    assert loss.dtype == torch.float32 and bool(torch.isfinite(loss))
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, n
        assert bool(torch.isfinite(p.grad).all()), n
    moved = [n for n, t in model.state_dict().items()
             if t.is_floating_point() and not torch.equal(t, before[n])]
    assert any(n.endswith("running_mean") for n in moved)
    assert any(n.endswith("mlp_convs.0.weight") for n in moved)


# -- (f) the driver ----------------------------------------------------------

def test_driver_trains_bf16_and_the_predictor_serves_it(tmp_path):
    """(f): ``model.bf16=true`` trains for 2 epochs on the CPU; the frozen
    config keeps the flag, the checkpoint holds f32 parameters, and
    ``Predictor(run)`` (``compute_dtype=None``: the run's own) serves in
    bf16."""
    import yaml

    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.serve import Predictor

    run_dir, model = train_maskplanner.main([
        FLAGSHIP, "model.bf16=true", "pc_points=64",
        "model.hidden_size=[32,32]", "n_pred_traj_points=120",
        "max_n_strokes=6", "batch_size=2", "device=cpu", "epochs=2",
        "eval_freq=1", "dataset_size=4", "test_dataset_size=2", "seed=3",
        f"output_dir={tmp_path}"])
    assert model.dtype == torch.bfloat16 and not model.training
    logs = (tmp_path / os.path.basename(run_dir) / "logs.jsonl").read_text()
    assert logs.count('"eval_loss"') == 2
    with open(os.path.join(run_dir, "config.yaml")) as fh:
        assert yaml.safe_load(fh)["model"]["bf16"] is True
    state = torch.load(os.path.join(run_dir, "last_checkpoint.torch.pt"),
                       map_location="cpu")
    floats = [t for t in state["model"].values() if t.is_floating_point()]
    assert floats and all(t.dtype == torch.float32 for t in floats)
    pred = Predictor(run_dir, model="last", device="cpu")
    assert pred.config["model"]["bf16"] and pred.epoch == 2
    assert pred.model.dtype == torch.bfloat16
    pc = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    out = pred.forward(pc[None])
    assert np.isfinite(np.asarray(out.traj)).all()


@pytest.mark.cuda
class TestBf16BackwardOnCard:
    """The fused SA backward's bf16 mode against its plain version on the
    card, as ``chip_smoke.py``'s bf16 training phase."""

    @pytest.fixture
    def cuda_device(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda")

    @LEVEL_CASES
    def test_bf16_backward_kernels_match_plain(self, norm, with_features,
                                               cuda_device):
        """K1 and K2 in bf16 on the bf16 forward's pooled output and
        winner: every gradient's rms error from the float64 plain level
        within 3x the float32 plain level's own, every positive max routed,
        dW bitwise equal across two launches, one launch of each
        counted."""
        from maskplanner_tpu_torch.ops.cuda.fused_sa import (
            fused_sa_backward_cuda, fused_sa_bf16_cuda,
            fused_sa_bwd_bf16_cuda, sa_weight_grad_bf16_cuda)

        xyz, new_xyz, feats, params, ct = _sa_case(norm, with_features)
        dev = cuda_device
        leaves = [None if a is None else _t(a).to(dev)
                  for a in (xyz, new_xyz, feats)]
        tparams = [tuple(_t(a).to(dev) for a in layer) for layer in params]
        tct = _t(ct).to(dev)
        layer_norm = norm == "layer"
        pooled, idx, winner = fused_sa_bf16_cuda(RADIUS, K, layer_norm,
                                                 *leaves, tparams,
                                                 winner=True)
        before = (fused_sa_bwd_bf16_cuda.launches,
                  sa_weight_grad_bf16_cuda.launches)
        got = _flat(*fused_sa_backward_cuda(K, layer_norm, *leaves, tparams,
                                            idx, pooled, tct, bf16=True,
                                            winner=winner))
        assert (fused_sa_bwd_bf16_cuda.launches,
                sa_weight_grad_bf16_cuda.launches) == (before[0] + 1,
                                                       before[1] + 1)
        again = _flat(*fused_sa_backward_cuda(K, layer_norm, *leaves,
                                              tparams, idx, pooled, tct,
                                              bf16=True, winner=winner))
        n_in = 2 + (feats is not None)
        for a, b in zip(got[n_in:], again[n_in:]):
            assert torch.equal(a, b)

        def plain(dtype):
            ls = [None if t is None else t.to(dtype) for t in leaves]
            ps = [tuple(t.to(dtype) for t in layer) for layer in tparams]
            out, i = fused_sa_forward_plain(RADIUS, K, norm, *ls, ps, "bf16")
            return _flat(*fused_sa_backward_plain(
                K, norm, *ls, ps, i, out, tct.to(dtype), precision="bf16"))

        ref, ref64 = plain(torch.float32), plain(torch.float64)
        for a, b, c in zip(got, ref, ref64):
            rms_k = float((a.double() - c).norm())
            rms_p = float((b.double() - c).norm())
            assert rms_k <= 3.0 * max(rms_p, 5e-4 * float(c.norm()))
        if layer_norm:
            ones = fused_sa_backward_cuda(K, True, *leaves, tparams, idx,
                                          pooled, torch.ones_like(pooled),
                                          bf16=True, winner=winner)[3]
            assert float(ones[-1][3].double().sum()) == float(
                (pooled > 0).sum())
