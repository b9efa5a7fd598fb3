"""The port's adversarial path against the JAX package's, on the CPU.

The DGCNN critic (``get_graph_feature``, train and eval), ``prepare`` for
the three input types, the WGAN-GP penalty and its parameter gradient, one
critic update against optax's Adam (parameters, BatchNorm statistics and
moments: the real pass, then the fake pass, move the statistics and the
penalty's pass moves nothing), the generator's term (its gradient reaches
the prediction only), the minimax variant, two ``gan_train_step``s
against ``make_gan_train_step`` run eagerly at ``discr_train_freq`` 1 and
2 on 2 clouds, and on 4 clouds with both critic updates (the second from
the first's Adam state, and the same 4-cloud steps over 2 gloo ranks),
and the driver (``d_internal_train_loss``, the
critic's state saved and restored bitwise, a fresh critic without it, the
critic's update gated by the run's step count, the backbones it trains).

The critics are dropout-free twins (``dropout_rate=0`` on both sides, set
here); the JAX graph's kNN takes the JAX package's default (matmul) form,
as the port's DGCNN does, while every other distance takes the fixed-order
form (``MASKPLANNER_DETERMINISTIC_NN``) that the port uses. JAX runs
eagerly.

Tolerances: critic outputs within 1e-5 · max|ref| (train mode plus 10x the
port's own float32 error, as the step tests); a loss within 1e-5
relative; gradients and Adam's moments within 1e-4 of the reference's
norm; the updated parameters within 1e-6, or within 2 x lr where the
gradient is below 1e-3 of the largest (Adam's first step moves a
parameter by lr · sign(g), which a near-zero gradient's rounding flips);
BatchNorm statistics within 1e-6 plus 10x the port's own float32 error.
"""
import copy
import functools
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args
from test_torch_port_parallel import join, start

torch.set_num_threads(1)

ROUNDING_FACTOR = 10
# test_torch_port_train.py's factor on the JAX step's own float32 error
JAX_ROUNDING_FACTOR = 3
LR = 1e-4
# the JAX test's small adversarial configuration (tests/test_gan.py)
GAN = ["config=[maskplanner,cuboids_v2]", "lambda_points=1", "overlapping=0",
       "extra_data=[orientnorm]", "knn_gcn=4", "traj_points=24"]


@pytest.fixture(scope="module", autouse=True)
def distances():
    """The fixed-order distances everywhere but in the JAX critic's graph,
    which takes the JAX default form, as the port's critic does."""
    import maskplanner_tpu.ops.sampling as jax_sampling

    mp = pytest.MonkeyPatch()
    mp.setenv("MASKPLANNER_DETERMINISTIC_NN", "1")
    knn = jax_sampling.knn

    def default_form_knn(*args, **kw):
        with pytest.MonkeyPatch.context() as inner:
            inner.delenv("MASKPLANNER_DETERMINISTIC_NN")
            return knn(*args, **kw)

    mp.setattr(jax_sampling, "knn", default_form_knn)
    yield
    mp.undo()


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float64)
            for p, a in jax.tree_util.tree_leaves_with_path(tree)}


def _poses(b=8, n=20, seed=0, shift=0.0):
    """(b, n, 6) poses. 8 clouds: the critic's pooled BatchNorms (bn6, bn7)
    normalise one row a cloud, and over a few rows they amplify rounding."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 6)) * 0.5 + shift).astype(np.float32)


def _pair(kind="wdiscriminator", argv=(), dropout_free=True):
    """(JAX AdversarialLoss with its state, port AdversarialLoss with its
    critic) on the same weights, the critics dropout-free twins."""
    from maskplanner_tpu.losses.gan import AdversarialLoss as JaxAdv
    from maskplanner_tpu.models.dgcnn import DGCNNDiscriminator as JaxD
    from maskplanner_tpu_torch.convert import state_dict_from_flax
    from maskplanner_tpu_torch.losses.gan import AdversarialLoss

    argv = [*GAN, f"loss=[{kind}]", *argv]
    jadv = JaxAdv(jax_load_args(argv=argv), kind=kind)
    adv = AdversarialLoss(load_args(argv=argv), kind=kind)
    if dropout_free and not adv.uses_mlp:
        jadv.module = JaxD(k=4, dropout_rate=0.0)
    y = _poses()
    state = jadv.init_state(jax.random.PRNGKey(0), jnp.asarray(y))
    rng = np.random.default_rng(1)
    # seeded statistics and biases away from 0 and 1
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.uniform(0.1, 0.5, a.shape)
                   ).astype(np.float32), state.batch_stats)
    state = state._replace(batch_stats=stats, opt_state=jadv.tx.init(
        state.params))
    critic = adv.init_state(torch.from_numpy(y), "cpu")
    critic.module.load_state_dict(state_dict_from_flax(
        {"params": state.params, "batch_stats": stats}), strict=True)
    if dropout_free and not adv.uses_mlp:
        critic.module.dropout_rate = 0.0
    return jadv, state, adv, critic


def _stats(critic):
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    return _leaves(flax_tree_from_state_dict(
        critic.module.state_dict())["batch_stats"])


def _grads(module):
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    # a parameter the penalty does not reach (the last bias) has no .grad
    return _leaves(flax_tree_from_state_dict(
        {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in module.named_parameters()})["params"])


def _assert_close_by_norm(got: dict, want: dict, what: str, rel=1e-4,
                          exact: dict | None = None,
                          want_exact: dict | None = None):
    """Within ``rel`` of the whole tree's norm, leaf by leaf; with
    ``exact`` (the port's float64 result) plus 10x the port's own float32
    error on the leaf; with ``want_exact`` (the reference's float64
    result) plus 3x the reference's own float32 error on the leaf."""
    assert got.keys() == want.keys()
    norm = np.sqrt(sum((w ** 2).sum() for w in want.values()))
    assert norm > 0, what
    for k, w in want.items():
        err = np.sqrt(((got[k] - w) ** 2).sum())
        own = (0.0 if exact is None
               else np.sqrt(((got[k] - exact[k]) ** 2).sum()))
        ref_own = (0.0 if want_exact is None
                   else np.sqrt(((w - want_exact[k]) ** 2).sum()))
        assert err <= (rel * norm + ROUNDING_FACTOR * own
                       + JAX_ROUNDING_FACTOR * ref_own), (what, k, err, norm,
                                                          own, ref_own)


# ------------------------------------------------------------ the critic

def test_get_graph_feature_matches_jax():
    from maskplanner_tpu.models.dgcnn import get_graph_feature as jax_ggf
    from maskplanner_tpu_torch.models.dgcnn import get_graph_feature

    x = _poses(2, 17, seed=3)
    ref = np.asarray(jax_ggf(jnp.asarray(x), 4))
    got = get_graph_feature(torch.from_numpy(x), 4).numpy()
    assert got.shape == ref.shape == (2, 17, 4, 12)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # the point itself first: its offset 0
    np.testing.assert_array_equal(got[:, :, 0, :6], 0.0)


@pytest.mark.parametrize("train", [False, True])
def test_dgcnn_critic_matches_jax(train):
    """Eval, and train (batch statistics, the moved statistics)."""
    jadv, state, adv, critic = _pair()
    x = _poses(seed=4)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    if not train:
        ref = np.asarray(jadv.module.apply(variables, jnp.asarray(x),
                                           train=False))
        with torch.no_grad():
            got = critic.module.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        return
    ref, mutated = jadv.module.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    ref = np.asarray(ref)
    outs = {}
    for dtype in (torch.float32, torch.float64):
        c = copy.deepcopy(critic)
        c.module.to(dtype).train()
        with torch.no_grad():
            out = c.module(torch.from_numpy(x).to(dtype)).double().numpy()
        outs[dtype] = out, _stats(c)
    (out, stats), (out64, stats64) = outs.values()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max()
                               + ROUNDING_FACTOR * np.abs(out - out64).max())
    want = _leaves(mutated["batch_stats"])
    assert stats.keys() == want.keys() and len(want) == 14
    for k, w in want.items():
        np.testing.assert_allclose(
            stats[k], w, rtol=0, atol=1e-6 + ROUNDING_FACTOR
            * np.abs(stats[k] - stats64[k]).max(), err_msg=k)


def test_dgcnn_dropout_masks_come_from_the_generator():
    """Train-mode dropout at 0.5: the masks one generator state draws,
    scaled by 2; the same masks give the same logits."""
    _, _, _, critic = _pair(dropout_free=False)
    m = critic.module.train()
    masks = m.dropout_masks(8, torch.Generator().manual_seed(5), "cpu")
    again = m.dropout_masks(8, torch.Generator().manual_seed(5), "cpu")
    assert [t.shape for t in masks] == [(8, 512), (8, 256)]
    for a, b in zip(masks, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert set(a.unique().tolist()) <= {0.0, 2.0}
    x = torch.from_numpy(_poses(seed=6))
    with torch.no_grad():
        c1, c2 = copy.deepcopy(m), copy.deepcopy(m)
        torch.testing.assert_close(c1(x, masks), c2(x, again), rtol=0, atol=0)


def test_one_mask_pair_a_critic_step():
    """Each critic step draws its dropout masks once, and its real, fake
    and interpolated passes all take that pair (the JAX passes share one
    dropout key)."""
    _, _, adv, critic = _pair(argv=["discr_train_iter=2"],
                              dropout_free=False)
    m = critic.module
    drawn, seen = [], []
    draw, forward = m.dropout_masks, m.forward

    def counted(*a, **k):
        drawn.append(draw(*a, **k))
        return drawn[-1]

    def recorded(x, masks=None, generator=None):
        seen.append(masks)
        return forward(x, masks, generator)

    m.dropout_masks, m.forward = counted, recorded
    y, y_pred = (torch.from_numpy(_poses(seed=s)) for s in (16, 17))
    adv.discriminator_update(critic, y_pred, y,
                             generator=torch.Generator().manual_seed(2))
    assert len(drawn) == 2 and len(seen) == 6
    for step, masks in enumerate(drawn):
        assert all(s is masks for s in seen[3 * step:3 * step + 3])


# ------------------------------------------------------------- prepare

PREPARE_CASES = {
    "pointcloud": [],
    "strokecloud": ["discr_input_type=strokecloud"],
    "singlestrokes": ["discr_input_type=singlestrokes", "discr_backbone=mlp",
                      "n_strokes=4"],
    "singlestrokes_norm": ["discr_input_type=singlestrokes",
                           "discr_backbone=mlp", "n_strokes=4",
                           "singlestrokes_norm=true"],
}


@pytest.mark.parametrize("case", sorted(PREPARE_CASES))
def test_prepare_matches_jax(case):
    """Bit for bit, and the critic the JAX factory picks (the MLP for
    single strokes)."""
    from maskplanner_tpu.losses.gan import AdversarialLoss as JaxAdv
    from maskplanner_tpu_torch.losses.gan import AdversarialLoss
    from maskplanner_tpu_torch.models import DGCNNDiscriminator, MLP

    argv = [*GAN, "loss=[wdiscriminator]", *PREPARE_CASES[case]]
    jadv = JaxAdv(jax_load_args(argv=argv))
    adv = AdversarialLoss(load_args(argv=argv))
    y = _poses(2, 8, seed=7).reshape(2, 4, 12)       # 4 strokes of 2 poses
    ref = np.asarray(jadv.prepare(jnp.asarray(y)))
    got = adv.prepare(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7)
    critic = adv.init_state(torch.from_numpy(y), "cpu")
    want = MLP if case.startswith("singlestrokes") else DGCNNDiscriminator
    assert type(critic.module) is want
    assert type(jadv.module).__name__ == want.__name__


def test_singlestrokes_needs_the_mlp_wgan():
    from maskplanner_tpu.losses.gan import AdversarialLoss as JaxAdv
    from maskplanner_tpu_torch.losses.gan import AdversarialLoss

    for kind, extra in (("wdiscriminator", []),
                        ("discriminator", ["discr_backbone=mlp"])):
        argv = [*GAN, f"loss=[{kind}]", "discr_input_type=singlestrokes",
                "n_strokes=4", *extra]
        with pytest.raises(AssertionError):
            JaxAdv(jax_load_args(argv=argv), kind=kind)
        with pytest.raises(AssertionError):
            AdversarialLoss(load_args(argv=argv), kind=kind)


# ------------------------------------------------- penalty and the update

def test_gradient_penalty_and_its_gradient_match_jax():
    """At the same eps: the value within 1e-5 relative plus 10x the port's
    own float32 error and 3x the JAX penalty's (the step tests' rule), its
    parameter gradient (through the double backward) within 1e-4 of its
    norm, and the statistics not moved by the penalty's train-mode pass."""
    jadv, state, adv, critic = _pair()
    real, fake = _poses(seed=8), _poses(seed=9, shift=0.3)
    eps = np.random.default_rng(2).uniform(size=(8, 1, 1)).astype(np.float32)

    def jax_gp(params, flip=slice(None)):
        return jadv.gradient_penalty(params, state.batch_stats,
                                     jnp.asarray(real[flip]),
                                     jnp.asarray(fake[flip]),
                                     jnp.asarray(eps[flip]))

    ref, ref_g = jax.value_and_grad(jax_gp)(state.params)
    # the JAX penalty's own float32 rounding, sampled on the reversed batch
    own = abs(float(jax_gp(state.params, slice(None, None, -1))) - float(ref))
    twin = copy.deepcopy(critic)
    twin.module.double().train()
    exact = adv.gradient_penalty(twin, *(torch.from_numpy(a).double()
                                         for a in (real, fake, eps))).item()
    before = _stats(critic)
    critic.module.train()
    gp = adv.gradient_penalty(critic, torch.from_numpy(real),
                              torch.from_numpy(fake), torch.from_numpy(eps))
    gp.backward()
    np.testing.assert_allclose(gp.item(), float(ref), rtol=0, atol=1e-5 * abs(
        float(ref)) + ROUNDING_FACTOR * abs(gp.item() - exact) + 3.0 * own)
    assert float(ref) > 1e-3
    _assert_close_by_norm(_grads(critic.module), _leaves(ref_g), "gp grad")
    after = _stats(critic)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def _moments(critic) -> tuple[dict, dict]:
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    opt, named = critic.optimizer, dict(critic.module.named_parameters())
    return tuple(_leaves(flax_tree_from_state_dict(
        {n: opt.state[p][key] for n, p in named.items()})["params"])
        for key in ("exp_avg", "exp_avg_sq"))


def _assert_update_matches(new_state, critic, ref_g, twin=None, steps=1):
    """The port critic after its update against the JAX state: Adam's
    moments within 1e-4 of their norm, the parameters by lr · sign(g).
    With ``twin`` (the same update in float64) the moments may also differ
    by 10x the port's own float32 error on them, and every parameter by 2 x
    lr a step of the ``steps`` Adam has taken (where rounding decides the
    moments, it decides Adam's signs) -> the port's and JAX's
    statistics."""
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    adam = new_state.opt_state[0]
    own = ([0.0, 0.0] if twin is None else
           [np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
            for a, b in zip(_moments(critic), _moments(twin))])
    for got, want, err, what in zip(_moments(critic), (adam.mu, adam.nu),
                                    own, ("mu", "nu")):
        want = _leaves(want)
        norm = np.sqrt(sum((w ** 2).sum() for w in want.values()))
        total = np.sqrt(sum(((got[k] - w) ** 2).sum()
                            for k, w in want.items()))
        assert total <= 1e-4 * norm + ROUNDING_FACTOR * err, (what, total,
                                                              norm, err)
    params = _leaves(flax_tree_from_state_dict(
        dict(critic.module.named_parameters()))["params"])
    grads = _leaves(ref_g)
    largest = max(np.abs(g).max() for g in grads.values())
    for k, w in _leaves(new_state.params).items():
        # a bias that a train-mode BatchNorm normalises has gradient 0 in
        # exact arithmetic: all of it is rounding
        small = (np.abs(grads[k]) < 1e-3 * largest) | (twin is not None)
        tol = np.where(small, 2 * LR * steps, 0.0) + 1e-6
        assert (np.abs(params[k] - w) <= tol).all(), k
    return _stats(critic), _leaves(new_state.batch_stats)


@pytest.mark.parametrize("kind", ["wdiscriminator", "discriminator"])
def test_discriminator_update_matches_optax(kind):
    """One critic step: its loss, Adam's moments, the parameters, and the
    statistics moved by the real then the fake pass only (against the
    same passes run by hand in that order)."""
    jadv, state, adv, critic = _pair(kind)
    y, y_pred = _poses(seed=10), _poses(seed=11, shift=0.2)
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.uniform(jax.random.split(key, 1)[0],
                                      (8, 1, 1)))
    twin = copy.deepcopy(critic)
    new_state, ref_loss = jadv.discriminator_update(
        state, jnp.asarray(y_pred), jnp.asarray(y), key)
    loss = adv.discriminator_update(critic, torch.from_numpy(y_pred),
                                    torch.from_numpy(y),
                                    eps=torch.from_numpy(eps)[None])
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    # the JAX update's gradient, for the parameters' rule
    ref_g = jax.tree_util.tree_map(lambda m: m / 0.1,
                                   new_state.opt_state[0].mu)
    got, want = _assert_update_matches(new_state, critic, ref_g)
    # the statistics: the real pass, then the fake pass, in float64 too
    exact = {}
    for dtype in (torch.float32, torch.float64):
        c = copy.deepcopy(twin)
        c.module.to(dtype).train()
        with torch.no_grad():
            for t in (y, y_pred):
                c.module(torch.from_numpy(t).to(dtype))
        exact[dtype] = _stats(c)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], exact[torch.float32][k],
                                      err_msg=k)
        np.testing.assert_allclose(
            got[k], w, rtol=0, atol=1e-6 + ROUNDING_FACTOR * np.abs(
                got[k] - exact[torch.float64][k]).max(), err_msg=k)


def test_discr_train_iter_takes_that_many_steps():
    """``discr_train_iter=2``: two Adam steps, bitwise two updates of one
    step with the same draws, the second's loss returned. (Against JAX a
    second step is not comparable: it starts where the first step's Adam
    signs of near-zero gradients, ±lr each, fell.)"""
    _, _, adv2, critic = _pair(argv=["discr_train_iter=2"])
    _, _, adv1, _ = _pair()
    y, y_pred = (torch.from_numpy(_poses(seed=s)) for s in (14, 15))
    eps = torch.rand(2, 8, 1, 1, generator=torch.Generator().manual_seed(1))
    one = copy.deepcopy(critic)
    loss = adv2.discriminator_update(critic, y_pred, y, eps=eps)
    for i in range(2):
        last = adv1.discriminator_update(one, y_pred, y, eps=eps[i:i + 1])
    assert float(loss) == float(last)
    for s in (critic, one):
        assert all(int(v["step"]) == 2 for v in s.optimizer.state.values())
    for a, b in zip(critic.module.state_dict().values(),
                    one.module.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["wdiscriminator", "discriminator"])
def test_generator_loss_matches_jax_and_spares_the_critic(kind):
    """The value within 1e-5 relative and its gradient with respect to the
    prediction within 1e-4 of its norm; no gradient on any critic
    parameter, the statistics unmoved."""
    jadv, state, adv, critic = _pair(kind)
    y_pred = _poses(seed=12, shift=0.1)
    ref, ref_g = jax.value_and_grad(
        lambda yp: jadv.generator_loss(state, yp))(jnp.asarray(y_pred))
    before = _stats(critic)
    t = torch.from_numpy(y_pred).requires_grad_(True)
    loss = adv.generator_loss(critic, t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    _assert_close_by_norm({"y": t.grad.numpy().astype(np.float64)},
                          {"y": np.asarray(ref_g, np.float64)}, "dy")
    assert all(p.grad is None for p in critic.module.parameters())
    after = _stats(critic)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])


def test_minimax_critic_is_dgcnn_whatever_the_backbone():
    from maskplanner_tpu_torch.models import DGCNNDiscriminator

    _, _, adv, critic = _pair("discriminator", ["discr_backbone=mlp"])
    assert not adv.uses_mlp
    assert type(critic.module) is DGCNNDiscriminator


def test_penalty_sees_nontrivial_gradients():
    """The whole-batch train-mode critic gives the penalty O(1) gradient
    norms (a per-sample pass would give ~0)."""
    _, _, adv, critic = _pair()
    real = torch.from_numpy(_poses(4, seed=13))
    eps = torch.rand(4, 1, 1, generator=torch.Generator().manual_seed(0))
    interp = (eps * real + (1 - eps) * (real + 0.3)).requires_grad_(True)
    critic.module.train()
    (g,) = torch.autograd.grad(critic.module(interp).sum(), interp)
    assert float(g.reshape(4, -1).norm(dim=-1).min()) > 1e-3


# ----------------------------------------------------------- the GAN step

STEP = ["config=[pointWise,cuboids_v2,longx_v2,debug]", "pc_points=64",
        "n_pred_traj_points=80", "model.hidden_size=[32,32]",
        "loss=[chamfer,wdiscriminator]", "weight_wdiscriminator=0.01",
        "knn_gcn=4", "batch_size=2"]


def _jax_gan_steps(batch, freqs=(1, 2), start=None, y_pred=None,
                   second=True):
    """``make_gan_train_step`` run eagerly (Adam at lr 0 for the generator,
    whose gradients Adam's first moment keeps; FPS from index 0; no
    dropout): one step, then from its state a second step at each
    ``discr_train_freq`` of ``freqs`` -> ({freq: [step 1, step 2]}, each a
    dict of the loss, the terms, the states, the penalty's mixing weights
    and the prediction the critic's update took), the initial variables
    and the critic's initial state. ``start``: (variables, critic state)
    to start from in place of the seeded ones; ``y_pred``: the loss batch
    takes it in value, its gradient still reaching the generator (as
    ``_port_gan_steps``'s); without ``second`` the first step alone."""
    import flax.linen as fnn
    import optax

    import maskplanner_tpu.models.pointnet2 as jax_pointnet2
    import maskplanner_tpu.train.trainer as jax_trainer
    from maskplanner_tpu.losses import LossHandler as JaxLossHandler
    from maskplanner_tpu.losses.gan import AdversarialLoss as JaxAdv
    from maskplanner_tpu.models import get_model as get_flax_model
    from maskplanner_tpu.models.dgcnn import DGCNNDiscriminator as JaxD
    from maskplanner_tpu.train.trainer import (TrainState,
                                               make_gan_train_step)

    cfg = jax_load_args(argv=STEP)
    model = get_flax_model(cfg)
    pc = jnp.asarray(batch["point_cloud"])
    # seeded non-zero biases and scales: at Flax's zero biases sa1's first
    # LayerNorm sees constant rows (see tests/test_torch_port_train.py)
    rng_np = np.random.default_rng(0)
    variables = start[0] if start else jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rng_np.normal(size=a.shape) * 0.1
                      ).astype(np.float32)
        if p[-1].key in ("bias", "scale", "mean") else
        (rng_np.uniform(0.5, 1.5, a.shape).astype(np.float32)
         if p[-1].key == "var" else np.asarray(a)),
        model.init(jax.random.PRNGKey(1), pc, train=False))
    state = TrainState.create(apply_fn=model.apply,
                              params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              tx=optax.adam(0.0))
    handler = JaxLossHandler(cfg["loss"], cfg)
    rng = jax.random.PRNGKey(4)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        fps = jax_pointnet2.farthest_point_sample
        mp.setattr(jax_pointnet2, "farthest_point_sample",
                   lambda xyz, npoint, key=None, **k: fps(xyz, npoint, **k))
        if y_pred is not None:
            build = jax_trainer.build_loss_batch

            def shared(out, b, config):
                lb = build(out, b, config)
                fixed = jnp.asarray(y_pred, lb["y_pred"].dtype)
                lb["y_pred"] = lb["y_pred"] + jax.lax.stop_gradient(
                    fixed - lb["y_pred"])
                return lb

            mp.setattr(jax_trainer, "build_loss_batch", shared)
        steps, seen = {}, []
        for freq in freqs:
            adv = JaxAdv(jax_load_args(argv=[*STEP,
                                             f"discr_train_freq={freq}"]),
                         kind="wdiscriminator")
            adv.module = JaxD(k=4, dropout_rate=0.0)
            # the step unjitted (eager, as the port runs: under jit XLA
            # fuses the fixed-order distance sums, and near-ties fall the
            # other way)
            steps[freq] = make_gan_train_step(model, handler, cfg,
                                              adv).__wrapped__
            # the prediction handed to the critic's update (a concrete
            # array: the update's branch closes over it)
            update = adv.discriminator_update

            def recorded(ds, y_pred, *a, update=update):
                seen.append(np.asarray(y_pred))
                return update(ds, y_pred, *a)

            adv.discriminator_update = recorded
        d0 = start[1] if start else adv.init_state(
            jax.random.PRNGKey(2), jnp.asarray(batch["traj"]))

        def run(freq, st, ds):
            seen.clear()
            # the penalty's mixing weights of this step's critic update
            d_rng = jax.random.split(jax.random.fold_in(rng, st.step), 4)[2]
            eps = np.array(jax.random.uniform(jax.random.split(d_rng, 1)[0],
                                              (len(batch["traj"]), 1, 1)))
            st, ds, loss, terms = steps[freq](st, ds, jb,
                                              handler.init_weights(), rng)
            return dict(loss=float(loss),
                        terms={k: float(v) for k, v in terms.items()},
                        state=st, d_state=ds, eps=eps,
                        y_pred=seen[-1] if seen else None)

        first = run(1, state, d0)       # step 0: an update at either freq
        out = {freq: [first] + ([run(freq, first["state"],
                                     first["d_state"])] if second else [])
               for freq in freqs}
    return out, variables, d0


def _jax_first_step_x64(batch, variables, d0, y_pred):
    """JAX's first step (``_jax_gan_steps``) in float64 from the same
    float32 weights, on the batch in float64, the loss batch taking
    ``y_pred`` (the float32 step's prediction) in value: under
    ``jax.enable_x64`` with ``jnp.float32`` read as float64 (the package
    names float32 where it means its working precision). FPS, whose
    distances the package takes in float32 whatever the input, picks as
    in float32 -> the generator's gradients by leaf (Adam's first moment
    over 0.1)."""
    def f64(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    b64 = {k: f64(v) for k, v in batch.items()}
    start64 = jax.tree_util.tree_map(f64, (variables, d0))
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        ref, _, _ = _jax_gan_steps(b64, (1,), start=start64,
                                   y_pred=f64(y_pred), second=False)
        return _leaves(jax.tree_util.tree_map(
            lambda m: np.asarray(m, np.float64) / 0.1,
            ref[1][0]["state"].opt_state[0].mu))


def _port_gan_steps(batch, variables, d_state, eps_list, dtype,
                    freqs=(1, 2), y_pred=None):
    """The port's ``gan_train_step`` on the same weights and mixing
    weights in ``dtype``: one step, then from its state a second one at
    each ``discr_train_freq`` of ``freqs`` -> {freq: [step 1, step 2]},
    each with the generator's own prediction.

    With ``y_pred`` (the JAX step's prediction) the loss batch takes it in
    value, its gradient still reaching the port's generator: the critic's
    kNN graph in feature space is not continuous in its input, and at 4
    clouds the two generators' float32 predictions, 4e-4 apart (the port's
    own float32 error 1.2e-4), move the critic's logits by percents (JAX's
    critic on the port's prediction gives the port's term within 4e-6).
    So both critics see one input, and the terms and the updates are
    comparable."""
    from maskplanner_tpu_torch.convert import state_dict_from_flax
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.losses.gan import AdversarialLoss
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import batch_to_device, gan_train_step
    from maskplanner_tpu_torch.train import trainer

    cfg = load_args(argv=STEP)
    model = get_model(cfg, device="cpu", dropout=0.0)
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    model.to(dtype)
    optimizer = torch.optim.Adam(model.parameters(), lr=0.0)
    adv = AdversarialLoss(cfg, kind="wdiscriminator")
    critic = adv.init_state(torch.from_numpy(batch["traj"]), "cpu")
    critic.module.load_state_dict(state_dict_from_flax(
        {"params": d_state.params, "batch_stats": d_state.batch_stats}),
        strict=True)
    critic.module.dropout_rate = 0.0
    critic.module.to(dtype)
    handler = LossHandler(cfg["loss"], cfg)
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in batch_to_device(batch, "cpu").items()}

    def run(freq, step, model, optimizer, critic, eps):
        adv.train_freq = freq
        adv.discriminator_update = functools.partial(
            AdversarialLoss.discriminator_update, adv,
            eps=torch.from_numpy(eps).to(dtype)[None])
        own = []

        def loss_batch(out, batch, build=trainer.build_loss_batch):
            lb = build(out, batch)
            own.append(lb["y_pred"].detach().double().numpy())
            if y_pred is not None:
                shift = torch.from_numpy(y_pred).to(dtype) - lb["y_pred"]
                lb["y_pred"] = lb["y_pred"] + shift.detach()
            return lb

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(trainer, "build_loss_batch", loss_batch)
            loss, terms = gan_train_step(model, optimizer, handler, b,
                                         handler.init_weights(), adv=adv,
                                         critic=critic, step=step)
        # a parameter the loss does not reach (the mask heads, under the
        # chamfer) has no Adam state: its moment is 0
        return dict(loss=float(loss),
                    terms={k: float(v) for k, v in terms.items()},
                    critic=copy.deepcopy(critic), y_pred=own[0],
                    mu={n: optimizer.state[p]["exp_avg"].clone()
                        if p in optimizer.state else torch.zeros_like(p)
                        for n, p in model.named_parameters()})

    first = run(1, 0, model, optimizer, critic, eps_list[0])
    out = {}
    for freq in freqs:
        m, o, c = copy.deepcopy((model, optimizer, critic))
        out[freq] = [first, run(freq, 1, m, o, c, eps_list[1])]
    return out


def _gan_steps(clouds, freqs, shared_prediction, tmp=None):
    """The JAX steps on ``clouds`` train items and the port's in float32
    and float64 -> (JAX, {dtype: port}); with ``shared_prediction`` also
    the JAX first step's generator gradients in float64
    (``_jax_first_step_x64``) and the port's step over 2 gloo ranks
    (``_two_rank_gan_steps``), started beside the JAX steps."""
    from maskplanner_tpu.data import PaintDataset as JaxPaintDataset
    from maskplanner_tpu.data import collate

    cfg = jax_load_args(argv=STEP)
    batch = collate([JaxPaintDataset(cfg, split="train", size=clouds)[i]
                     for i in range(clouds)])
    ref, variables, d0 = _jax_gan_steps(batch, freqs)
    eps = [r["eps"] for r in ref[1]]
    # the generator's learning rate is 0: both steps predict alike
    y_pred = np.array(ref[1][0]["y_pred"])
    for steps in ref.values():
        for r in steps:
            assert r["y_pred"] is None or (r["y_pred"] == y_pred).all()
    if shared_prediction:
        ranks = start(_two_rank_gan_steps, 2, tmp, batch, variables,
                      jax.tree_util.tree_map(np.asarray, d0), eps, y_pred)
    got = {dtype: _port_gan_steps(batch, variables, d0, eps, dtype, freqs,
                                  y_pred if shared_prediction else None)
           for dtype in (torch.float32, torch.float64)}
    if not shared_prediction:
        return ref, got
    return ref, got, _jax_first_step_x64(batch, variables, d0,
                                         y_pred), join(ranks)


@pytest.fixture(scope="module")
def gan_steps():
    return _gan_steps(2, (1, 2), shared_prediction=False)


@pytest.fixture(scope="module")
def gan_steps_4(tmp_path_factory):
    return _gan_steps(4, (1,), shared_prediction=True,
                      tmp=tmp_path_factory.mktemp("gan_ranks"))


def _two_rank_gan_steps(rank, world, batch, variables, d0, eps, y_pred):
    """``_port_gan_steps`` (``discr_train_freq`` 1) on this rank's rows of
    ``batch`` and of the shared prediction, in a gloo group of ``world``
    -> {dtype: [step 1, step 2]}."""
    from maskplanner_tpu_torch.parallel import shard_rows

    def rows(a):
        return shard_rows(torch.from_numpy(np.asarray(a)), rank,
                          world).numpy()

    mine = {k: rows(v) for k, v in batch.items()}
    return {dtype: _port_gan_steps(mine, variables, d0, eps, dtype, (1,),
                                   rows(y_pred))[1]
            for dtype in (torch.float32, torch.float64)}


def _assert_step_matches(r, g, e, what, skip=()):
    """A step's loss and terms but those in ``skip``, JAX against the port
    (and its float64 twin): ``test_gan_train_step_matches_jax``'s rule."""
    assert set(g["terms"]) == set(r["terms"]) == {
        "chamfer", "wdiscriminator", "d_internal"}
    np.testing.assert_allclose(
        g["loss"], r["loss"], rtol=1e-5,
        atol=ROUNDING_FACTOR * abs(g["loss"] - e["loss"]))
    for k, v in r["terms"].items():
        if k in skip:
            continue
        if v == 0.0:
            assert g["terms"][k] == 0.0, (what, k)
            continue
        own = ROUNDING_FACTOR * abs(g["terms"][k] - e["terms"][k])
        np.testing.assert_allclose(g["terms"][k], v, rtol=1e-5,
                                   atol=1e-6 + own, err_msg=f"{what} {k}")


@pytest.mark.parametrize("freq", [1, 2])
def test_gan_train_step_matches_jax(freq, gan_steps):
    """Two steps: the loss and its terms (``d_internal`` the critic's loss,
    0 on a step without its update) within 1e-5 relative (1e-6 absolute
    for the adversarial term, a mean of logits near 0), the generator's
    gradients (Adam's first moment) within 1e-4 of their norm, and the
    critic's first update by the update's rules; each value and gradient
    may also differ by 10x the port's own float32 error (the same steps in
    float64; the step tests' rule). The second update: finite; at 2 clouds
    the critic's train-mode BatchNorms after the pooling normalise 2 rows,
    and its penalty is not comparable even between the port's float32 and
    float64 (40% apart on one prediction), so
    ``test_gan_train_step_carries_the_critic_like_jax`` holds it at 4.
    With ``discr_train_freq=2`` the second step leaves the critic bitwise
    as it was."""
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    ref = gan_steps[0][freq]
    got, exact = (gan_steps[1][dtype][freq]
                  for dtype in (torch.float32, torch.float64))
    for i, (r, g, e) in enumerate(zip(ref, got, exact)):
        _assert_step_matches(r, g, e, f"step {i}",
                             skip=("d_internal",) if i == 1 else ())
        assert np.isfinite(g["terms"]["d_internal"])
        mu, mu64 = (_leaves(flax_tree_from_state_dict(x["mu"])["params"])
                    for x in (g, e))
        _assert_close_by_norm(mu, _leaves(r["state"].opt_state[0].mu),
                              f"step {i} generator", exact=mu64)
        if i == 0:
            ref_g = jax.tree_util.tree_map(lambda m: m / 0.1,
                                           r["d_state"].opt_state[0].mu)
            _assert_update_matches(r["d_state"], g["critic"], ref_g,
                                   twin=e["critic"])
    assert (ref[1]["terms"]["d_internal"] == 0.0) == (freq == 2)
    if freq == 2:
        for a, b in zip(got[0]["critic"].module.state_dict().values(),
                        got[1]["critic"].module.state_dict().values()):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def _generator_grads(steps: list, step: int, jax_side: bool) -> dict:
    """The generator's gradients of ``step`` from Adam's first moments at
    lr 0 (mu_1 = 0.1 g_1, mu_2 = 0.9 mu_1 + 0.1 g_2), by leaf."""
    from maskplanner_tpu_torch.convert import flax_tree_from_state_dict

    def mu(x):
        if jax_side:
            return _leaves(x["state"].opt_state[0].mu)
        return _leaves(flax_tree_from_state_dict(x["mu"])["params"])

    now = mu(steps[step])
    before = mu(steps[step - 1]) if step else {k: 0.0 for k in now}
    return {k: (v - 0.9 * before[k]) / 0.1 for k, v in now.items()}


def _assert_generator_grads(port32, port64, ref, jax64, step: int,
                            what: str):
    """The generator's gradients of ``step``, the port's (``port32``, its
    float64 twin ``port64``: lists of steps) against JAX's (``ref``) by
    repair of the 4-cloud gap: within 1e-4 of the gradients' norm plus 10x
    the port's own float32 error plus 3x JAX's own, JAX's float32 first
    step against its float64 one (``jax64``, ``_jax_first_step_x64``).
    The second step's gradients differ from the first's by the critic's
    term alone (1% of the loss; lr 0), so JAX's own error there is taken
    as the first step's."""
    jax32 = [_generator_grads(ref, i, True) for i in range(step + 1)]
    want_exact = {k: v - (jax32[0][k] - jax64[k])
                  for k, v in jax32[step].items()}
    _assert_close_by_norm(_generator_grads(port32, step, False), jax32[step],
                          what, exact=_generator_grads(port64, step, False),
                          want_exact=want_exact)


@pytest.mark.parametrize("step", [0, 1])
def test_gan_train_step_carries_the_critic_like_jax(step, gan_steps_4):
    """Two steps on 4 clouds, each updating the critic, the second from
    the first's Adam state: the loss and its terms by
    ``test_gan_train_step_matches_jax``'s rule, the generator's prediction
    within 1e-5 of its largest entry plus 10x the port's own float32
    error, the critic after the update by the update's rules (Adam
    moves a parameter by at most lr a step), and the generator's gradients
    by ``_assert_generator_grads``. The loss batch takes the JAX step's
    prediction in value (``_port_gan_steps``). At 4 clouds the first
    level's bias gradient lies 1.4e-3 of the gradients' norm from JAX's,
    where the port's own float32 error is 3e-5: it is JAX's own float32
    error (Flax's LayerNorm takes the variance as E[x²] − E[x]² in one
    pass; ROADMAP.md, Queue 3), which its float64 step, 2e-8 from the
    port's, measures."""
    ref, got, jax64, _ = gan_steps_4
    r = ref[1][step]
    g, e = (got[dtype][1][step] for dtype in (torch.float32, torch.float64))
    _assert_step_matches(r, g, e, f"step {step}")
    assert r["terms"]["d_internal"] > 0.0
    want = r["y_pred"]
    np.testing.assert_allclose(
        g["y_pred"], want, rtol=0, atol=1e-5 * np.abs(want).max()
        + ROUNDING_FACTOR * np.abs(g["y_pred"] - e["y_pred"]).max())
    ref_g = jax.tree_util.tree_map(lambda m: m / 0.1,
                                   r["d_state"].opt_state[0].mu)
    _assert_update_matches(r["d_state"], g["critic"], ref_g,
                           twin=e["critic"], steps=step + 1)
    _assert_generator_grads(got[torch.float32][1], got[torch.float64][1],
                            ref[1], jax64, step, f"generator, step {step}")


@pytest.mark.parametrize("step", [0, 1])
def test_gan_step_over_two_ranks_matches_jax(step, gan_steps_4):
    """The port's GAN step over 2 gloo ranks, each with 2 of the 4 clouds
    and its rows of the shared prediction, against the eager JAX step at
    the global batch of 4, by the 4-cloud test's rules with the 2-rank
    step's own float32 error (the same ranks in float64): the loss and its
    terms, the critic after each update, the generator's gradients. The
    ranks' losses, critics and generator moments are bitwise equal."""
    ref, _, jax64, ranks = gan_steps_4
    r = ref[1][step]
    g, e = (ranks[0][dtype][step] for dtype in (torch.float32, torch.float64))
    _assert_step_matches(r, g, e, f"2 ranks, step {step}")
    ref_g = jax.tree_util.tree_map(lambda m: m / 0.1,
                                   r["d_state"].opt_state[0].mu)
    _assert_update_matches(r["d_state"], g["critic"], ref_g,
                           twin=e["critic"], steps=step + 1)
    _assert_generator_grads(ranks[0][torch.float32], ranks[0][torch.float64],
                            ref[1], jax64, step,
                            f"2 ranks, generator, step {step}")
    other = ranks[1][torch.float32][step]
    assert other["loss"] == g["loss"] and other["terms"] == g["terms"]
    for a, b in zip(g["critic"].module.state_dict().values(),
                    other["critic"].module.state_dict().values()):
        assert torch.equal(a, b)
    for n, m in g["mu"].items():
        assert torch.equal(m, other["mu"][n]), n


# ------------------------------------------------------------ the driver

DRIVER = ["config=[pointWise,cuboids_v2,longx_v2,debug]",
          "loss=[chamfer,wdiscriminator]", "weight_wdiscriminator=0.01",
          "discr_train_iter=1", "knn_gcn=4", "pc_points=64",
          "n_pred_traj_points=80", "batch_size=2", "epochs=2",
          "eval_freq=2", "dataset_size=2", "test_dataset_size=2",
          "no_save=false", "seed=3", "device=cpu", "skip_rendering=true"]


def test_driver_trains_the_gan_and_restores_its_critic(tmp_path):
    """2 epochs: finite losses, ``d_internal_train_loss`` logged, the
    critic's state beside ``last_checkpoint`` and ``best_model``; a resume
    restores it bitwise, and without the file the critic starts fresh."""
    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.convert import checkpoint_path

    run_dir, _ = train_maskplanner.main([*DRIVER, f"output_dir={tmp_path}"])
    logs = [json.loads(line)
            for line in open(os.path.join(run_dir, "logs.jsonl"))]
    assert len(logs) == 2
    for key in ("train_loss", "d_internal_train_loss",
                "wdiscriminator_train_loss"):
        assert all(np.isfinite(log[key]) for log in logs), key
    assert logs[-1]["wdiscriminator_eval_loss"] == 0.0
    aux = checkpoint_path(run_dir, "last_checkpoint_aux")
    assert os.path.isfile(aux)
    assert os.path.isfile(checkpoint_path(run_dir, "best_model_aux"))
    saved = torch.load(aux, weights_only=True)

    seen = []
    load = train_maskplanner.load_aux_state

    def recorded(run, name, critic):
        found = load(run, name, critic)
        seen.append((found, copy.deepcopy(critic.state_dict())))
        return found

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_maskplanner, "load_aux_state", recorded)
        train_maskplanner.main([f"resume={run_dir}", "epochs=3"])
        (found, state), = seen
        assert found
        for k, v in saved["module"].items():
            torch.testing.assert_close(state["module"][k], v, rtol=0, atol=0)
        for i, s in saved["optimizer"]["state"].items():
            for k, v in s.items():
                torch.testing.assert_close(
                    state["optimizer"]["state"][i][k], v, rtol=0, atol=0)
        os.remove(aux)
        seen.clear()
        train_maskplanner.main([f"resume={run_dir}", "epochs=4"])
        (found, state), = seen
        assert not found and state["optimizer"]["state"] == {}
    logs = [json.loads(line)
            for line in open(os.path.join(run_dir, "logs.jsonl"))]
    assert [log["epoch"] for log in logs] == [1, 2, 3, 4]


def test_driver_gates_the_critic_by_the_runs_step_count(tmp_path):
    """``discr_train_freq=2``, one step an epoch: the critic updates at
    steps 0 and 2 (``d_internal_train_loss`` 0 at step 1), and a resume
    counts on from the checkpoint's step (as the JAX step reads
    ``state.step``)."""
    from maskplanner_tpu_torch import train_maskplanner

    run_dir, _ = train_maskplanner.main([*DRIVER, "discr_train_freq=2",
                                         f"output_dir={tmp_path}"])
    train_maskplanner.main([f"resume={run_dir}", "epochs=3"])
    d = [json.loads(line)["d_internal_train_loss"]
         for line in open(os.path.join(run_dir, "logs.jsonl"))]
    assert len(d) == 3 and d[1] == 0.0
    assert d[0] != 0.0 and d[2] != 0.0 and all(np.isfinite(d))


TRAINED = ["pointnet", "pointnet_deeper", "pointnet_segmenter",
           "pointnet_segmenter_conv1d", "pointnet2_segmenter_v1",
           "pointnet2_segmenter_paintnet_v1"]


@pytest.mark.parametrize("backbone", TRAINED)
def test_driver_trains_what_the_jax_driver_trains(backbone, tmp_path):
    """A 2-epoch run on point clouds with the chamfer loss, as the JAX
    driver trains these backbones: finite losses (without orientations
    for PointNet, as the factory asserts; ``latent_dim`` for the
    segmenters)."""
    from maskplanner_tpu_torch import train_maskplanner

    extra = (["extra_data=[]"] if backbone in ("pointnet", "pointnet_deeper")
             else ["latent_dim=6"])
    run_dir, _ = train_maskplanner.main([
        "config=[pointWise,cuboids_v2,longx_v2,debug]", "pc_points=64",
        "n_pred_traj_points=80", "batch_size=2", "epochs=2", "eval_freq=2",
        "dataset_size=2", "test_dataset_size=2", "loss=[chamfer]",
        "eval_metrics=[]", "device=cpu", f"model.backbone={backbone}",
        f"output_dir={tmp_path}", *extra])
    logs = [json.loads(line)
            for line in open(os.path.join(run_dir, "logs.jsonl"))]
    assert len(logs) == 2 and all(np.isfinite(log["train_loss"])
                                  for log in logs)


@pytest.mark.parametrize("backbone", ["mlp_generator", "dgcnn"])
def test_driver_refuses_what_the_jax_driver_cannot_train(backbone, tmp_path):
    """The JAX driver fails on these (a point cloud reshaped as noise; the
    critic's logits under the chamfer): the port refuses them up front."""
    from maskplanner_tpu_torch import train_maskplanner

    with pytest.raises(NotImplementedError, match="no loss batch"):
        train_maskplanner.main([*DRIVER, f"model.backbone={backbone}",
                                "extra_data=[]", f"output_dir={tmp_path}"])
