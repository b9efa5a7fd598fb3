"""The adversarial training step under data parallelism, on the CPU: 2
gloo ranks, each a spawned process with its rows of the global batch
(``tests/test_torch_port_parallel.py``'s harness).

- The double backward across ranks: a penalty of the input gradient's
  norm through a global BatchNorm (``parallel.mean_over_ranks``), its
  parameter gradients over 2 ranks equal to the single process's at the
  global batch within float64 rounding (1e-12 of their norm), where
  ``_AllReduce``'s backward is itself differentiable; its old backward, a
  raw all-reduce that autograd cannot see, misses the other rank's
  second-order terms and fails the same comparison.
- The GAN step (``train.trainer.gan_train_step``, WGAN-GP, a DGCNN critic
  with its dropout, the generator's FPS starts and dropout drawn from one
  seeded generator, the penalty's mixing weights drawn too) over 2 ranks
  against the single process at the global batch of 8, for two steps
  (each with the critic's update; the generator's Adam at lr 0, so that
  its first moment keeps each step's gradient): the loss and its terms,
  the generator's gradients, the critic's Adam moments, its parameters
  and its BatchNorm statistics after each update.

  Held in float64, both steps, within 1e-9 (the reduction order; they
  meet 1e-12) of each gradient or moment tree's norm (a gradient that is
  0 in exact arithmetic, as a bias before a train-mode BatchNorm has, is
  all rounding) and of each statistic's and parameter's own. In float32
  the first step, within 3x the single process's own float32 error (its
  distance from its float64 twin) plus 1e-6 of the norm: the generator's
  gradients and the critic's moments as whole trees (one tensor's own
  error is one draw of the rounding, which two runs of this step draw up
  to 8x apart), each critic statistic on its own, each critic parameter
  within Adam's 2 x lr (Adam moves it by lr times the sign of its
  gradient, which rounding decides where the gradient is near 0):
  this step is ill-conditioned in float32 (the single process's own
  error on the generator's gradients is 2e-3 of their norm, on the
  critic's update loss 1e-3), and after one critic update the float32
  runs part by more than their own error, so the second step is held in
  float64 alone. ``linear2.bias`` and ``linear3.bias`` of the critic have
  an update gradient of 0 in exact arithmetic (bn7 cancels the one, the
  WGAN loss and the penalty the other; checked: below 1e-9 of the largest
  in float64), and Adam would move them by lr on the sign of rounding,
  which the two sides draw differently: every run here zeroes their
  gradient before the critic's Adam, so the second step starts from
  comparable critics. The ranks' critics are bitwise equal.
- Three controls, each one piece of the design undone, must fail the
  float64 comparison of the first step: per-rank statistics in the critic's BatchNorms
  during its update, a per-rank penalty mean (each rank's penalty taken
  as a whole loss, not as its share), and ``_AllReduce``'s old backward.

The 2-rank step against the JAX package's is in
``tests/test_torch_port_gan.py``, beside the JAX steps it shares.
"""
import numpy as np
import pytest
import torch

from test_torch_port_parallel import join, start

torch.set_num_threads(1)

STEP = ["config=[pointWise,cuboids_v2,longx_v2,debug]", "pc_points=64",
        "n_pred_traj_points=80", "model.hidden_size=[32,32]",
        "loss=[chamfer,wdiscriminator]", "weight_wdiscriminator=0.01",
        "knn_gcn=4", "batch_size=8"]
GLOBAL_BATCH = 8
WORLD = 2
STEPS = 2
DRAW_SEED = 3
CRITIC_LR = 1e-4
# the allowances: float64 against float64, float32 against the single
# process's own float32 error
F64_REL = 1e-9
OWN_FACTOR = 3.0
F32_FLOOR = 1e-6
# the critic's parameters whose update gradient is 0 in exact arithmetic
CRITIC_ZERO = ("linear2.bias", "linear3.bias")
CONTROLS = ("critic_local_statistics", "per_rank_penalty", "raw_backward")


# ---- the double backward ----------------------------------------------------

def _penalty_net(state=None):
    from maskplanner_tpu_torch.models.pointnet2 import FlaxBatchNorm1d

    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(5, 16), FlaxBatchNorm1d(16),
                              torch.nn.LeakyReLU(0.2), torch.nn.Linear(16, 1))
    net = net.double().train()
    if state is not None:
        net.load_state_dict(state)
    return net


def _penalty_grads(net, x) -> dict:
    """mean over the rows of (‖∇ₓ net(x)‖ − 1)², backward through the
    input gradient (``create_graph``) -> the parameters' gradients, summed
    over the ranks in a group."""
    from maskplanner_tpu_torch import parallel

    x = x.clone().requires_grad_(True)
    with parallel.sharded_batch():
        (g,) = torch.autograd.grad(net(x).sum(), x, create_graph=True)
        gp = ((g.norm(dim=-1) - 1.0) ** 2).mean()
        parallel.loss_share(gp).backward()
        parallel.all_reduce_grads(net.parameters())
    # the last bias does not reach the penalty: it has no gradient
    return {n: p.grad.clone() for n, p in net.named_parameters()
            if p.grad is not None}


def _raw_backward(ctx, grad):
    """``_AllReduce``'s old backward: a raw all-reduce, invisible to a
    ``create_graph`` backward."""
    from maskplanner_tpu_torch.parallel import mesh

    return mesh._reduced(grad, ctx.mean), None


def _penalty_worker(rank, world, x, state):
    from maskplanner_tpu_torch.parallel import mesh, shard_rows

    rows = shard_rows(x, rank, world)
    out = {"fixed": _penalty_grads(_penalty_net(state), rows)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mesh._AllReduce, "backward", staticmethod(_raw_backward))
        out["raw"] = _penalty_grads(_penalty_net(state), rows)
    return out


def _rel(got: dict, want: dict) -> float:
    num = sum(float((got[k] - w).norm()) ** 2 for k, w in want.items())
    den = sum(float(w.norm()) ** 2 for w in want.values())
    return (num / den) ** 0.5


def test_double_backward_sums_over_ranks(tmp_path):
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(12, 5))).double() * 1.5 + 0.3
    net = _penalty_net()
    state = {k: v.clone() for k, v in net.state_dict().items()}
    handle = start(_penalty_worker, WORLD, tmp_path, x, state)
    single = _penalty_grads(net, x)
    ranks = join(handle)
    for r in ranks:
        assert _rel(r["fixed"], single) <= 1e-12, _rel(r["fixed"], single)
        # the control: the other rank's second-order terms are missing
        assert _rel(r["raw"], single) > 1e-3, _rel(r["raw"], single)


# ---- the GAN step -----------------------------------------------------------

def _global_batch() -> dict:
    from maskplanner_tpu_torch.data.dataset import PaintDataset, collate
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=STEP)
    ds = PaintDataset(cfg, split="train", size=GLOBAL_BATCH)
    return collate([ds[i] for i in range(GLOBAL_BATCH)])


def _gan_run(batch: dict, dtype, control: str | None = None,
             steps: int = STEPS) -> list:
    """``steps`` GAN steps from the seeded generator and critic on
    ``batch`` (this process's rows) in ``dtype``, the draws from one
    seeded generator, ``control`` undoing one piece of the design ->
    per step the loss, the terms, the generator's Adam first moments, the
    critic's moments, parameters and statistics."""
    from maskplanner_tpu_torch import parallel
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.losses.gan import AdversarialLoss
    from maskplanner_tpu_torch.models import get_model, pointnet2
    from maskplanner_tpu_torch.parallel import mesh
    from maskplanner_tpu_torch.train import batch_to_device, gan_train_step
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=STEP)
    model = get_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0)).to(dtype)
    optimizer = torch.optim.Adam(model.parameters(), lr=0.0)
    handler = LossHandler(cfg["loss"], cfg)
    adv = AdversarialLoss(cfg, kind="wdiscriminator")
    critic = adv.init_state(torch.from_numpy(batch["traj"]), "cpu",
                            torch.Generator().manual_seed(17))
    critic.module.to(dtype)
    b = {k: v.to(dtype) if v.is_floating_point() else v
         for k, v in batch_to_device(batch, "cpu").items()}
    draws = torch.Generator().manual_seed(DRAW_SEED)
    named = dict(critic.module.named_parameters())
    # the largest |gradient| of CRITIC_ZERO over the largest of all, then
    # those gradients zeroed (the module's docstring)
    zero_share = []

    def zero_rounding(optimizer, args, kwargs):
        grads = {n: p.grad for n, p in named.items() if p.grad is not None}
        largest = max(float(g.abs().max()) for g in grads.values())
        zero_share.append(max(float(grads[n].abs().max())
                              for n in CRITIC_ZERO if n in grads) / largest)
        for n in CRITIC_ZERO:
            named[n].grad = None

    critic.optimizer.register_step_pre_hook(zero_rounding)
    mp = pytest.MonkeyPatch()
    if control == "critic_local_statistics":
        update = AdversarialLoss.discriminator_update

        def local(self, *a, **k):
            with pytest.MonkeyPatch.context() as inner:
                inner.setattr(pointnet2, "mean_over_ranks",
                              lambda *t: t)
                return update(self, *a, **k)

        mp.setattr(AdversarialLoss, "discriminator_update", local)
    elif control == "per_rank_penalty":
        penalty = AdversarialLoss.gradient_penalty
        mp.setattr(AdversarialLoss, "gradient_penalty",
                   lambda self, *a, **k: parallel.rank_and_world()[1]
                   * penalty(self, *a, **k))
    elif control == "raw_backward":
        mp.setattr(mesh._AllReduce, "backward", staticmethod(_raw_backward))
    out = []
    try:
        for step in range(steps):
            loss, terms = gan_train_step(model, optimizer, handler, b,
                                         handler.init_weights(), draws,
                                         adv=adv, critic=critic, step=step)
            opt = critic.optimizer
            out.append(dict(
                zero_share=zero_share[-1],
                loss=float(loss), terms={k: float(v)
                                         for k, v in terms.items()},
                generator={n: optimizer.state[p]["exp_avg"].clone()
                           for n, p in model.named_parameters()
                           if p in optimizer.state},
                critic_mu={n: opt.state[p]["exp_avg"].clone()
                           for n, p in named.items() if p in opt.state},
                critic_nu={n: opt.state[p]["exp_avg_sq"].clone()
                           for n, p in named.items() if p in opt.state},
                critic={n: t.detach().clone() for n, t in
                        critic.module.state_dict().items()
                        if t.is_floating_point()}))
    finally:
        mp.undo()
    return out


def _rank_runs(rank, world, batch):
    from maskplanner_tpu_torch.parallel import shard_rows

    mine = {k: shard_rows(torch.from_numpy(v), rank, world).numpy()
            for k, v in batch.items()}
    out = {dtype: _gan_run(mine, dtype)
           for dtype in (torch.float32, torch.float64)}
    for control in CONTROLS:
        out[control] = _gan_run(mine, torch.float64, control, steps=1)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batch = _global_batch()
    handle = start(_rank_runs, WORLD, tmp_path_factory.mktemp("gan_dp"),
                   batch)
    single = {dtype: _gan_run(batch, dtype)
              for dtype in (torch.float32, torch.float64)}
    return join(handle), single


def _mismatches(got: list, want: list, own: list | None = None) -> list:
    """Where ``got`` (a run's steps) leaves the rule against ``want`` (the
    single float64 run's): with ``own`` (the single float32 run) the
    float32 rule on the first step, else the float64 rule on every step ->
    the names."""
    bad = []
    steps = 1 if own is not None else STEPS
    for step, (g, w) in enumerate(zip(got[:steps], want)):
        o = None if own is None else own[step]
        scalars = {"loss": (g["loss"], w["loss"],
                            None if o is None else o["loss"])}
        scalars.update({f"term {k}": (g["terms"][k], v, None if o is None
                                      else o["terms"][k])
                        for k, v in w["terms"].items()})
        for name, (a, b, c) in scalars.items():
            tol = (F64_REL * abs(b) if c is None else
                   OWN_FACTOR * abs(c - b) + F32_FLOOR * abs(b))
            if not abs(a - b) <= tol:
                bad.append(f"step {step} {name} {a} {b}")
        for part in ("generator", "critic_mu", "critic_nu", "critic"):
            # gradients and moments by their tree's norm (a gradient that
            # is 0 in exact arithmetic is all rounding), statistics and
            # parameters by their own
            tree = sum(float(b.double().norm()) ** 2
                       for b in w[part].values()) ** 0.5
            if g[part].keys() != w[part].keys():
                bad.append(f"step {step} {part}: other tensors")
                continue
            if o is not None and part != "critic":
                # float32: the whole tree against its own error (a
                # tensor's own error is one draw of the rounding)
                err, own_err = (sum(float((x[part][n].double()
                                           - b.double()).norm()) ** 2
                                    for n, b in w[part].items()) ** 0.5
                                for x in (g, o))
                if not err <= OWN_FACTOR * own_err + F32_FLOOR * tree:
                    bad.append(f"step {step} {part} {err:.3e} > "
                               f"{OWN_FACTOR} x {own_err:.3e}")
                continue
            for n, b in w[part].items():
                a, b = g[part][n].double(), b.double()
                norm = float(b.norm()) if part == "critic" else tree
                if part == "critic" and o is not None and "running" not in n:
                    tol = 2 * CRITIC_LR + 1e-6 * float(b.abs().max())
                    if float((a - b).abs().max()) > tol:
                        bad.append(f"step {step} {part} {n}")
                    continue
                tol = (F64_REL * norm if o is None else OWN_FACTOR * float(
                    (o[part][n].double() - b).norm()) + F32_FLOOR * norm)
                if not float((a - b).norm()) <= tol:
                    bad.append(f"step {step} {part} {n} "
                               f"{float((a - b).norm()):.3e} > {tol:.3e}")
    return bad


def test_gan_step_over_two_ranks_is_the_single_process_in_float64(runs):
    ranks, single = runs
    # the zeroed gradients are rounding (the module's docstring)
    assert all(s["zero_share"] < 1e-9 for s in single[torch.float64])
    for r in ranks:
        assert not _mismatches(r[torch.float64], single[torch.float64])
        assert all(s["terms"]["d_internal"] != 0.0
                   for s in r[torch.float64])


def test_gan_step_over_two_ranks_is_the_single_process_in_float32(runs):
    ranks, single = runs
    for r in ranks:
        assert not _mismatches(r[torch.float32], single[torch.float64],
                               single[torch.float32])
    # the critic is replicated: both ranks' states bitwise equal
    for a, b in zip(ranks[0][torch.float32], ranks[1][torch.float32]):
        for n, t in a["critic"].items():
            assert torch.equal(t, b["critic"][n]), n


@pytest.mark.parametrize("control", CONTROLS)
def test_each_control_fails(control, runs):
    ranks, single = runs
    for r in ranks:
        assert _mismatches(r[control], single[torch.float64])
