"""The port's training entry point over 2 gloo ranks on the CPU
(``train_maskplanner.main`` in a process group, as torchrun runs it).

Both ranks run, in one spawn: a GAN recipe for 2 epochs, the same run
stopped by SIGTERM to rank 1 after epoch 1 and resumed; a global
``batch_size`` that 2 ranks do not divide, which must raise; a 3-epoch run; the same run stopped by SIGTERM, sent to
rank 1 alone during epoch 2 on the host loader's path, which must stop
both ranks at the end of epoch 2 with a checkpoint; and that run resumed
on the device-resident path, which must end bitwise equal to the run that
was never stopped; and a run without ``seed=``, whose ranks must draw
from rank 0's seed. Only rank 0 writes: rank 1's working directory stays
empty and each output directory holds one run, with the files of the
single-process run. The 2-rank run matches the single-process run at the
same global batch: every logged train and eval loss within 1e-5 relative
and the BatchNorm running statistics within 1e-5, float32 reduction
order. The runs train at LR 0, so that every step starts from the same
parameters: Adam's first steps move each parameter by about the LR
whatever its gradient's size, so at a real LR the two runs' float32
rounding turns into other nearest-neighbour and Hungarian matchings after
a step (the JAX package's ``test_data_parallel_matches_single_device``
holds its second step within 5% for that reason). Adam's update over the
ranks is held by ``test_torch_port_parallel.py`` (bitwise equal
parameters across ranks after 3 steps, a group of one bitwise the
ungrouped steps).

The GAN recipe (``loss=[chamfer,wdiscriminator]``, global batch 8, one
step an epoch, the generator at LR 0) over 2 ranks matches the
single-process run: the generator's logged losses and its BatchNorm
statistics by the rule above (the adversarial term, a mean of logits near
0, also within 1e-6 absolute, as ``test_torch_port_gan.py`` holds it),
the critic's update loss within 1e-2 relative on the first epoch (the
critic's step is ill-conditioned in float32: the single process's own
float32 error on that loss is 1.3e-3), and on the second epoch that loss
and the adversarial term finite: after one update the float32 runs part
further, as Adam moves ``linear2.bias``, whose update gradient is 0 in
exact arithmetic, by its LR on the sign of rounding, and the eval-mode
critic that the generator's term runs reads that bias
(``test_torch_port_gan_parallel.py`` holds the step in float64), and the
critic's saved parameters within Adam's 2 x lr a step of the single run's
(its LR is its own, 1e-4). Rank 0 alone writes the critic's state; the
resumed run, which loads it on both ranks, ends bitwise equal to the run
that was never stopped, critic and its Adam included.
"""
import json
import os
import signal
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_port_parallel import _bitwise, join, start

torch.set_num_threads(1)

RUN = ["config=[maskplanner,windows_v2,longx_v2]", "device=cpu",
       "pc_points=64", "model.hidden_size=[32,32]", "n_pred_traj_points=120",
       "max_n_strokes=6", "batch_size=4", "dataset_size=8",
       "test_dataset_size=2", "epochs=3", "eval_freq=1", "no_save=false",
       "seed=3", "lr=0.0"]
STEPS_PER_EPOCH = 2
# the shipped default (seed 0) draws a fresh seed
UNSEEDED = [a for a in RUN if not a.startswith("seed=")]
GAN = ["config=[pointWise,cuboids_v2,longx_v2,debug]",
       "loss=[chamfer,wdiscriminator]", "weight_wdiscriminator=0.01",
       "pc_points=64", "n_pred_traj_points=80", "model.hidden_size=[32,32]",
       "knn_gcn=4", "batch_size=8", "dataset_size=8", "test_dataset_size=2",
       "epochs=2", "eval_freq=1", "device=cpu", "no_save=false", "seed=3",
       "lr=0.0"]
CRITIC_LR = 1e-4
# the logged losses that the critic's state after an update decides
CRITIC_TERMS = ("d_internal_train_loss", "wdiscriminator_train_loss")


def _driver_worker(rank, world, root):
    import torch.distributed as dist

    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.models import pointnet2

    own = os.path.join(root, f"cwd{rank}")
    os.makedirs(own)
    os.chdir(own)
    out = {}
    out["gan"], _ = train_maskplanner.main([*GAN, f"output_dir={root}/gan"])
    gan_step, gan_calls = train_maskplanner.gan_train_step, []

    def gan_step_then_sigterm(*args, **kwargs):
        result = gan_step(*args, **kwargs)
        gan_calls.append(1)
        if rank == 1 and len(gan_calls) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return result

    with mock.patch.object(train_maskplanner, "gan_train_step",
                           gan_step_then_sigterm):
        stopped, _ = train_maskplanner.main(
            [*GAN, f"output_dir={root}/gan_stopped"])
    out["gan_stopped_steps"] = len(gan_calls)
    names = [stopped]
    dist.broadcast_object_list(names, src=0)
    out["gan_resumed"], _ = train_maskplanner.main(
        [*GAN, f"output_dir={root}/gan_stopped", f"resume={names[0]}"])
    try:
        train_maskplanner.main([*RUN, "batch_size=3",
                                f"output_dir={root}/odd"])
    except ValueError as exc:
        out["odd"] = str(exc)

    out["whole"], _ = train_maskplanner.main(
        [*RUN, f"output_dir={root}/whole"])

    step, calls = train_maskplanner.train_step, []

    def step_then_sigterm(*args, **kwargs):
        result = step(*args, **kwargs)
        calls.append(1)
        if rank == 1 and len(calls) == STEPS_PER_EPOCH + 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return result

    with mock.patch.object(train_maskplanner, "train_step",
                           step_then_sigterm):
        stopped, _ = train_maskplanner.main(
            [*RUN, f"output_dir={root}/stopped", "device_dataset=false"])
    out["stopped_steps"] = len(calls)
    # rank 1 has no run directory: rank 0's names it
    names = [stopped]
    dist.broadcast_object_list(names, src=0)
    out["stopped"] = names[0]
    out["resumed"], _ = train_maskplanner.main(
        [*RUN, f"output_dir={root}/stopped", f"resume={names[0]}"])

    draw, starts = pointnet2.random_starts, []

    def recorded(xyz, generator):
        state = generator.get_state()
        got = draw(xyz, generator)
        starts.append((state, xyz.shape[1], got))
        return got

    with mock.patch.object(pointnet2, "random_starts", recorded):
        train_maskplanner.main([*UNSEEDED, "epochs=1",
                                f"output_dir={root}/unseeded"])
    out["starts"] = starts
    out["cwd"] = sorted(os.listdir(own))
    return out


def _logs(run_dir):
    with open(os.path.join(run_dir, "logs.jsonl")) as fh:
        return [json.loads(line) for line in fh]


def _checkpoint(run_dir):
    return torch.load(os.path.join(run_dir, "last_checkpoint.torch.pt"),
                      weights_only=True)


def _files(run_dir):
    return sorted(os.listdir(run_dir))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from maskplanner_tpu_torch import train_maskplanner

    root = tmp_path_factory.mktemp("dp_driver")
    # the single process runs while the ranks do
    handle = start(_driver_worker, 2, root, str(root))
    single, _ = train_maskplanner.main(
        [*RUN, f"output_dir={tmp_path_factory.mktemp('single')}"])
    gan, _ = train_maskplanner.main(
        [*GAN, f"output_dir={tmp_path_factory.mktemp('gan_single')}"])
    return join(handle), (single, gan), root


def _aux(run_dir):
    return torch.load(os.path.join(run_dir, "last_checkpoint_aux.torch.pt"),
                      weights_only=True)


def test_gan_recipe_with_two_ranks_raises(runs):
    """(The refusal it held is gone.) The GAN recipe over 2 ranks matches
    the single-process run (the module's docstring); rank 0 alone writes,
    the critic's state beside each checkpoint."""
    ranks, (_, single), root = runs
    assert ranks[1]["gan"] is None
    assert len(os.listdir(os.path.join(root, "gan"))) == 1
    dp = ranks[0]["gan"]
    assert _files(dp) == _files(single)
    assert {"last_checkpoint_aux.torch.pt",
            "best_model_aux.torch.pt"} <= set(_files(dp))
    dp_logs, one_logs = _logs(dp), _logs(single)
    assert len(dp_logs) == len(one_logs) == 2
    for epoch, (got, want) in enumerate(zip(dp_logs, one_logs)):
        keys = [k for k in want if k.endswith("loss")]
        assert sorted(keys) == sorted(k for k in got if k.endswith("loss"))
        assert "d_internal_train_loss" in keys
        for k in keys:
            if k in CRITIC_TERMS and epoch:
                # after a critic update (the module's docstring)
                assert np.isfinite(got[k]), k
            elif k == "d_internal_train_loss":
                assert got[k] == pytest.approx(want[k], rel=1e-2), k
            elif k.startswith("wdiscriminator"):
                # a mean of logits near 0: test_torch_port_gan.py's rule
                assert got[k] == pytest.approx(want[k], rel=1e-5,
                                               abs=1e-6), k
            else:
                assert got[k] == pytest.approx(want[k], rel=1e-5, abs=0), k
    a, b = _checkpoint(dp), _checkpoint(single)
    for name, want in b["model"].items():
        if "running_" in name:
            torch.testing.assert_close(a["model"][name], want, rtol=0,
                                       atol=1e-5)
        else:
            assert torch.equal(a["model"][name], want), name
    critic, critic_one = _aux(dp)["module"], _aux(single)["module"]
    assert critic.keys() == critic_one.keys()
    for name, want in critic_one.items():
        if want.is_floating_point() and "running_" not in name:
            # two updates (Adam's bias-corrected second step moves a
            # parameter by up to 1.0014 lr)
            assert float((critic[name] - want).abs().max()) <= \
                2 * 2 * CRITIC_LR * (1 + 1e-2), name


def test_resumed_gan_run_is_bitwise_the_uninterrupted_one(runs):
    """SIGTERM to rank 1 during epoch 1 stops both ranks after it, with
    the critic's state written by rank 0; the run resumed on both ranks
    ends bitwise equal to the run never stopped: the generator, its Adam,
    the critic, its Adam, and every logged loss."""
    ranks, _, root = runs
    assert [r["gan_stopped_steps"] for r in ranks] == [1, 1]
    assert len(os.listdir(os.path.join(root, "gan_stopped"))) == 1
    whole, resumed = ranks[0]["gan"], ranks[0]["gan_resumed"]
    _bitwise(_checkpoint(whole), _checkpoint(resumed))
    _bitwise(_aux(whole), _aux(resumed))

    def losses(run_dir):
        return [{k: v for k, v in log.items() if k.endswith("loss")}
                for log in _logs(run_dir)]

    assert losses(resumed) == losses(whole)


def test_batch_size_that_does_not_divide_raises(runs):
    """``batch_size`` is the global batch: 3 over 2 ranks raises, before
    anything is written."""
    ranks, _, root = runs
    for r in ranks:
        assert "batch_size=3" in r["odd"] and "2 ranks" in r["odd"]
    assert not os.path.exists(os.path.join(root, "odd"))


def test_only_rank_0_writes(runs):
    ranks, (single, _), root = runs
    assert ranks[1]["whole"] is None and ranks[1]["cwd"] == []
    assert ranks[0]["cwd"] == []
    for kind in ("whole", "stopped", "unseeded"):
        assert len(os.listdir(os.path.join(root, kind))) == 1
    assert _files(ranks[0]["whole"]) == _files(single)


def test_sigterm_to_one_rank_stops_both_at_the_same_epoch(runs):
    ranks, _, _ = runs
    assert [r["stopped_steps"] for r in ranks] == [2 * STEPS_PER_EPOCH] * 2
    stopped = ranks[0]["stopped"]
    assert len(_logs(stopped)) == 3   # 2 epochs, stopped; the 3rd resumed
    assert _checkpoint(ranks[0]["resumed"])["epoch"] == 3


def test_resumed_run_is_bitwise_the_uninterrupted_one(runs):
    """Stopped on the host loader's path, resumed on the device-resident
    one: parameters, BatchNorm statistics, Adam and every logged loss
    bitwise those of the run that was never stopped."""
    ranks, _, _ = runs
    whole, resumed = (_checkpoint(ranks[0][k]) for k in ("whole", "resumed"))
    _bitwise(whole, resumed)

    def losses(run_dir):
        return [{k: v for k, v in log.items() if k.endswith("loss")}
                for log in _logs(run_dir)]

    assert losses(ranks[0]["resumed"]) == losses(ranks[0]["whole"])


def test_unseeded_ranks_take_rows_of_one_draw(runs):
    """Without ``seed=`` (a fresh seed is drawn) every rank gets rank 0's:
    each FPS start draw of the epoch is made from the same generator state
    on both ranks, and the ranks' starts are the two halves of one draw
    over the global batch from that state."""
    ranks, _, _ = runs
    a, b = (r["starts"] for r in ranks)
    assert len(a) == len(b) == 2 * STEPS_PER_EPOCH   # sa1, sa2 a step
    for (state, n, mine), (other, n_b, theirs) in zip(a, b):
        assert torch.equal(state, other) and n == n_b
        whole = torch.randint(0, n, (len(mine) + len(theirs),),
                              generator=torch.Generator().set_state(state))
        assert torch.equal(torch.cat([mine, theirs]), whole)


def test_two_rank_run_matches_the_single_process_run(runs):
    ranks, (single, _), _ = runs
    dp_logs, one_logs = _logs(ranks[0]["whole"]), _logs(single)
    assert len(dp_logs) == len(one_logs) == 3
    for got, want in zip(dp_logs, one_logs):
        keys = [k for k in want if k.endswith("loss")]
        assert sorted(keys) == sorted(k for k in got if k.endswith("loss"))
        assert any(k.startswith("eval") for k in keys)
        for k in keys:
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=0), k
    dp, one = _checkpoint(ranks[0]["whole"]), _checkpoint(single)
    assert dp["epoch"] == one["epoch"] == 3
    for name, want in one["model"].items():
        got = dp["model"][name]
        if "running_" in name:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        else:
            assert torch.equal(got, want), name
