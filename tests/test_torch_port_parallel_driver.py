"""The port's training entry point over 2 gloo ranks on the CPU
(``train_maskplanner.main`` in a process group, as torchrun runs it).

Both ranks run, in one spawn: a GAN recipe, which must raise naming
``ROADMAP.md``; a global ``batch_size`` that 2 ranks do not divide, which
must raise; a 3-epoch run; the same run stopped by SIGTERM, sent to
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
"""
import json
import os
import signal
from unittest import mock

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
       "pc_points=64", "n_pred_traj_points=80", "batch_size=2",
       "dataset_size=2", "test_dataset_size=2", "epochs=1", "device=cpu"]


def _driver_worker(rank, world, root):
    import torch.distributed as dist

    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.models import pointnet2

    own = os.path.join(root, f"cwd{rank}")
    os.makedirs(own)
    os.chdir(own)
    out = {}
    try:
        train_maskplanner.main([*GAN, f"output_dir={root}/gan"])
    except NotImplementedError as exc:
        out["gan"] = str(exc)
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
    return join(handle), single, root


def test_gan_recipe_with_two_ranks_raises(runs):
    ranks, _, root = runs
    for r in ranks:
        assert "ROADMAP.md" in r["gan"] and "2 ranks" in r["gan"]
    assert not os.path.exists(os.path.join(root, "gan"))


def test_batch_size_that_does_not_divide_raises(runs):
    """``batch_size`` is the global batch: 3 over 2 ranks raises, before
    anything is written."""
    ranks, _, root = runs
    for r in ranks:
        assert "batch_size=3" in r["odd"] and "2 ranks" in r["odd"]
    assert not os.path.exists(os.path.join(root, "odd"))


def test_only_rank_0_writes(runs):
    ranks, single, root = runs
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
    ranks, single, _ = runs
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
