"""Resume and preemption of the PyTorch port's training entry point, on the
CPU, and its ``restore_frozen_config`` against the JAX driver's.

A run stopped by SIGTERM (sent to this process from inside a training step,
so the driver's own handler takes it) and resumed with ``resume=<run_dir>``
must end bitwise equal to the run that was never stopped: its parameters,
its Adam state and every logged loss. The schedules are set so that the
resumed part crosses an LR milestone, a PSACD step and the stroke-mask
loss's delayed activation, and replays one of each from the epochs done.
"""
import json
import os
import shutil
import signal

import pytest
import torch

from maskplanner_tpu.utils.args import load_args as jax_load_args
from maskplanner_tpu_torch.utils.args import load_args

torch.set_num_threads(1)

RUN = ["config=[maskplanner,windows_v2,longx_v2]", "device=cpu",
       "pc_points=64", "model.hidden_size=[32,32]", "n_pred_traj_points=120",
       "max_n_strokes=6", "batch_size=2", "dataset_size=4",
       "test_dataset_size=2", "epochs=4", "eval_freq=1", "no_save=false",
       "seed=3", "lr_sched.step_sizes=[1,3]",
       "psacd_scheduler.milestones=[1,3]", "start_stroke_masks_loss_at=2"]
STEPS_PER_EPOCH = 2


def _logs(run_dir):
    with open(os.path.join(run_dir, "logs.jsonl")) as fh:
        return [{k: v for k, v in json.loads(line).items()
                 if k.endswith("loss")} for line in fh]


def _checkpoint(run_dir):
    return torch.load(os.path.join(run_dir, "last_checkpoint.torch.pt"),
                      weights_only=True)


def _assert_bitwise(a, b, what=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_bitwise(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_bitwise(x, y, f"{what}/{i}")
    else:
        assert a == b, what


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The uninterrupted 4-epoch run, and the same run stopped by SIGTERM
    during epoch 2 and resumed."""
    from maskplanner_tpu_torch import train_maskplanner

    whole, _ = train_maskplanner.main(
        [*RUN, f"output_dir={tmp_path_factory.mktemp('whole')}"])

    mp = pytest.MonkeyPatch()
    step, calls = train_maskplanner.train_step, []

    def step_then_sigterm(*args, **kwargs):
        out = step(*args, **kwargs)
        calls.append(1)
        if len(calls) == STEPS_PER_EPOCH + 1:     # epoch 2's first step
            # the driver's handler must be in place, or the default one
            # would end this process
            assert signal.getsignal(signal.SIGTERM) not in (
                signal.SIG_DFL, None)
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    mp.setattr(train_maskplanner, "train_step", step_then_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    try:
        stopped, _ = train_maskplanner.main(
            [*RUN, f"output_dir={tmp_path_factory.mktemp('stopped')}"])
    finally:
        mp.undo()
    assert signal.getsignal(signal.SIGTERM) is before
    assert len(calls) == 2 * STEPS_PER_EPOCH
    at_stop = {"logs": _logs(stopped), "checkpoint": _checkpoint(stopped)}
    resumed, _ = train_maskplanner.main([f"resume={stopped}"])
    assert resumed == stopped
    return whole, resumed, at_stop


def test_sigterm_stops_at_the_end_of_the_epoch(runs):
    _, _, at_stop = runs
    assert len(at_stop["logs"]) == 2
    assert at_stop["checkpoint"]["epoch"] == 2
    assert at_stop["checkpoint"]["step"] == 2 * STEPS_PER_EPOCH


def test_resumed_run_is_bitwise_the_uninterrupted_run(runs):
    whole, resumed, _ = runs
    assert _logs(resumed) == _logs(whole)
    a, b = _checkpoint(resumed), _checkpoint(whole)
    assert a["epoch"] == b["epoch"] == 4
    assert a["step"] == b["step"] == 4 * STEPS_PER_EPOCH
    for key in ("model", "optimizer", "lr_sched", "generator"):
        _assert_bitwise(a[key], b[key], key)
    # the resumed part crossed the LR milestone at 3
    assert a["optimizer"]["param_groups"][0]["lr"] == pytest.approx(
        0.25 * float(load_args(argv=RUN)["lr"]))


def test_resume_with_missing_state_or_dir_raises(runs, tmp_path):
    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.convert import (load_checkpoint,
                                               load_training_state)
    from maskplanner_tpu_torch.models import get_model

    with pytest.raises(ValueError, match="no such run directory"):
        train_maskplanner.main([f"resume={tmp_path / 'missing'}"])
    # a checkpoint of the model alone (best_model, or one written before
    # checkpoints held a training state) still serves, but cannot resume
    whole, _, _ = runs
    cfg = load_args(argv=RUN)
    model = get_model(cfg, device="cpu")
    blob = _checkpoint(whole)
    torch.save({"model": blob["model"], "epoch": 4},
               os.path.join(tmp_path, "old.torch.pt"))
    assert load_checkpoint(str(tmp_path), "old", model) == 4
    assert load_checkpoint(whole, "best_model", model) in (1, 2, 3, 4)
    opt = torch.optim.Adam(model.parameters())
    with pytest.raises(ValueError, match="cannot resume"):
        load_training_state(str(tmp_path), "old", model, opt, None,
                            torch.Generator())


def test_bare_resume_true_starts_a_fresh_run(tmp_path):
    from maskplanner_tpu_torch import train_maskplanner

    run_dir, _ = train_maskplanner.main(
        [*RUN, "epochs=1", "no_save=true", "resume=true",
         f"output_dir={tmp_path}"])
    assert os.path.dirname(run_dir) == str(tmp_path)
    assert len(_logs(run_dir)) == 1


def test_restore_frozen_config_matches_jax(tmp_path):
    """The frozen config wins but for the keys typed on this command line,
    which are carried over and saved: as the JAX driver does it."""
    import train_maskplanner as jax_driver

    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.utils.config import load_config, save_config

    frozen = tmp_path / "frozen"
    frozen.mkdir()
    save_config(load_args(argv=[*RUN, "lr=3e-4"]), str(frozen))
    dirs = {k: shutil.copytree(frozen, tmp_path / k) for k in ("jax", "port")}
    typed = [f"resume={frozen}", "epochs=9", "model.hidden_size=[16,16]",
             "psacd_scheduler.factor=0.2"]
    ref = jax_driver.restore_frozen_config(jax_load_args(argv=typed),
                                           str(dirs["jax"]))
    got = train_maskplanner.restore_frozen_config(load_args(argv=typed),
                                                  str(dirs["port"]))
    assert got.to_dict() == ref.to_dict()
    assert got["lr"] == 3e-4 and got["epochs"] == 9 and got["resume"]
    assert load_config(str(dirs["port"])).to_dict() == \
        load_config(str(dirs["jax"])).to_dict()
