"""The port's run log (``utils/logging.py::Run``) and phase timer
(``utils/profiling.py::StepTimer``) against the JAX package's, on the CPU.

A recording stub takes the place of ``wandb`` in ``sys.modules`` (neither
this machine nor the card's has wandb, and nothing is installed): driven
with the same calls, both ``Run`` classes make the same ``init``, ``log``,
``summary`` and ``finish`` calls on it and write the same ``logs.jsonl``
records but for ``_time``, and the same ``summary.json``. ``disabled``,
``offline-local`` and a driver run under ``debug`` call nothing; an
``init`` that raises leaves the local files working. The training driver
makes its ``Run`` with the JAX driver's mode rule. ``StepTimer`` runs on a
fake clock patched into both modules.
"""
import json
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

from maskplanner_tpu.utils import logging as jax_logging
from maskplanner_tpu.utils import profiling as jax_profiling
from maskplanner_tpu_torch.utils import logging as port_logging
from maskplanner_tpu_torch.utils import profiling as port_profiling

torch.set_num_threads(1)

SMALL = ["pc_points=64", "model.hidden_size=[32,32]", "batch_size=2",
         "dataset_size=2", "test_dataset_size=2", "epochs=2", "eval_freq=1",
         "device=cpu"]


class _StubRun:
    """What ``wandb.init`` returns: records its calls into ``calls``."""

    def __init__(self, calls):
        self.calls = calls
        self.summary = {}

    def log(self, data, step=None):
        self.calls.append(("log", dict(data), step))

    def finish(self):
        self.calls.append(("finish", dict(self.summary)))


def _stub_wandb(monkeypatch, fail=False):
    """A ``wandb`` module in ``sys.modules`` -> the list of its calls."""
    calls = []
    stub = types.ModuleType("wandb")

    def init(**kwargs):
        calls.append(("init", kwargs))
        if fail:
            raise RuntimeError("wandb cannot reach its server")
        return _StubRun(calls)

    stub.init = init
    monkeypatch.setitem(sys.modules, "wandb", stub)
    return calls


def _drive(cls, run_dir, mode):
    """The same calls on either class, values of the types the drivers
    log (Python, numpy and 0-d tensor numbers)."""
    run = cls(str(run_dir), config={"lr": 1e-3, "model": {"norm": "batch"}},
              group="grp", name="nm", mode=mode)
    run.log({"train_loss": 1.5, "epoch": 1, "eval_loss": np.float32(2.25)},
            step=1)
    run.log({"train_loss": torch.tensor(0.75), "epoch": 2}, step=2)
    run.log({"note": "no step"})
    run.summary["best_epoch"] = 2
    run.summary["best_eval_loss"] = np.float64(0.5)
    run.finish()


def _records(run_dir):
    with open(run_dir / "logs.jsonl") as fh:
        return [json.loads(line) for line in fh]


def _logged(run_dir):
    return [{k: v for k, v in rec.items() if k != "_time"}
            for rec in _records(run_dir)]


def _summary(run_dir):
    with open(run_dir / "summary.json") as fh:
        return json.load(fh)


def _both(monkeypatch, tmp_path, mode, fail=False):
    """Each class driven against its own stub -> {name: (calls, run_dir)}."""
    out = {}
    for name, cls in (("jax", jax_logging.Run), ("port", port_logging.Run)):
        calls = _stub_wandb(monkeypatch, fail)
        run_dir = tmp_path / name
        _drive(cls, run_dir, mode)
        out[name] = calls, run_dir
    return out


def test_run_mirrors_to_wandb_as_jax(monkeypatch, tmp_path):
    runs = _both(monkeypatch, tmp_path, "online")
    (jax_calls, jax_dir), (calls, run_dir) = runs["jax"], runs["port"]
    assert calls == jax_calls
    assert [c[0] for c in calls] == ["init", "log", "log", "log", "finish"]
    assert calls[0][1] == dict(project="MaskPlanner", group="grp", name="nm",
                               mode="online", config={
                                   "lr": 1e-3, "model": {"norm": "batch"}})
    assert [c[2] for c in calls[1:4]] == [1, 2, None]
    assert calls[-1][1] == {"best_epoch": 2, "best_eval_loss": 0.5}
    assert _logged(run_dir) == _logged(jax_dir)
    assert _logged(run_dir)[0] == {"train_loss": 1.5, "epoch": 1,
                                   "eval_loss": 2.25, "_step": 1}
    assert all(isinstance(r["_time"], float) for r in _records(run_dir))
    assert list(_records(run_dir)[0])[0] == "_time"
    assert _summary(run_dir) == _summary(jax_dir) == {
        "best_epoch": 2, "best_eval_loss": 0.5}


@pytest.mark.parametrize("mode", ["disabled", "offline-local"])
def test_local_modes_call_nothing(monkeypatch, tmp_path, mode):
    runs = _both(monkeypatch, tmp_path, mode)
    (jax_calls, jax_dir), (calls, run_dir) = runs["jax"], runs["port"]
    assert calls == jax_calls == []
    assert _logged(run_dir) == _logged(jax_dir) and len(_logged(run_dir)) == 3
    assert _summary(run_dir) == _summary(jax_dir)


def test_init_that_raises_keeps_the_local_sink(monkeypatch, tmp_path):
    runs = _both(monkeypatch, tmp_path, "online", fail=True)
    (jax_calls, jax_dir), (calls, run_dir) = runs["jax"], runs["port"]
    assert [c[0] for c in calls] == [c[0] for c in jax_calls] == ["init"]
    assert _logged(run_dir) == _logged(jax_dir) and len(_logged(run_dir)) == 3
    assert _summary(run_dir) == _summary(jax_dir)


def test_driver_logs_through_run_with_the_jax_mode_rule(monkeypatch,
                                                        tmp_path):
    """A driver run under ``debug`` calls nothing; one with the shipped
    ``wandb: online`` inits with the JAX driver's arguments (the group is
    ``auto_wandb_group``), logs each epoch at its step, and finishes with
    the summary that ``summary.json`` holds."""
    from maskplanner_tpu_torch import train_maskplanner
    from maskplanner_tpu_torch.utils.args import load_args

    calls = _stub_wandb(monkeypatch)
    debug, _ = train_maskplanner.main(
        ["config=[maskplanner,windows_v2,longx_v2,debug]", *SMALL,
         f"output_dir={tmp_path / 'debug'}"])
    assert calls == []
    assert [r["_step"] for r in _records(pathlib.Path(debug))] == [1, 2]

    argv = ["config=[maskplanner,windows_v2,longx_v2]", *SMALL,
            "skip_rendering=true", f"output_dir={tmp_path / 'online'}"]
    online, _ = train_maskplanner.main(argv)
    config = load_args(argv=argv)
    assert [c[0] for c in calls] == ["init", "log", "log", "finish"]
    init = calls[0][1]
    assert (init["project"], init["group"], init["name"], init["mode"]) == (
        "MaskPlanner", config["auto_wandb_group"], None, "online")
    assert init["config"]["batch_size"] == 2
    records = _records(pathlib.Path(online))
    assert [c[2] for c in calls[1:3]] == [r["_step"] for r in records] == [
        1, 2]
    for (_, data, _), rec in zip(calls[1:3], records):
        assert {k: v for k, v in rec.items() if k not in ("_time", "_step")
                } == data
    summary = _summary(pathlib.Path(online))
    assert calls[-1][1] == summary and "final_test_loss" in summary


def test_wandb_mode_is_the_jax_drivers_rule():
    """``train_maskplanner.py:94-98`` of the JAX driver."""
    from maskplanner_tpu_torch.train_maskplanner import wandb_mode
    from maskplanner_tpu_torch.utils.args import load_args

    flagship = "config=[maskplanner,windows_v2,longx_v2]"
    for extra, want in (([], "online"), (["wandb=offline"], "offline"),
                        (["wandb=disabled"], "disabled"),
                        (["debug=true"], "disabled"),
                        (["debug=true", "wandb=online"], "disabled")):
        assert wandb_mode(load_args(argv=[flagship, *extra])) == want, extra
    debug = load_args(argv=["config=[maskplanner,windows_v2,longx_v2,debug]"])
    assert wandb_mode(debug) == "disabled"


class _FakeClock:
    """``time`` with a ``perf_counter`` that steps by the given amounts."""

    def __init__(self, steps):
        self.now, self.steps = 0.0, iter(steps)

    def perf_counter(self):
        self.now += next(self.steps)
        return self.now


def test_step_timer_matches_jax(monkeypatch):
    steps = [0.0, 0.25, 1.0, 0.5, 0.0, 0.125, 2.0, 0.375]
    summaries = []
    for module in (jax_profiling, port_profiling):
        monkeypatch.setattr(module, "time", _FakeClock(steps))
        timer = module.StepTimer()
        with timer.phase("step"):
            pass
        with timer.phase("eval"):
            pass
        with timer.phase("step"):
            pass
        with pytest.raises(KeyError):
            with timer.phase("eval"):
                raise KeyError("the phase still counts")
        summaries.append((timer.summary(), timer.summary(prefix="ms/")))
        timer.reset()
        assert timer.summary() == {}
    assert summaries[0] == summaries[1]
    assert summaries[1][0] == {"time_ms/step": 187.5, "time_ms/eval": 437.5}
    assert summaries[1][1] == {"ms/step": 187.5, "ms/eval": 437.5}
