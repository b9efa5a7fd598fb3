"""The run log (``maskplanner_tpu/utils/logging.py``: ``Run``, ``_tofloat``).

``Run`` writes ``logs.jsonl`` (a record a ``log`` call: ``_time``, the
values, ``_step``) and, at ``finish``, ``summary.json`` in the run
directory, and mirrors ``log``, ``summary`` and ``finish`` to wandb when
``wandb`` imports and ``mode`` is neither ``disabled`` nor
``offline-local``. A wandb whose ``init`` raises leaves the local files
alone, as in the JAX package. Each record is appended and the file closed
again, so that no handle outlives a call.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


class Run:
    def __init__(self, run_dir: str, config: Mapping | None = None,
                 project: str = "MaskPlanner", group: str | None = None,
                 name: str | None = None, mode: str = "disabled"):
        self.run_dir = run_dir
        self.summary: dict[str, Any] = {}
        os.makedirs(run_dir, exist_ok=True)
        self._log_path = os.path.join(run_dir, "logs.jsonl")
        # the file exists from the start, as the JAX class's open handle
        # makes it
        open(self._log_path, "a", encoding="utf-8").close()
        self._wandb = None
        if mode not in ("disabled", "offline-local"):
            try:
                import wandb

                self._wandb = wandb.init(project=project, group=group,
                                         name=name, mode=mode,
                                         config=dict(config or {}))
            except Exception:
                # no wandb, or no way to reach it: the local files only
                self._wandb = None

    def log(self, data: Mapping[str, Any], step: int | None = None):
        rec = {"_time": time.time(),
               **{k: _tofloat(v) for k, v in data.items()}}
        if step is not None:
            rec["_step"] = step
        with open(self._log_path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(dict(data), step=step)

    def finish(self):
        with open(os.path.join(self.run_dir, "summary.json"), "w") as fh:
            json.dump({k: _tofloat(v) for k, v in self.summary.items()}, fh,
                      indent=2)
        if self._wandb is not None:
            for k, v in self.summary.items():
                self._wandb.summary[k] = v
            self._wandb.finish()


def _tofloat(v):
    """A 0-d tensor or numpy scalar -> its Python number; anything else
    as it is."""
    if isinstance(v, (str, bytes)) or not hasattr(v, "item"):
        return v
    try:
        return v.item()
    except (TypeError, ValueError, RuntimeError):
        # not a single element
        return v
