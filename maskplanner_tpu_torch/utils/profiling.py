"""Profiler traces for the training entry point and a phase timer
(``maskplanner_tpu/utils/profiling.py``: ``profile_trace``, ``StepTimer``).

``profile=true`` on ``train_maskplanner`` wraps the second epoch in
:func:`profile_trace`, which records it with ``torch.profiler`` (the host,
and the card's kernels when the run is on one) and writes a chrome trace
(``chrome://tracing``, Perfetto) under ``<run_dir>/profile/``. Unlike the
JAX package's, a profiler that cannot start or write raises: the run fails
loudly rather than leave no trace.

:class:`StepTimer` sums the host's wall time of named phases.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | None, enabled: bool = False,
                  device: str | torch.device = "cpu"):
    """Record what runs inside the block into
    ``log_dir/profile/trace.json`` when ``enabled``. ``device``: the run's
    device; a CUDA one adds the card's activity to the host's."""
    if not enabled or not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    trace_dir = os.path.join(log_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


class StepTimer:
    """Named phases' host wall time: ``summary()`` -> the mean ms of each.

    The clock is the host's (``time.perf_counter``) and nothing here
    synchronises the card: a phase that launches kernels measures their
    enqueue. A caller who wants a phase's device time ends the phase with
    ``torch.cuda.synchronize()`` inside it."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self, prefix: str = "time_ms/") -> dict:
        return {f"{prefix}{k}": self.totals[k] / max(self.counts[k], 1) * 1000
                for k in self.totals}

    def reset(self):
        self.totals.clear()
        self.counts.clear()
