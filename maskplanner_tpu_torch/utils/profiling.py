"""Profiler traces for the training entry point
(``maskplanner_tpu/utils/profiling.py``: ``profile_trace``).

``profile=true`` on ``train_maskplanner`` wraps the second epoch in
:func:`profile_trace`, which records it with ``torch.profiler`` (the host,
and the card's kernels when the run is on one) and writes a chrome trace
(``chrome://tracing``, Perfetto) under ``<run_dir>/profile/``. Unlike the
JAX package's, a profiler that cannot start or write raises: the run fails
loudly rather than leave no trace.
"""
from __future__ import annotations

import contextlib
import os

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
