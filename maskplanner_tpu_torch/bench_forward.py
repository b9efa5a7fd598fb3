"""Forward latency of the port on the card, host clock.

    python -m maskplanner_tpu_torch.bench_forward [--dtype bf16]
    cd OTHER_CHECKOUT && python PATH/TO/bench_forward.py [--dtype bf16]

The seeded flagship model (``config=[maskplanner,windows_v2,longx_v2]``)
on 64 clouds of the synthetic windows-v2 test split: the wall time of a
forward that ends in a synchronize, at batch 64 and at batch 1, after a
warm-up, as ``chip_smoke.py`` phase 4 takes it but with more repeats and
the spread. Run as a file, it times the package of the working directory,
so that two checkouts can be compared on one card, in turns.
``--dtype bf16`` times the bf16 model (``model.bf16=true``) on the same
seeded weights. ``--levels`` also times the fused SA level's kernel alone
at the model's sa1 and sa2 (batch 64; the f32 forward's
``fused_sa_cuda`` or the bf16 mode's ``fused_sa_bf16_cuda``, called as
both checkouts' wrappers take it), CUDA-event medians of 40 launches with
the wrapper's host time, in turns with the forward's timings. Prints the
card's name and power limit, then one JSON line: per batch the median and
the quartiles in ms (and per level, with ``--levels``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPS = {64: 40, 1: 100}
LEVEL_REPS = 40


def level_ms(model, x, bf16: bool) -> dict:
    """Each fused SA level's kernel alone at the model's shapes on ``x``:
    the median of CUDA-event times of single launches, ms."""
    from maskplanner_tpu_torch.ops.cuda import fused_sa as cuda_sa
    from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                    index_points)

    fn = cuda_sa.fused_sa_bf16_cuda if bf16 else cuda_sa.fused_sa_cuda
    out = {}
    pts, feats = x, None
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        new_xyz = index_points(pts, farthest_point_sample(pts, sa.npoint))
        params = [tuple(t.detach() for t in layer)
                  for layer in sa.layer_params()]
        call = lambda: fn(sa.radius, sa.nsample, True, pts, new_xyz,  # noqa
                          feats, params)
        for _ in range(5):
            pooled = call()[0]
        torch.cuda.synchronize()
        times = []
        for _ in range(LEVEL_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = statistics.median(times)
        pts, feats = new_xyz, pooled
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="the forward's compute dtype")
    p.add_argument("--levels", action="store_true",
                   help="also time the fused SA level kernel at sa1 and sa2")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_forward needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_args(argv=["config=[maskplanner,windows_v2,longx_v2]"]
                    + (["model.bf16=true"] if args.dtype == "bf16" else []))
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    ds = PaintDataset(cfg, split="test", size=64)
    x = torch.from_numpy(np.stack([ds[i]["point_cloud"]
                                   for i in range(64)])).cuda()
    out = {"package": os.path.dirname(sys.modules[
        "maskplanner_tpu_torch"].__file__), "dtype": args.dtype}
    with torch.inference_mode():
        for batch, reps in REPS.items():
            inp = x[:batch]
            for _ in range(5):
                model(inp)
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t = time.perf_counter()
                model(inp)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            q1, med, q3 = statistics.quantiles(times, n=4)
            out[f"batch{batch}_ms"] = {"median": med, "q1": q1, "q3": q3}
        if args.levels:
            out["level_ms"] = level_ms(model, x,
                                       args.dtype == "bf16")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
