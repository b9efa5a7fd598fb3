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
seeded weights. Prints the card's name and power limit, then one JSON
line: per batch the median and the quartiles in ms.
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


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                   help="the forward's compute dtype")
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
