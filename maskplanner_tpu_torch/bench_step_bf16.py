"""K1 of the fused SA backward's bf16 mode at the flagship's sa1 and sa2,
and the bf16 graphed training step, on the card.

    python -m maskplanner_tpu_torch.bench_step_bf16
    cd OTHER_CHECKOUT && python PATH/TO/bench_step_bf16.py

Run as a file, it times the package of the working directory, so that two
checkouts can be compared on one card, in turns (parent, change, change,
parent). The seeded flagship model in bf16
(``config=[maskplanner,windows_v2,longx_v2]``, ``model.bf16=true``):

- K1 (``fused_sa_bwd_bf16_cuda``) at sa1 and sa2 on 64 clouds of the
  synthetic windows-v2 train split, with the training step's input flags
  (sa2's features alone carry a gradient), on the bf16 forward's pooled
  output and winner (and its packed image, where the wrapper takes one, as
  the step passes it): CUDA-event medians of 20 launches with the
  wrapper's host time;
- the training loop's default, the device-resident graphed epoch of 8 steps
  at batch 64 on a staged 512-item split: ms a step by the host clock, the
  mean of 2 epochs after 4 warm ones (the first captures the step).

Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ITEMS = 512
BATCH = 64
K1_REPS = 20


def k1_ms(model, pts: torch.Tensor) -> dict:
    """K1-bf16 alone at the model's sa1 and sa2, ms (median)."""
    from maskplanner_tpu_torch.ops.cuda import fused_sa as cuda_sa
    from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                    index_points)

    takes_image = "image" in inspect.signature(
        cuda_sa.fused_sa_bf16_cuda).parameters
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    feats = None
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        new_xyz = index_points(pts, farthest_point_sample(pts, sa.npoint))
        params = [tuple(t.detach() for t in layer)
                  for layer in sa.layer_params()]
        fwd = cuda_sa.fused_sa_bf16_cuda(sa.radius, sa.nsample, True, pts,
                                         new_xyz, feats, params, winner=True,
                                         **({"image": True} if takes_image
                                            else {}))
        pooled, idx, winner = fwd[:3]
        kw = {"winner": winner}
        if takes_image:
            kw["image"] = fwd[3]
        ct = torch.randn(pooled.shape, generator=gen, device="cuda")
        args = (sa.nsample, True, pts, new_xyz, feats, params, idx, pooled,
                ct, (False, False, feats is not None))
        for _ in range(3):
            cuda_sa.fused_sa_bwd_bf16_cuda(*args, **kw)
        torch.cuda.synchronize()
        times = []
        for _ in range(K1_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            cuda_sa.fused_sa_bwd_bf16_cuda(*args, **kw)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = statistics.median(times)
        pts, feats = new_xyz, pooled
    return out


def step_ms(cfg) -> float:
    """The bf16 graphed step, ms a step (host clock)."""
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.data.device_dataset import (
        epoch_perm, stage_device_dataset)
    from maskplanner_tpu_torch.losses import DeviceWeights, LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.train import (apply_delayed_activations,
                                             make_optimizer)
    from maskplanner_tpu_torch.train.trainer import DeviceEpoch

    data = stage_device_dataset(PaintDataset(cfg, split="train", size=ITEMS),
                                device="cuda")
    handler = LossHandler(cfg["loss"], cfg)
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    weights = apply_delayed_activations(cfg, handler.init_weights(), 10 ** 6)
    ep = DeviceEpoch(model, make_optimizer(model, cfg), handler, data,
                     DeviceWeights(weights, "cuda"),
                     torch.Generator(device="cuda").manual_seed(0),
                     int(cfg["pc_points"]))
    steps = ITEMS // BATCH
    for e in range(4):
        ep.run(epoch_perm(ITEMS, BATCH, 0, e))
    walls = []
    for e in (4, 5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ep.run(epoch_perm(ITEMS, BATCH, 0, e))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3 / steps)
    return statistics.mean(walls)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_step_bf16 needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    from maskplanner_tpu_torch.data import PaintDataset
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.utils.args import load_args

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    cfg = load_args(argv=["config=[maskplanner,windows_v2,longx_v2]",
                          "model.bf16=true"])
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    ds = PaintDataset(cfg, split="train", size=BATCH)
    pts = torch.from_numpy(np.stack([ds[i]["point_cloud"]
                                     for i in range(BATCH)])).cuda()
    with torch.no_grad():
        k1 = k1_ms(model, pts)
    del model
    out = {"checkout": os.getcwd(), "k1_ms": k1,
           "k1_total_ms": sum(k1.values()), "step_ms": step_ms(cfg)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
