"""FPS and nearest-neighbour argmin kernel times at the main path's shapes.

    python -m maskplanner_tpu_torch.bench_fps_argmin
    cd OTHER_CHECKOUT && python PATH/TO/bench_fps_argmin.py --wrappers

Inputs: the seeded flagship model (``config=[maskplanner,windows_v2,
longx_v2]``) and 64 clouds of the synthetic windows-v2 train split. FPS
(``csrc/fps.cu``) at sa1, 5120 -> 512 points, and sa2, 512 -> 128 (sa2's
points picked by sa1's FPS), each at batch 64 and at batch 1; the argmin
(``csrc/nn_argmin.cu``) at the training step's three calls, on the model's
train-mode outputs through ``build_loss_batch``. Each time is the
CUDA-event median of 20 launches through the kernel's wrapper, taken two
ways: queued behind a device sleep, so that the host's launch gap is not
timed (the keys without a suffix), and as ``chip_smoke.py`` times its
``kernels`` line, gap included (``... with gap``). It also profiles the
batch-1 eval forward (``torch.profiler``): its device time and FPS's part.
Run as a file from the root of another checkout it times that checkout's
kernels (``--wrappers``: the A/B of two checkouts on one card, in turns).

Without ``--wrappers`` it also times copies of this checkout's ``fps.cu``
built for each thread count a block (``-DFPS_THREADS``) at sa1 and sa2,
and the same with the distance update replaced by one instruction
(``-DFPS_NO_UPDATE``): what the argmax chain (warp reductions, the
barrier, the slots) costs a step on its own. Prints the card's name and
power limit, the lines of the studies, and one JSON line of the times in
ms.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
BATCH = 64
SLEEP_CYCLES = 200_000    # device sleep ahead of a queued launch (~0.1 ms)
# threads a block timed at each level (csrc/fps.cu fits its point counts)
FPS_THREADS = {"sa1": (256, 512, 1024), "sa2": (64, 128, 256, 512)}


def median_ms(fn, reps: int = 20, warmup: int = 2,
              sleep_cycles: int = 0) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events). With
    ``sleep_cycles``, each call is queued behind a device sleep of that many
    cycles, so that the events hold the kernel alone and not the host's
    launch gap; without, the gap is in the time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn) -> float:
    return median_ms(fn, 20, 3, SLEEP_CYCLES)


def inputs():
    """The model, the levels' FPS inputs and the step's argmin calls."""
    from maskplanner_tpu_torch.data import PaintDataset, collate
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                    index_points)
    from maskplanner_tpu_torch.train import batch_to_device, build_loss_batch
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=[FLAGSHIP])
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    ds = PaintDataset(cfg, split="train", size=BATCH)
    batch = batch_to_device(collate([ds[i] for i in range(BATCH)]), "cuda")
    pts1 = batch["point_cloud"]
    pts2 = index_points(pts1, farthest_point_sample(pts1, model.sa1.npoint))
    levels = {"sa1": (pts1, model.sa1.npoint),
              "sa2": (pts2, model.sa2.npoint)}
    model.train()
    with torch.no_grad():
        lb = build_loss_batch(model(pts1), batch)
    poses = lb["y_pred"].reshape(BATCH, -1, 6)
    calls = {"forward segments": (lb["y_pred"], lb["y"], lb["y_mask"]),
             "reverse segments": (lb["y"], lb["y_pred"], None),
             "reverse points": (lb["traj_as_pc"], poses, None)}
    return model, levels, calls


def forward_share(model, cloud: torch.Tensor, reps: int = 10) -> dict:
    """Device time of the batch-1 eval forward and FPS's part of it, in ms
    a forward (torch.profiler, the sum over the kernels' rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model.eval()
    with torch.inference_mode():
        for _ in range(3):
            model(cloud)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                model(cloud)
            torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / (reps * 1e3))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    total = sum(ms for _, ms in rows)
    fps = sum(ms for key, ms in rows if "fps" in key)
    print(f"[profile] batch-1 forward: device {total:.4f} ms, FPS {fps:.4f} "
          f"ms ({100 * fps / total:.1f}%)" if total else
          "[profile] batch-1 forward: no device time recorded")
    return {"device": total, "fps": fps}


def fps_studies(levels: dict) -> dict:
    """Per build (threads a block, with or without the distance update):
    ms a launch and us a step, through the copy's own entry point."""
    from maskplanner_tpu_torch.ops.cuda import build

    jobs = {}
    for threads in sorted({t for ts in FPS_THREADS.values() for t in ts}):
        flags = (f"-DFPS_THREADS={threads}",)
        jobs[f"full t{threads}"] = ("fps", flags)
        jobs[f"no update t{threads}"] = ("fps", flags + ("-DFPS_NO_UPDATE",))
    paths = build.build_all(jobs)
    out = {}
    for level, (pts, npoint) in levels.items():
        for key in ("full", "no update"):
            for threads in FPS_THREADS[level]:
                fn = ctypes.CDLL(paths[f"{key} t{threads}"]).fps_forward
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                for batch in (BATCH, 1):
                    xyz = pts[:batch].contiguous()
                    start = torch.zeros(batch, dtype=torch.int32,
                                        device="cuda")
                    res = torch.empty((batch, npoint), dtype=torch.int32,
                                      device="cuda")
                    stream = torch.cuda.current_stream().cuda_stream

                    def run():
                        err = fn(xyz.data_ptr(), start.data_ptr(), None,
                                 batch, xyz.shape[1], npoint, res.data_ptr(),
                                 stream)
                        if err:
                            raise RuntimeError(f"fps_forward: CUDA error "
                                               f"{err}")
                    ms = queued_ms(run)
                    name = f"{key} {level} b{batch} t{threads}"
                    print(f"[fps] {name:28s} {ms:8.4f} ms, "
                          f"{1e3 * ms / npoint:7.4f} us a step")
                    out[name] = ms
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wrappers", action="store_true",
                    help="time through the wrappers only (any checkout)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_fps_argmin needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
    from maskplanner_tpu_torch.ops.cuda.nn_argmin import nn_argmin_cuda

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, levels, calls = inputs()
    out = {"package": os.path.dirname(sys.modules[
        "maskplanner_tpu_torch"].__file__)}
    runs = {}
    for level, (pts, npoint) in levels.items():
        for batch in (BATCH, 1):
            xyz = pts[:batch].contiguous()
            start = torch.zeros(batch, dtype=torch.int32, device="cuda")
            runs[f"fps {level} b{batch}"] = (
                lambda xyz=xyz, npoint=npoint, start=start:
                fps_cuda(xyz, npoint, start))
    for what, (x, y, mask) in calls.items():
        runs[f"nn_argmin {what}"] = (lambda x=x, y=y, mask=mask:
                                     nn_argmin_cuda(x, y, mask))
    for name, fn in runs.items():
        out[name] = queued_ms(fn)
    for name, fn in runs.items():
        out[f"{name} with gap"] = median_ms(fn, 20, 3)
    out["batch-1 forward"] = forward_share(model, levels["sa1"][0][:1])
    if not args.wrappers:
        out["fps studies"] = fps_studies(levels)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
