"""Ball-group gather, ball query and LAP kernel times at the main path's
shapes.

    python -m maskplanner_tpu_torch.bench_group_lap
    cd OTHER_CHECKOUT && python PATH/TO/bench_group_lap.py --wrappers

Inputs: 64 clouds of the synthetic windows-v2 train split and the seeded
models of ``config=[maskplanner,windows_v2,longx_v2]``. The ball-group
gather (``csrc/group_gather.cu``: f32 ``ball_group``, its single pass
``ball_group_single``, and the ball query ``ball_query``) at the BatchNorm
recipe's (``model.norm=batch``) sa1, 5120 -> 512 queries of K 32 at radius
0.2 with no features, and sa2, 512 -> 128 queries of K 64 at radius 0.4
with the 128 features of the recipe's own sa1, each at batch 64 and at
batch 1; the LAP (``csrc/lap.cu``) on the 64 x 22 x 22 costs that the
flagship's training loss solves (recorded from the loss), and on the first
of them alone. Each time is the CUDA-event median of 20 launches through
the kernel's wrapper, taken two ways: queued behind a device sleep, so that
the host's launch gap is not timed (the keys without a suffix), and as
``chip_smoke.py`` times its ``kernels`` line, gap included (``... with
gap``). Run as a file from the root of another checkout it times that
checkout's kernels (``--wrappers``: the A/B of two checkouts on one card,
in turns).

Without ``--wrappers`` it also times copies of this checkout's
``group_gather.cu`` built with timing-study flags, through their own C
entry points, queued: ``-DGG_NO_WRITE`` (the selection and the indices
alone, no value written: what #6's writes cost beside its scan) and
``-DGG_NO_STAGE`` (the cloud read through L1 instead of staged in shared
memory), each beside the default build. Prints the card's name and power limit, the
lines of the studies, and one JSON line of the times in ms.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
BATCH = 64
STUDIES = {"default": (),
           "no write": ("-DGG_NO_WRITE",),
           "no stage": ("-DGG_NO_STAGE",),
           "no stage, no write": ("-DGG_NO_STAGE", "-DGG_NO_WRITE")}


def inputs():
    """The levels' (radius, K, xyz, new_xyz, features) at batch 64 and the
    LAP costs of the flagship's training loss."""
    from maskplanner_tpu_torch.bench_fps_argmin import \
        inputs as flagship_inputs
    from maskplanner_tpu_torch.data import PaintDataset, collate
    from maskplanner_tpu_torch.losses import LossHandler
    from maskplanner_tpu_torch.models import get_model
    from maskplanner_tpu_torch.ops import hungarian as hung
    from maskplanner_tpu_torch.ops.sampling import (farthest_point_sample,
                                                    index_points)
    from maskplanner_tpu_torch.train import (apply_delayed_activations,
                                           batch_to_device, build_loss_batch)
    from maskplanner_tpu_torch.utils.args import load_args

    cfg = load_args(argv=[FLAGSHIP, "model.norm=batch"])
    bn = get_model(cfg, device="cuda",
                   generator=torch.Generator().manual_seed(0)).eval()
    ds = PaintDataset(cfg, split="train", size=BATCH)
    batch = batch_to_device(collate([ds[i] for i in range(BATCH)]), "cuda")
    pc = batch["point_cloud"]
    levels = {}
    with torch.no_grad():
        for name, sa, pts, feats in (("sa1", bn.sa1, pc, None),
                                     ("sa2", bn.sa2, *bn.sa1(pc, None))):
            new_xyz = index_points(pts, farthest_point_sample(pts,
                                                              sa.npoint))
            levels[name] = (sa.radius, sa.nsample, pts, new_xyz, feats)
    # the LAP's input, recorded from the flagship's loss
    model, _, _ = flagship_inputs()
    fcfg = load_args(argv=[FLAGSHIP])
    handler = LossHandler(fcfg["loss"], fcfg)
    model.train()
    seen = []
    orig = hung.lap
    hung.lap = lambda cost: (seen.append(cost.clone()), orig(cost))[1]
    try:
        with torch.no_grad():
            lb = build_loss_batch(model(pc), batch)
            # the weights after the delayed stroke-mask activation, under
            # which the loss matches the masks
            handler.compute(apply_delayed_activations(
                fcfg, handler.init_weights(), 10 ** 6), **lb)
    finally:
        hung.lap = orig
    return levels, seen[0]


def runs(levels: dict, cost: torch.Tensor) -> dict:
    """name -> a launch through the parent-compatible wrappers."""
    from maskplanner_tpu_torch.ops.cuda.group_gather import (
        ball_group_cuda, ball_group_single_cuda, ball_query_cuda)
    from maskplanner_tpu_torch.ops.cuda.lap import lap_cuda

    out = {}
    for level, (r, K, pts, q, f) in levels.items():
        for b in (BATCH, 1):
            args = (r, K, pts[:b].contiguous(), q[:b].contiguous(),
                    None if f is None else f[:b].contiguous())
            out[f"ball_group {level} b{b}"] = (
                lambda args=args: ball_group_cuda(*args))
            out[f"ball_group_single {level} b{b}"] = (
                lambda args=args: ball_group_single_cuda(*args))
            out[f"ball_query {level} b{b}"] = (
                lambda args=args: ball_query_cuda(*args[:4]))
    for b in (cost.shape[0], 1):
        c = cost[:b].contiguous()
        out[f"lap b{b}"] = lambda c=c: lap_cuda(c)
    return out


def studies(levels: dict) -> dict:
    """Per build of ``STUDIES`` (and the default build beside them) and
    level, at batch 64: ms a launch of the f32 gather, queued."""
    from maskplanner_tpu_torch.bench_fps_argmin import queued_ms
    from maskplanner_tpu_torch.ops.cuda import build

    paths = build.build_all({key: ("group_gather", flags)
                             for key, flags in STUDIES.items()})
    out = {}
    for key, path in paths.items():
        lib = ctypes.CDLL(path)
        group = lib.ball_group_forward
        group.restype = ctypes.c_int
        group.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        for level, (r, K, pts, q, f) in levels.items():
            B, N, _ = pts.shape
            S = q.shape[1]
            F = 0 if f is None else f.shape[-1]
            grouped = torch.empty((B, S, K, 3 + F), device="cuda")
            idx = torch.empty((B, S, K), dtype=torch.int32, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def run():
                err = group(pts.data_ptr(), q.data_ptr(),
                            None if f is None else f.data_ptr(), B, N, S, F,
                            K, float(r) ** 2, grouped.data_ptr(),
                            idx.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"ball_group_forward: CUDA error "
                                       f"{err}")
            ms = queued_ms(run)
            print(f"[group study] {key:20s} {level}: {ms:8.4f} ms")
            out[f"{key} {level}"] = ms
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wrappers", action="store_true",
                    help="time through the wrappers only (any checkout)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_group_lap needs a CUDA card")
    sys.path.insert(0, os.getcwd())
    from maskplanner_tpu_torch.bench_fps_argmin import median_ms, queued_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    levels, cost = inputs()
    out = {"package": os.path.dirname(sys.modules[
        "maskplanner_tpu_torch"].__file__)}
    fns = runs(levels, cost)
    for name, fn in fns.items():
        out[name] = queued_ms(fn)
    for name, fn in fns.items():
        out[f"{name} with gap"] = median_ms(fn, 20, 3)
    if not args.wrappers:
        out["group studies"] = studies(levels)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
