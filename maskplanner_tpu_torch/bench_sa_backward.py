"""Where the fused set-abstraction backward's time goes, on the card.

    python -m maskplanner_tpu_torch.bench_sa_backward

Builds copies of K1 (``csrc/fused_sa_bwd.cu``) that each leave out one
phase (the ``SA_BWD_SKIP`` macro), and times them and K2
(``csrc/sa_weight_grad.cu``) at the flagship shapes: the seeded
``config=[maskplanner,windows_v2,longx_v2]`` model's sa1 and sa2 on 64
clouds of the synthetic windows-v2 train split, with the training step's
input flags (sa2's features alone carry a gradient). Prints the card, then
per level and copy the CUDA-event median of 10 launches, and the same for
K1 with one thread group a block. A copy that
leaves out a phase computes wrong gradients; only its time is read. A
last copy (``SA_BWD_PHASES``) counts the clock cycles of each phase in
thread 0 of every block (its first thread group); their shares of the
group's time follow. The
compiler's register and spill report of K1 comes first (and its SASS
goes to the file $SA_BWD_SASS_OUT names, if set).
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess

import numpy as np
import torch

from .data import PaintDataset
from .models import get_model
from .ops.cuda import build
from .ops.cuda import fused_sa as cuda_sa
from .ops.sampling import farthest_point_sample, index_points
from .utils.args import load_args

# copy -> SA_BWD_SKIP bits (csrc/fused_sa_bwd.cu)
VARIANTS = {"full": 0, "no recompute products": 1, "no scratch rows": 2,
            "no input-gradient products": 4, "no LayerNorm backward": 8,
            "no d_pre sums": 16, "all five left out": 31,
            "input gradient: no mma loop": 32,
            "no weight-tile streaming": 64,
            "recompute: no multiply-adds": 128}
# other shapes of the full K1 (csrc/fused_sa_bwd.cu macros): one thread
# group a block instead of as many as fit
SHAPES = {"one thread group a block": ("-DSA_BWD_GROUPS=1",)}
# SA_BWD_PHASES counters, in order (csrc/fused_sa_bwd.cu, PHASE(i))
PHASES = ("indices and gather", "recompute products", "LayerNorm forward",
          "max-pool routing", "LayerNorm backward",
          "d_pre sums and scratch rows", "input-gradient products",
          "scatter", "query start and slot")


def median_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_sa_backward needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    jobs = {key: ("fused_sa_bwd", (f"-DSA_BWD_SKIP={bits}",))
            for key, bits in VARIANTS.items()}
    jobs["phases"] = ("fused_sa_bwd", ("-DSA_BWD_PHASES",))
    for key, flags in SHAPES.items():
        jobs[key] = ("fused_sa_bwd", flags)
    paths = build.build_all(jobs)
    for line in build.build_logs.get("full", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}")
    phases_lib = ctypes.CDLL(paths.pop("phases"))
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if os.path.isfile(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", paths["full"]],
                              capture_output=True, text=True).stdout
        n = sum(1 for line in sass.splitlines() if line.strip().startswith("/*")
                and "*/" in line and line.strip()[2:6].strip().isalnum())
        print(f"[sass] K1: {n} instructions")
        if os.environ.get("SA_BWD_SASS_OUT"):
            with open(os.environ["SA_BWD_SASS_OUT"], "w") as fh:
                fh.write(sass)
    cfg = load_args(argv=["config=[maskplanner,windows_v2,longx_v2]"])
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    ds = PaintDataset(cfg, split="train", size=64)
    pts = torch.from_numpy(np.stack([ds[i]["point_cloud"]
                                     for i in range(64)])).cuda()
    feats = None
    gen = torch.Generator(device="cuda").manual_seed(1)
    bind = cuda_sa._bind_bwd
    try:
        for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
            K = sa.nsample
            new_xyz = index_points(pts, farthest_point_sample(pts, sa.npoint))
            params = [tuple(t.detach() for t in l) for l in sa.layer_params()]
            with torch.no_grad():
                pooled, idx = cuda_sa.fused_sa_cuda(sa.radius, K, True, pts,
                                                    new_xyz, feats, params)
            ct = torch.randn(pooled.shape, generator=gen, device="cuda")
            args = (K, True, pts, new_xyz, feats, params, idx, pooled, ct,
                    (False, False, feats is not None))
            for key, path in paths.items():
                fn = cuda_sa.bwd_signature(ctypes.CDLL(path).fused_sa_backward)
                cuda_sa._bind_bwd = lambda fn=fn: fn
                ms = median_ms(lambda: cuda_sa.fused_sa_bwd_cuda(*args))
                print(f"{name} K1 {key:40s} {ms:9.4f} ms")
            fn = cuda_sa.bwd_signature(phases_lib.fused_sa_backward)
            cuda_sa._bind_bwd = lambda fn=fn: fn
            cycles = (ctypes.c_ulonglong * len(PHASES))()
            phases_lib.sa_bwd_phase_cycles(cycles)       # zero them
            cuda_sa.fused_sa_bwd_cuda(*args)
            torch.cuda.synchronize()
            phases_lib.sa_bwd_phase_cycles(cycles)
            total = sum(cycles)
            print(f"{name} K1 phases, share of the first thread group's "
                  f"cycles:")
            for what, c in zip(PHASES, cycles):
                print(f"{name}   {what:30s} {100.0 * c / total:5.1f}%")
            cuda_sa._bind_bwd = bind
            _, _, _, scratch, vec, chans = cuda_sa.fused_sa_bwd_cuda(*args)
            ms = median_ms(lambda: cuda_sa.sa_weight_grad_cuda(
                scratch, vec, chans, True, idx.numel()))
            print(f"{name} K2 {'':40s} {ms:9.4f} ms")
            del scratch, vec
            pts, feats = new_xyz, pooled
    finally:
        cuda_sa._bind_bwd = bind


if __name__ == "__main__":
    main()
