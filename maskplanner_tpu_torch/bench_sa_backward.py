"""Where the fused set-abstraction level's time goes, on the card.

    python -m maskplanner_tpu_torch.bench_sa_backward [--dtype bf16]

First the forward (``csrc/fused_sa_fwd.cu``): copies that each leave out
one phase (``SA_BWD_SKIP``: the products' mma loop, the LayerNorms, the
neighbour scan, the weight-tile streaming), each timed at sa1 and sa2.
Then the backward: copies of K1 (``csrc/fused_sa_bwd.cu``) that each
leave out one phase (the ``SA_BWD_SKIP`` macro), and times them and K2
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

``--dtype bf16`` does the same for the bf16 modes, which bf16 models train
with: the forward's (``fused_sa_forward_bf16``), K1's
(``fused_sa_backward_bf16``, on the bf16 forward's pooled output) and K2's
(``sa_weight_grad_bf16``). The copies are the same builds; in the bf16
modes bit 128 leaves out the mma loop of both K1 products (both are
``mma_product_bf16``) and bit 32 has no effect.
"""
from __future__ import annotations

import argparse
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
# the bf16 mode's copies (both K1 products are mma_product_bf16)
VARIANTS_BF16 = {"full": 0, "no recompute products": 1,
                 "no scratch rows": 2, "no input-gradient products": 4,
                 "no LayerNorm backward": 8, "no d_pre sums": 16,
                 "all five left out": 31, "no weight-tile streaming": 64,
                 "no mma loops (both products)": 128}
# forward copy -> SA_BWD_SKIP bits (csrc/fused_sa_common.cuh)
FWD_VARIANTS = {"full": 0, "no products' mma loop": 128,
                "no LayerNorms": 256, "no neighbour scan": 512,
                "no weight-tile streaming": 64,
                "no mma loop, LayerNorms or scan": 896}
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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=["f32", "bf16"], default="f32",
                        help="the kernels' mode (bf16: the bf16 models')")
    bf16 = parser.parse_args(argv).dtype == "bf16"
    if not torch.cuda.is_available():
        raise SystemExit("bench_sa_backward needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"mode: {'bf16' if bf16 else 'f32'}")
    jobs = {key: ("fused_sa_bwd", (f"-DSA_BWD_SKIP={bits}",))
            for key, bits in (VARIANTS_BF16 if bf16 else VARIANTS).items()}
    jobs["phases"] = ("fused_sa_bwd", ("-DSA_BWD_PHASES",))
    jobs.update({f"fwd {key}": ("fused_sa_fwd", (f"-DSA_BWD_SKIP={bits}",))
                 for key, bits in FWD_VARIANTS.items()})
    for key, flags in SHAPES.items():
        jobs[key] = ("fused_sa_bwd", flags)
    paths = build.build_all(jobs)
    for key, what in (("fwd full", "forward"), ("full", "K1")):
        for line in build.build_logs.get(key, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {what}: {line.strip()}")
    phases_lib = ctypes.CDLL(paths.pop("phases"))
    fwd_paths = {key[4:]: paths.pop(key) for key in list(paths)
                 if key.startswith("fwd ")}
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if os.path.isfile(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", paths["full"]],
                              capture_output=True, text=True).stdout
        n = sum(1 for line in sass.splitlines() if line.strip().startswith("/*")
                and "*/" in line and line.strip()[2:6].strip().isalnum())
        print(f"[sass] K1 (both modes): {n} instructions")
        if os.environ.get("SA_BWD_SASS_OUT"):
            with open(os.environ["SA_BWD_SASS_OUT"], "w") as fh:
                fh.write(sass)
    fwd_name = "fused_sa_forward_bf16" if bf16 else "fused_sa_forward"
    bwd_name = "fused_sa_backward_bf16" if bf16 else "fused_sa_backward"
    forward = cuda_sa.fused_sa_bf16_cuda if bf16 else cuda_sa.fused_sa_cuda
    k1 = cuda_sa.fused_sa_bwd_bf16_cuda if bf16 else cuda_sa.fused_sa_bwd_cuda
    k2 = (cuda_sa.sa_weight_grad_bf16_cuda if bf16
          else cuda_sa.sa_weight_grad_cuda)
    cfg = load_args(argv=["config=[maskplanner,windows_v2,longx_v2]"])
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    ds = PaintDataset(cfg, split="train", size=64)
    pts = torch.from_numpy(np.stack([ds[i]["point_cloud"]
                                     for i in range(64)])).cuda()
    feats = None
    gen = torch.Generator(device="cuda").manual_seed(1)
    bind, bind_fwd = cuda_sa._bind_bwd, cuda_sa._bind
    try:
        for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
            K = sa.nsample
            new_xyz = index_points(pts, farthest_point_sample(pts, sa.npoint))
            params = [tuple(t.detach() for t in l) for l in sa.layer_params()]
            for key, path in fwd_paths.items():
                fn = cuda_sa.fwd_signature(getattr(ctypes.CDLL(path),
                                                   fwd_name))
                cuda_sa._bind = lambda _bf16, fn=fn: fn
                with torch.no_grad():
                    ms = median_ms(lambda: forward(
                        sa.radius, K, True, pts, new_xyz, feats, params))
                print(f"{name} forward {key:35s} {ms:9.4f} ms")
            cuda_sa._bind = bind_fwd
            with torch.no_grad():
                pooled, idx = forward(sa.radius, K, True, pts, new_xyz, feats,
                                      params)
            ct = torch.randn(pooled.shape, generator=gen, device="cuda")
            args = (K, True, pts, new_xyz, feats, params, idx, pooled, ct,
                    (False, False, feats is not None))
            for key, path in paths.items():
                fn = cuda_sa.bwd_signature(getattr(ctypes.CDLL(path),
                                                   bwd_name))
                cuda_sa._bind_bwd = lambda _bf16, fn=fn: fn
                ms = median_ms(lambda: k1(*args))
                print(f"{name} K1 {key:40s} {ms:9.4f} ms")
            fn = cuda_sa.bwd_signature(getattr(phases_lib, bwd_name))
            cuda_sa._bind_bwd = lambda _bf16, fn=fn: fn
            cycles = (ctypes.c_ulonglong * len(PHASES))()
            phases_lib.sa_bwd_phase_cycles(cycles)       # zero them
            k1(*args)
            torch.cuda.synchronize()
            phases_lib.sa_bwd_phase_cycles(cycles)
            total = sum(cycles)
            print(f"{name} K1 phases, share of the first thread group's "
                  f"cycles:")
            for what, c in zip(PHASES, cycles):
                print(f"{name}   {what:30s} {100.0 * c / total:5.1f}%")
            cuda_sa._bind_bwd = bind
            _, _, _, scratch, vec, chans = k1(*args)
            ms = median_ms(lambda: k2(scratch, vec, chans, True, idx.numel()))
            print(f"{name} K2 {'':40s} {ms:9.4f} ms")
            del scratch, vec
            pts, feats = new_xyz, pooled
    finally:
        cuda_sa._bind_bwd = bind
        cuda_sa._bind = bind_fwd


if __name__ == "__main__":
    main()
