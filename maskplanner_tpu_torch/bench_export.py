"""Host cost of the custom ops and of the exported forward on the card.

    python -m maskplanner_tpu_torch.bench_export

On the seeded flagship model (``config=[maskplanner,windows_v2,longx_v2]``)
and 64 clouds of the synthetic windows-v2 test split:

1. each custom op of ``ops/library.py`` against its ``ctypes`` wrapper at
   the batch-1 forward's sa1 shapes: host µs a call, the median
   of 5 rounds of 200 calls under ``torch.inference_mode`` with no
   synchronize inside a round (the launches queue on the card; a round's
   device time is far below its host time at batch 1), and under
   ``torch.no_grad`` (the eval loop's mode);
2. the binding alone: an empty kernel called directly, as a
   ``torch.library.custom_op`` and as a ``torch.library.Library``
   definition, host µs a call (``dispatch_costs``);
3. the live forward against its exported program
   (``Predictor.export_compiled`` / ``serve.load_exported``), and the
   program's module without its guard function
   (``ExportedProgram.module(check_guards=False)``), f32 and bf16, at
   batch 1 and 64: host ms of a call that ends in a synchronize, the
   three calls alternating, median and quartiles of 60 (batch 64) or 300
   (batch 1) each; with the ATen operators a call dispatches
   (``torch.profiler``, CPU).

Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

REPS = {64: 60, 1: 300}


def _host_us(fn, calls: int = 200, rounds: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def _alternating_ms(runs: dict, reps: int) -> dict:
    """Host ms of each of ``runs``' calls (ending in a synchronize), the
    calls alternating (a, b, c, a, b, c, ...) so that the host's slow and
    fast spells fall on all alike -> per run the median and the quartiles."""
    for f in runs.values():
        for _ in range(5):
            f()
    torch.cuda.synchronize()
    times = {k: [] for k in runs}
    for _ in range(reps):
        for k, f in runs.items():
            t = time.perf_counter()
            f()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
    out = {}
    for k, v in times.items():
        q1, med, q3 = statistics.quantiles(v, n=4)
        out[k] = {"median": med, "q1": q1, "q3": q3}
    return out


def _aten_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name.startswith("aten::"))


def op_costs(model, x: torch.Tensor) -> dict:
    """Host µs a call of each custom op and of its wrapper, batch 1."""
    from .ops import library
    from .ops.cuda.fps import fps_cuda
    from .ops.cuda.fused_sa import fused_sa_bf16_cuda, fused_sa_cuda
    from .ops.cuda.group_gather import ball_group_cuda, ball_group_single_cuda
    from .ops.sampling import index_points

    x = x[:1].contiguous()
    start = torch.zeros(1, dtype=torch.int32, device=x.device)
    l1 = index_points(x, fps_cuda(x, 512, start))
    layers = [tuple(a.detach() for a in layer)
              for layer in model.sa1.layer_params()]
    flat = [a for layer in layers for a in layer]
    calls = {
        "fps": (lambda: library.fps(x, 512, start),
                lambda: fps_cuda(x, 512, start)),
        "fused_sa_fwd": (
            lambda: library.fused_sa_fwd(x, l1, None, flat, 0.2, 32, True),
            lambda: fused_sa_cuda(0.2, 32, True, x, l1, None, layers)),
        "fused_sa_fwd_bf16": (
            lambda: library.fused_sa_fwd_bf16(x, l1, None, flat, 0.2, 32,
                                              True),
            lambda: fused_sa_bf16_cuda(0.2, 32, True, x, l1, None, layers)),
        "ball_group": (lambda: library.ball_group(x, l1, None, 0.2, 32),
                       lambda: ball_group_cuda(0.2, 32, x, l1, None)),
        "ball_group_single": (
            lambda: library.ball_group_single(x, l1, None, 0.2, 32),
            lambda: ball_group_single_cuda(0.2, 32, x, l1, None)),
    }
    out = {}
    for mode, ctx in (("inference_mode", torch.inference_mode),
                      ("no_grad", torch.no_grad)):
        with ctx():
            out[mode] = {name: {"op_us": _host_us(op),
                                "wrapper_us": _host_us(wrapper)}
                         for name, (op, wrapper) in calls.items()}
    return out


def dispatch_costs() -> dict:
    """Host µs a call of an empty kernel (it allocates its output and
    launches nothing) on CUDA tensors, bound three ways: a plain Python
    call, a ``torch.library.custom_op`` (as ``ops/library.py`` binds the
    kernels) and a ``torch.library.Library`` definition with a Python
    CUDA implementation: what the binding itself costs."""
    def empty(xyz: torch.Tensor, npoint: int,
              start: torch.Tensor) -> torch.Tensor:
        return xyz.new_empty((xyz.shape[0], npoint), dtype=torch.int32)

    op = torch.library.custom_op("maskplanner_bench::empty", empty,
                                 mutates_args=(), device_types="cuda")
    lib = torch.library.Library("maskplanner_bench_lib", "DEF")
    lib.define("empty(Tensor xyz, int npoint, Tensor start) -> Tensor")
    lib.impl("empty", empty, "CUDA")
    x = torch.zeros((1, 5120, 3), device="cuda")
    start = torch.zeros(1, dtype=torch.int32, device="cuda")
    calls = {"python": lambda: empty(x, 512, start),
             "custom_op": lambda: op(x, 512, start),
             "library": lambda: torch.ops.maskplanner_bench_lib.empty(
                 x, 512, start)}
    out = {}
    for mode, ctx in (("inference_mode", torch.inference_mode),
                      ("no_grad", torch.no_grad)):
        with ctx():
            out[mode] = {k: _host_us(f, calls=2000) for k, f in calls.items()}
    return out


def forward_costs(cfg, model, clouds: np.ndarray) -> dict:
    """Live against exported host ms, f32 and bf16, batch 1 and 64."""
    from .convert import save_checkpoint
    from .models.maskplanner import f32_accumulation
    from .serve import Predictor, load_exported
    from .utils.config import save_config

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        save_config(cfg, tmp)
        save_checkpoint(tmp, "last_checkpoint", model)
        for dtype in ("f32", "bf16"):
            pred = Predictor(tmp, device="cuda", compute_dtype=dtype)
            for batch, reps in REPS.items():
                path = f"{tmp}/{dtype}-{batch}.pt2"
                pred.export_compiled(path, batch=batch)
                fn = load_exported(path)
                raw = _raw_module(path)
                x = torch.from_numpy(clouds[:batch]).cuda()

                def no_guards():
                    with f32_accumulation():
                        return raw(x)

                runs = {"live": lambda: pred.model(x),
                        "exported": lambda: fn(x),
                        "exported_no_guards": no_guards}
                with torch.inference_mode():
                    ms = _alternating_ms(runs, reps)
                    ops = {k: _aten_ops(f) for k, f in runs.items()}
                out[f"{dtype}_batch{batch}"] = {
                    k: {"ms": v, "aten_ops": ops[k]} for k, v in ms.items()}
    return out


def _raw_module(path: str):
    """The exported program's module without its guard function."""
    import io

    from .serve import _unseal

    with open(path, "rb") as fh:
        _, archive = _unseal(fh.read(), path)
    return torch.export.load(io.BytesIO(archive)).module(check_guards=False)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_export needs a CUDA card")
    from .data import PaintDataset
    from .models import get_model
    from .utils.args import load_args

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_args(argv=["config=[maskplanner,windows_v2,longx_v2]"])
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    ds = PaintDataset(cfg, split="test", size=64)
    clouds = np.stack([ds[i]["point_cloud"] for i in range(64)])
    print(json.dumps({"ops": op_costs(model, torch.from_numpy(clouds).cuda()),
                      "dispatch": dispatch_costs(),
                      "forward": forward_costs(cfg, model, clouds)}))


if __name__ == "__main__":
    main()
