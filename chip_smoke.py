#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and no
result line:

1. card identity (name and power limit from nvidia-smi, torch and CUDA);
2. build every CUDA kernel of ``maskplanner_tpu_torch/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   flagship shapes with a batch of 64: FPS indices identical; fused SA
   indices identical and pooled max|Δ| <= 1e-4 · max|ref|; median times;
4. the flagship forward (``config=[maskplanner,windows_v2,longx_v2]``,
   seeded weights) on 64 clouds of the synthetic windows-v2 data: finite
   outputs of the right shapes, every kernel launched exactly twice, and 2
   samples through the same model on the CPU (plain ops) within
   1e-4 · max|ref|; forward time at batch 64 and 1;
5. serving end to end: a run dir with the frozen config and a port
   checkpoint, an OBJ mesh, ``Predictor(device="cuda").predict_program``
   with ``cover_all=True``; per-request latency;
6. a ``kernels`` JSON line, then the card line as the last line.

It needs one CUDA card and the repository around it; without either it
exits non-zero.
"""
from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP = "config=[maskplanner,windows_v2,longx_v2]"
BATCH = 64
REL_TOL = 1e-4
KERNELS = {
    "fps": dict(source="maskplanner_tpu_torch/csrc/fps.cu",
                replaces="maskplanner_tpu/ops/pallas/fps.py:84"),
    "fused_sa_fwd": dict(
        source="maskplanner_tpu_torch/csrc/fused_sa_fwd.cu",
        replaces="maskplanner_tpu/ops/pallas/fused_sa_train.py:540"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
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


def median_host_s(fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of ``fn`` ending in a device synchronize."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def phase_identity() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def phase_build() -> None:
    from maskplanner_tpu_torch.ops.cuda import build

    t = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {len(paths)} kernels in {time.perf_counter() - t:.1f} s")
    for name, out in build.build_logs.items():
        for line in out.splitlines():
            if "registers" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                log(f"[build] {name}: {line.strip()}")


def load_clouds(cfg) -> np.ndarray:
    """64 normalized clouds of the synthetic windows-v2 test split."""
    from maskplanner_tpu.data import PaintDataset

    ds = PaintDataset(cfg, split="test", size=BATCH)
    return np.stack([ds[i]["point_cloud"] for i in range(BATCH)])


def phase_kernels(model, xyz: torch.Tensor) -> dict:
    """Kernel vs plain at the flagship sa1/sa2 shapes; returns results."""
    from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
    from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_cuda
    from maskplanner_tpu_torch.ops.fused_sa import fused_sa_forward_plain
    from maskplanner_tpu_torch.ops.sampling import fps_plain, index_points

    res = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, check="pass")
           for name in KERNELS}
    start = torch.zeros(BATCH, dtype=torch.int32, device=xyz.device)
    pts, feats = xyz, None
    for name, sa in (("sa1", model.sa1), ("sa2", model.sa2)):
        got = fps_cuda(pts, sa.npoint, start)
        ref = fps_plain(pts, sa.npoint, start)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"FPS {name}: kernel indices differ from the "
                                 f"plain version at "
                                 f"{int((got != ref).sum())} places")
        ms = median_ms(lambda: fps_cuda(pts, sa.npoint, start), 20)
        plain = median_ms(lambda: fps_plain(pts, sa.npoint, start), 5, 1)
        log(f"[kernels] fps {name} {tuple(pts.shape)}->{sa.npoint}: "
            f"identical; kernel {ms:.4f} ms, plain {plain:.4f} ms")
        res["fps"]["ms"] += ms
        res["fps"]["plain_ms"] += plain
        # fused SA level on those centroids
        new_xyz = index_points(pts, got)
        params = sa.layer_params()
        args = (sa.radius, sa.nsample)
        pooled, idx = fused_sa_cuda(*args, True, pts, new_xyz, feats, params)
        pooled_ref, idx_ref = fused_sa_forward_plain(
            *args, "layer", pts, new_xyz, feats, params)
        torch.cuda.synchronize()
        if not torch.equal(idx, idx_ref):
            raise AssertionError(f"fused SA {name}: kernel neighbour indices "
                                 f"differ from the plain version")
        err = float((pooled - pooled_ref).abs().max())
        scale = float(pooled_ref.abs().max())
        if not err <= REL_TOL * scale:
            raise AssertionError(f"fused SA {name}: max|Δ| {err} > "
                                 f"{REL_TOL} x {scale}")
        ms = median_ms(lambda: fused_sa_cuda(*args, True, pts, new_xyz, feats,
                                             params), 20)
        plain = median_ms(lambda: fused_sa_forward_plain(
            *args, "layer", pts, new_xyz, feats, params), 5, 1)
        distinct = float((idx_ref != idx_ref[..., :1]).sum(-1).float().mean()
                         + 1)
        log(f"[kernels] fused_sa_fwd {name} N={pts.shape[1]} "
            f"S={new_xyz.shape[1]} K={sa.nsample}: idx identical, max|Δ| "
            f"{err:.3e} (max|ref| {scale:.3e}, mean distinct neighbours "
            f"{distinct:.1f}); kernel {ms:.4f} ms, plain {plain:.4f} ms")
        fa = res["fused_sa_fwd"]
        fa["max_abs_err"] = max(fa["max_abs_err"], err)
        fa["ms"] += ms
        fa["plain_ms"] += plain
        pts, feats = new_xyz, pooled_ref      # the next level's inputs
    return res


def phase_forward(model, clouds: np.ndarray) -> dict:
    from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
    from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_cuda

    dev = torch.device("cuda")
    x = torch.from_numpy(clouds).to(dev)
    fps_cuda.launches = 0
    fused_sa_cuda.launches = 0
    with torch.inference_mode():
        out = model(x)
    torch.cuda.synchronize()
    launches = {"fps": fps_cuda.launches,
                "fused_sa_fwd": fused_sa_cuda.launches}
    log(f"[forward] launches in one forward: {launches}")
    for name, n in launches.items():
        if n != 2:
            raise AssertionError(f"{name} launched {n} times in one forward, "
                                 f"expected 2 (sa1, sa2)")
    v, m = 449, 22
    expect = {"traj": (BATCH, v, 24), "stroke_masks": (BATCH, m, v),
              "mask_scores": (BATCH, m)}
    for field, shape in expect.items():
        t = getattr(out, field)
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{field}: shape {tuple(t.shape)} "
                                 f"(expected {shape}) or non-finite values")
    if out.seg_conf is not None:
        raise AssertionError("the flagship has no segment confidences")

    cpu_model = copy.deepcopy(model).cpu()
    with torch.inference_mode():
        ref = cpu_model(torch.from_numpy(clouds[:2]))
    for field in expect:
        a = getattr(out, field)[:2].cpu()
        b = getattr(ref, field)
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        log(f"[forward] {field}: card vs CPU max|Δ| {err:.3e} "
            f"(max|ref| {scale:.3e})")
        if not err <= REL_TOL * scale:
            raise AssertionError(f"{field}: card and CPU disagree, {err} > "
                                 f"{REL_TOL} x {scale}")

    def fwd(inp):
        with torch.inference_mode():
            return model(inp)

    t64 = median_host_s(lambda: fwd(x), 10)
    t1 = median_host_s(lambda: fwd(x[:1]), 20)
    log(f"[forward] batch {BATCH}: {t64 * 1e3:.3f} ms "
        f"({BATCH / t64:.1f} point clouds/s); batch 1: {t1 * 1e3:.3f} ms")
    profile_forward(fwd, x)
    return launches


def profile_forward(fwd, x) -> None:
    """Device time by kernel over 3 forwards at batch 64 (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fwd(x)
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 3e3) for e in prof.key_averages()
            if e.device_time_total > 0]
    total = sum(ms for _, ms in rows)
    if not rows:
        log("[profile] no device time recorded: not measured")
        return
    log(f"[profile] device time per forward {total:.3f} ms (sum over ops)")
    for key, ms in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"[profile] {ms:9.3f} ms {100 * ms / total:5.1f}%  {key[:90]}")


def write_box_obj(path: str, dims, center) -> None:
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], np.float64)
    verts = corners * np.asarray(dims) / 2 + np.asarray(center)
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
             (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
             (1, 5, 7), (1, 7, 3)]
    with open(path, "w") as fh:
        for v in verts:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def phase_serve(cfg, model) -> None:
    from maskplanner_tpu.utils.config import save_config
    from maskplanner_tpu_torch.convert import save_checkpoint
    from maskplanner_tpu_torch.ops.cuda.fps import fps_cuda
    from maskplanner_tpu_torch.ops.cuda.fused_sa import fused_sa_cuda
    from maskplanner_tpu_torch.serve import Predictor

    with tempfile.TemporaryDirectory() as run_dir:
        save_config(cfg, run_dir)
        save_checkpoint(run_dir, "last_checkpoint", model)
        mesh = os.path.join(run_dir, "window.obj")
        # a window-sized box in millimetres, off the origin
        write_box_obj(mesh, dims=(900.0, 120.0, 1100.0),
                      center=(400.0, 1500.0, 900.0))
        pred = Predictor(run_dir, model="last", device="cuda")
        fps_cuda.launches = 0
        fused_sa_cuda.launches = 0
        rows = pred.predict_program(mesh, cover_all=True)
        if (fps_cuda.launches, fused_sa_cuda.launches) != (2, 2):
            raise AssertionError("the serving request did not run each "
                                 "kernel twice")
        if rows.ndim != 2 or rows.shape[1] != 7 or rows.shape[0] == 0 \
                or not np.isfinite(rows).all():
            raise AssertionError(f"bad program rows: shape {rows.shape}")
        n_strokes = len(np.unique(rows[:, 6]))
        times = []
        for _ in range(5):
            t = time.perf_counter()
            pred.predict_program(mesh, cover_all=True)
            times.append(time.perf_counter() - t)
        log(f"[serve] program {rows.shape[0]} poses, {n_strokes} strokes; "
            f"request latency median {statistics.median(times) * 1e3:.1f} ms "
            f"(min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f})")
        # the request's parts: the rest is the host postprocess and export
        t = time.perf_counter()
        pc, _ = pred.preprocess(mesh)
        t_pre = time.perf_counter() - t
        t_fwd = median_host_s(lambda: pred.forward(pc[None]), 10)
        log(f"[serve] of which preprocess {t_pre * 1e3:.1f} ms, forward "
            f"{t_fwd * 1e3:.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from maskplanner_tpu.utils.args import load_args
    from maskplanner_tpu_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_identity()
    phase_build()
    cfg = load_args(argv=[FLAGSHIP])
    model = get_model(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0))
    clouds = load_clouds(cfg)
    with torch.inference_mode():
        results = phase_kernels(model, torch.from_numpy(clouds).cuda())
    launches = phase_forward(model, clouds)
    phase_serve(cfg, model)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                                  "flax"))
    if leaked:
        raise AssertionError(f"jax was imported: {leaked}")
    kernels = [dict(name=name, route="cuda", **KERNELS[name],
                    launches=launches[name], **results[name])
               for name in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
