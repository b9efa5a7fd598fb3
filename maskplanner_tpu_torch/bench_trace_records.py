"""How many kernel records ``torch.profiler`` drops from a trace.

    python -m maskplanner_tpu_torch.bench_trace_records [--traces 16]

``chip_smoke.py`` counts what a CUDA graph replay launched from a
``torch.profiler`` chrome trace (``trace_launches``, ``per_replay``), and a
trace now and then lacks some of the kernels that ran. This measures that
loss on its own, with no kernel of the port: a CUDA graph of ``KERNELS``
elementwise additions, replayed twice in each trace, and the same additions
launched eagerly twice, each traced ``--traces`` times under four starts:
right away, after a 20 ms pause, after one kernel and a synchronisation,
after a 200 ms pause. For each it prints the kernel records every trace held
(of ``2 * KERNELS``) and, for the graph, the records of each replay (by the
kernel's correlation with its ``cudaGraphLaunch``). Prints the card's name
and power limit first, and one JSON line of the counts last.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import tempfile
import time

import torch

KERNELS = 40
REPLAYS = 2
STARTS = (("right away", 0.0, False), ("after 20 ms", 0.02, False),
          ("after a kernel", 0.0, True), ("after 200 ms", 0.2, False))


def _trace(fn, pause: float, warm: bool) -> tuple[int, list]:
    """``REPLAYS`` calls of ``fn`` under the profiler -> the addition kernels
    the trace holds, and those of each ``cudaGraphLaunch`` (none eager)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if warm:
            torch.zeros(1, device="cuda").fill_(1.0)
        torch.cuda.synchronize()
        time.sleep(pause)
        for _ in range(REPLAYS):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    adds = [e for e in events if e.get("cat") == "kernel"
            and "add" in e.get("name", "").lower()]
    launches = sorted(e["args"]["correlation"] for e in events
                      if e.get("name", "").startswith("cudaGraphLaunch"))
    per = collections.Counter(e["args"].get("correlation") for e in adds)
    return len(adds), [per[c] for c in launches]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_trace_records: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])

    x = torch.randn(4096, device="cuda")
    ys = [torch.empty_like(x) for _ in range(KERNELS)]

    def eager():
        for i, y in enumerate(ys):
            torch.add(x, float(i), out=y)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            eager()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    torch.cuda.synchronize()

    out = {}
    for mode, fn in (("graph", graph.replay), ("eager", eager)):
        for start, pause, warm in STARTS:
            got = [_trace(fn, pause, warm) for _ in range(args.traces)]
            held = [n for n, _ in got]
            out[f"{mode}, {start}"] = dict(
                records=held, per_replay=[p for _, p in got],
                short=sum(n < REPLAYS * KERNELS for n in held))
            print(f"{mode}, {start}: {out[f'{mode}, {start}']['short']} of "
                  f"{args.traces} traces short of {REPLAYS * KERNELS} "
                  f"records; records {held}"
                  + (f"; a replay's {[p for _, p in got]}"
                     if mode == "graph" else ""), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
