"""How far torch.profiler's kernel timestamps drift from its host clock,
and whether `runtime/profiling.trace` keeps every kernel of a traced block.

torch.profiler keeps a GPU activity only where it lies inside the window
between the profiler's start and stop on the host's clock; the kernels'
own timestamps come from the card's clock. Where the two clocks drift
apart over a run, the kernels at an edge of a tight window fall outside it
and are dropped from the trace. Each round, after `--every` seconds of
matrix products that keep the card busy, this script takes:

  tight   start, LAUNCHES small kernels back to back, synchronize, stop;
  pre     the same with the window held open PAD_S before the launches;
  post    the same with it held open PAD_S after the card has finished;
  trace   the same through profiling.trace (padded on both sides).

For each: the launches the trace kept, the indices of the first and last
launch it lost, and the median of kernel start minus its cudaLaunchKernel
start over the kept launches (us; the offset between the two clocks as the
trace reads it, plus the launch queue).

One line per round with the seconds since the first trace, then a JSON
summary with the card's name and power limit.

    python3 scripts/trace_window.py [--seconds 480] [--every 30]

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apex_tpu_torch.device import card_line  # noqa: E402
from apex_tpu_torch.runtime import profiling  # noqa: E402

LAUNCHES = 50


def chrome_events(prof, d):
    path = os.path.join(d, f"t{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)["traceEvents"]


def kernels(events):
    return [e for e in events if e.get("cat") == "kernel"]


def burst(x, pre: float, post: float):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    time.sleep(pre)
    for _ in range(LAUNCHES):
        x.add_(1.0)
    torch.cuda.synchronize()
    time.sleep(post)
    prof.stop()
    return prof


def reading(events):
    """(kept, first lost index, last lost index, median offset us)."""
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("cat") == "cuda_runtime"
                      and e.get("name") == "cudaLaunchKernel")
    kernel_ts = {e["args"]["correlation"]: e["ts"] for e in kernels(events)
                 if "correlation" in e.get("args", {})}
    lost = [i for i, (_, c) in enumerate(launches) if c not in kernel_ts]
    offs = [float(kernel_ts[c]) - float(ts) for ts, c in launches
            if c in kernel_ts]
    return dict(kept=len(kernels(events)),
                lost_first=lost[0] if lost else None,
                lost_last=lost[-1] if lost else None,
                offset_us=round(float(np.median(offs)), 2) if offs else None)


def busy(seconds, a):
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        for _ in range(20):
            a = torch.tanh(a @ a * 1e-3)
        torch.cuda.synchronize()
    return a


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=480.0)
    p.add_argument("--every", type=float, default=30.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    x = torch.zeros(64, device="cuda")
    a = torch.randn(4096, 4096, device="cuda")
    pad = profiling.PAD_S
    rows = []
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        while True:
            t = time.perf_counter() - t0
            row = dict(t_s=round(t, 1))
            for name, pre, post in (("tight", 0.0, 0.0), ("pre", pad, 0.0),
                                    ("post", 0.0, pad)):
                row[name] = reading(chrome_events(burst(x, pre, post), d))
            with profiling.trace(d) as tr:
                for _ in range(LAUNCHES):
                    x.add_(1.0)
            with open(tr.path) as f:
                row["trace"] = reading(json.load(f)["traceEvents"])
            rows.append(row)
            print(json.dumps(row), flush=True)
            if t + args.every > args.seconds:
                break
            a = busy(args.every, a)
    print(card_line())
    print(json.dumps(dict(
        rounds=len(rows), launches=LAUNCHES, pad_s=pad,
        short={k: sum(r[k]["kept"] < LAUNCHES for r in rows)
               for k in ("tight", "pre", "post", "trace")})))


if __name__ == "__main__":
    main()
