"""Profiling hooks.

Port of `apex_tpu/runtime/profiling.py`: the reference instruments
wall-clock phases only (ppo.py:382-391 sample/optimize/eval timers, kept in
the train loops); this module adds a device-level trace through
torch.profiler (CUDA kernels where a card is present, host operations
always), exported as a Chrome trace for Perfetto or chrome://tracing, and
named regions that show up in it.
"""
from __future__ import annotations

import contextlib
import os
import time
from types import SimpleNamespace

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed block into a Chrome trace file under
    `logdir`:

        with trace("runs/trace") as t:
            with annotate("policy_step"):
                state, obs, reward, done = env.step(state, action, noise)
        print(t.path)

    Yields a namespace with the trace file's `path` and the `profile`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"trace.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities)
    out = SimpleNamespace(path=path, profile=prof)
    prof.start()
    try:
        yield out
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


def annotate(name: str):
    """A named region inside traced code (shows up in the trace viewer)."""
    return torch.profiler.record_function(name)
