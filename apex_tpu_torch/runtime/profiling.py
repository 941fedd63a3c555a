"""Profiling hooks.

Port of `apex_tpu/runtime/profiling.py`: the reference instruments
wall-clock phases only (ppo.py:382-391 sample/optimize/eval timers, kept in
the train loops); this module adds a device-level trace through
torch.profiler (CUDA kernels where a card is present, host operations
always), exported as a Chrome trace for Perfetto or chrome://tracing, and
named regions that show up in it.

On the card, torch.profiler drops the first kernels of a window that opens
right before them, and more the longer the process has run: on an H100, 2
of 50 back-to-back launches after 43 s, 33 of 50 after 460 s. A window held
open PAD_S seconds on each side of the block kept all 50 in 12 of 15 such
traces, an unpadded one in 1 of 15 (scripts/trace_window.py). Where every
kernel must be in the trace, count them there and take it again if some
are missing.
"""
from __future__ import annotations

import contextlib
import os
import time
from types import SimpleNamespace

import torch

PAD_S = 0.5  # seconds the window stays open before and after the block


@contextlib.contextmanager
def trace(logdir: str, pad_s: float = PAD_S):
    """Capture a trace of the enclosed block into a Chrome trace file under
    `logdir`:

        with trace("runs/trace") as t:
            with annotate("policy_step"):
                state, obs, reward, done = env.step(state, action, noise)
        print(t.path)

    Yields a namespace with the trace file's `path` and the `profile`.
    Where the card is traced, the window opens `pad_s` seconds before the
    block and closes `pad_s` seconds after the card has finished it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(
        logdir, f"trace.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof = profile(activities=activities)
    out = SimpleNamespace(path=path, profile=prof)
    prof.start()
    if cuda:
        torch.cuda.synchronize()
        time.sleep(pad_s)
    try:
        yield out
    finally:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(pad_s)
        prof.stop()
        prof.export_chrome_trace(path)


def annotate(name: str):
    """A named region inside traced code (shows up in the trace viewer)."""
    return torch.profiler.record_function(name)
