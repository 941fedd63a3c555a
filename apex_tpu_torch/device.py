"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: the CPU is
for the tests, which hold the port against the JAX package on small inputs.
"""
from __future__ import annotations

import functools
import subprocess
import time

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`None` or "cuda" -> the current CUDA device, raising when there is
    none; "cpu" -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "apex_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _const(values: tuple, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device).reshape(shape)


def const(x, device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A small constant (nested sequence or numpy array) as a tensor on
    `device`, copied there once per value: a host-to-device copy on every
    call of a hot loop would stall it. The tensor is shared: never modify
    it in place."""
    a = np.asarray(x)
    return _const(tuple(a.ravel().tolist()), a.shape, dtype,
                  torch.device(device))


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them for the first
    card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _launch_counters():
    from apex_tpu_torch.ops import pallas_linalg
    from apex_tpu_torch.physics import fleet_fk, fleet_kernel

    return {"K1": fleet_kernel.pd_substep,
            "K1-part": fleet_kernel.partitioned_pd_substep,
            "K2": fleet_fk.fleet_fk,
            "K3": pallas_linalg.spd_inverse_bt,
            "K3-bf": pallas_linalg.spd_inverse_bf}


def launch_counts() -> dict:
    """Every CUDA kernel's launch count as its wrapper keeps it, read and
    not reset (a caller may be counting a whole run around this one):
    K1 (its heightfield launches apart as "K1-hfield", its launches on a
    rank's shard apart as "K1-part"), K2, K3 and K3's batch-first route
    "K3-bf". All stay 0 on the CPU, where the wrappers run the plain
    versions."""
    from apex_tpu_torch.physics import fleet_kernel

    counts = {k: w.launches for k, w in _launch_counters().items()}
    counts["K1-hfield"] = fleet_kernel.pd_substep.hfield_launches
    return counts


def count_launches(fn):
    """Run fn() on the card with every CUDA kernel's launch count at 0
    just before; returns (fn's result, seconds, `launch_counts()` just
    after)."""
    from apex_tpu_torch.physics import fleet_kernel

    for w in _launch_counters().values():
        w.launches = 0
    fleet_kernel.pd_substep.hfield_launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    result = fn()
    torch.cuda.synchronize()
    return result, time.time() - t0, launch_counts()
