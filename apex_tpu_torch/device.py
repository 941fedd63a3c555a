"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: the CPU is
for the tests, which hold the port against the JAX package on small inputs.
"""
from __future__ import annotations

import functools

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
