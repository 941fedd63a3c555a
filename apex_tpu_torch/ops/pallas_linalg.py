"""K3: the batched SPD inverse of the physics, as a CUDA kernel.

Counterpart of `apex_tpu/ops/pallas_linalg.py`, whose Pallas kernel
inverts the damped mass matrix M + hD of every env once per substep. The
kernel is `csrc/spd_inverse.cu`, one warp per matrix with a column per
lane in registers, at a width of 8, 16 or 32; its plain version is the
unrolled Cholesky of `ops/linalg.py`. Two routes, each with its own launch
count: `spd_inverse_bt` for the batch-last (n, n, B) layout of the fleet
tier (`pallas_spd_inverse_bt`), and `spd_inverse_bf` for the batch-first
(B, n, n) layout of the per-env engine (`pallas_spd_inverse`, K3-bf),
which reads that layout itself instead of transposing around the kernel.
The wrappers take the plain version for tensors on the CPU only; for CUDA
tensors they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from apex_tpu_torch.ops import cuda_build
from apex_tpu_torch.ops.linalg import spd_inverse


def spd_inverse_bt_plain(A: torch.Tensor) -> torch.Tensor:
    """(n, n, B) SPD -> (n, n, B) inverses, through `linalg.spd_inverse`."""
    return spd_inverse(A.permute(2, 0, 1)).permute(1, 2, 0).contiguous()


def spd_inverse_bt(A: torch.Tensor) -> torch.Tensor:
    """Batch-last SPD inverse: A (n, n, B) symmetric -> out (n, n, B) with
    out[i, m, b] = A[:, :, b]^-1[i, m] (the layout of
    `pallas_spd_inverse_bt`). n <= 32, float32."""
    if A.device.type == "cpu":
        return spd_inverse_bt_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"spd_inverse_bt: unsupported device {A.device}")
    if A.dtype != torch.float32 or A.dim() != 3 or A.shape[0] != A.shape[1] \
            or not 1 <= A.shape[0] <= 32 or not A.is_contiguous():
        raise ValueError("spd_inverse_bt: expects a contiguous float32 "
                         f"(n, n, B) tensor with n <= 32, got {A.dtype} "
                         f"{tuple(A.shape)} contiguous={A.is_contiguous()}")
    n, _, B = A.shape
    out = torch.empty_like(A)
    lib = cuda_build.library()
    err = lib.apex_spd_inverse(A.data_ptr(), out.data_ptr(), n, B,
                               torch.cuda.current_stream(A.device).cuda_stream)
    cuda_build.check(err, "apex_spd_inverse")
    spd_inverse_bt.launches += 1
    return out


def spd_inverse_bf(A: torch.Tensor) -> torch.Tensor:
    """Batch-first SPD inverse (K3-bf): A (B, n, n) symmetric -> out (B, n,
    n) with out[b] = A[b]^-1 (the layout of `pallas_spd_inverse`). n <= 32,
    float32. On a CUDA tensor its output is `spd_inverse_bt`'s on the same
    matrices laid out batch-last, bit for bit."""
    if A.device.type == "cpu":
        return spd_inverse(A)
    if A.device.type != "cuda":
        raise ValueError(f"spd_inverse_bf: unsupported device {A.device}")
    if A.dtype != torch.float32 or A.dim() != 3 or A.shape[1] != A.shape[2] \
            or not 1 <= A.shape[1] <= 32 or not A.is_contiguous():
        raise ValueError("spd_inverse_bf: expects a contiguous float32 "
                         f"(B, n, n) tensor with n <= 32, got {A.dtype} "
                         f"{tuple(A.shape)} contiguous={A.is_contiguous()}")
    B, n, _ = A.shape
    out = torch.empty_like(A)
    err = cuda_build.library().apex_spd_inverse_bf(
        A.data_ptr(), out.data_ptr(), n, B,
        torch.cuda.current_stream(A.device).cuda_stream)
    cuda_build.check(err, "apex_spd_inverse_bf")
    spd_inverse_bf.launches += 1
    return out


def launch_info(n: int) -> Dict[str, int]:
    """K3's launch shape for (n, n) matrices on the current card: the width
    it pads n to, shared memory per block, matrices per block (a warp
    each), blocks and matrices resident per SM."""
    out = (ctypes.c_int * 5)()
    cuda_build.check(cuda_build.library().apex_spd_inverse_info(n, out),
                     "apex_spd_inverse_info")
    return dict(width=out[4], smem_bytes_per_block=out[0],
                matrices_per_block=out[1], blocks_per_sm=out[2],
                matrices_per_sm=out[3])


spd_inverse_bt.launches = 0
spd_inverse_bf.launches = 0
