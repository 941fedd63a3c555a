"""Small-matrix SPD linear algebra, unrolled over the static dimension.

Port of `apex_tpu/ops/linalg.py`: Cholesky with a pivot floor and the two
triangular substitutions, written as per-column vector operations over
leading batch dimensions. `spd_inverse` is the plain version of the CUDA
kernel K3 (`ops/pallas_linalg.py`). The batched routes `batched_spd_inverse`
and `batched_spd_solve` take a batch-first fleet of matrices, as the JAX
package's custom vmap rules do: on the CPU the unrolled forms, on CUDA
tensors K3's batch-first route. All matrices are symmetric positive
definite (mass matrices, regularized Delassus operators).
"""
from __future__ import annotations

import torch


def cholesky_unrolled(A: torch.Tensor, pivot_floor: float = 1e-12
                      ) -> torch.Tensor:
    """Lower-triangular L with A = L L^T. A: (..., n, n).

    pivot_floor clamps the squared pivot. For Jacobi-normalized systems
    (unit diagonal) pass ~1e-4: a smaller pivot means a numerically
    singular direction, and letting it through cascades 1/d factors that
    overflow f32 (observed as Inf constraint impulses)."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        # d_j = sqrt(A_jj - sum_k L_jk^2)
        s = A[..., j, j] - torch.sum(L[..., j, :j] * L[..., j, :j], dim=-1)
        d = torch.sqrt(torch.clamp(s, min=pivot_floor))
        L[..., j, j] = d
        if j + 1 < n:
            r = A[..., j + 1:, j] - torch.einsum(
                "...ik,...k->...i", L[..., j + 1:, :j], L[..., j, :j])
            L[..., j + 1:, j] = r / d[..., None]
    return L


def tri_solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L X = B with L lower-triangular. B: (..., n, m) or (..., n)."""
    vec = B.dim() == L.dim() - 1
    if vec:
        B = B[..., None]
    n = L.shape[-1]
    X = torch.zeros_like(B)
    for i in range(n):
        r = B[..., i, :] - torch.einsum("...k,...km->...m", L[..., i, :i],
                                        X[..., :i, :])
        X[..., i, :] = r / L[..., i, i][..., None]
    return X[..., 0] if vec else X


def tri_solve_upper_t(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T X = B with L lower-triangular (i.e. upper system)."""
    vec = B.dim() == L.dim() - 1
    if vec:
        B = B[..., None]
    n = L.shape[-1]
    X = torch.zeros_like(B)
    for i in reversed(range(n)):
        r = B[..., i, :] - torch.einsum("...k,...km->...m",
                                        L[..., i + 1:, i], X[..., i + 1:, :])
        X[..., i, :] = r / L[..., i, i][..., None]
    return X[..., 0] if vec else X


def spd_solve(A: torch.Tensor, b: torch.Tensor,
              pivot_floor: float = 1e-12) -> torch.Tensor:
    """x = A^-1 b for SPD A via unrolled Cholesky."""
    L = cholesky_unrolled(A, pivot_floor=pivot_floor)
    return tri_solve_upper_t(L, tri_solve_lower(L, b))


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """A^-1 for SPD A via unrolled Cholesky against the identity."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    return spd_solve(A, eye)


def batched_spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """A (B, n, n) SPD -> A^-1, the counterpart of `make_batched_spd_inverse`
    under vmap (apex_tpu/ops/linalg.py:94-120): the unrolled `spd_inverse`
    on the CPU, as JAX's rule takes it off the TPU; on a CUDA tensor one
    launch of K3's batch-first route, or an error."""
    if A.device.type == "cpu":
        return spd_inverse(A)
    from apex_tpu_torch.ops.pallas_linalg import spd_inverse_bf

    return spd_inverse_bf(A.contiguous())


def batched_spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^-1 b for A (B, n, n) SPD and b (B, n), the counterpart of
    `make_batched_spd_solve` under vmap (apex_tpu/ops/linalg.py:125-157):
    the unrolled `spd_solve` on the CPU; on CUDA tensors the inverse from
    K3's batch-first route times b (:148-153)."""
    if A.device.type == "cpu":
        return spd_solve(A, b)
    return torch.einsum("bij,bj->bi", batched_spd_inverse(A), b)
