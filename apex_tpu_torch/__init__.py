"""apex_tpu_torch: the PyTorch/CUDA port of apex_tpu for one NVIDIA H100.

The package mirrors the module layout of `apex_tpu` (the JAX reference,
which stays in the repository unchanged) so that every module here has an
obvious counterpart there. Physics runs batch-last -- every array is
shape + (B,) -- exactly like `apex_tpu/physics/fleet.py`, and the two TPU
kernels on the evaluation path are hand-written CUDA (`csrc/`), built with
`nvcc` at first use and loaded with ctypes (`ops/cuda_build.py`).

This package never imports jax, flax, optax or apex_tpu.
"""
import torch as _torch

__version__ = "0.1.0"

# Physics stays in full fp32, mirroring the "highest" matmul precision that
# apex_tpu forces (apex_tpu/__init__.py): reduced-precision accumulation of
# the mass-matrix products made M indefinite for ~1% of envs
# (apex_tpu/physics/fleet.py, _mm_left).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
