"""Terrain heightfield generators and the env's terrain bank.

Port of `apex_tpu/utils/terrain.py` (the reference's noise-terrain
generator, cassie/cassiemujoco/terrains/utils/noise_generator.py: random
noise smoothed into a heightfield), producing (HFIELD_RES, HFIELD_RES)
grids for `PhysParams.hfield`, with an explicit `torch.Generator`.

The env does not draw its terrain with these: the JAX package draws a
64-table bank per terrain kind from fixed keys, and torch cannot draw
jax.random's numbers. `terrain_bank` reads that bank from
`apex_tpu_torch/data/terrain_banks.npz` (written by
`scripts/export_terrain_banks.py`) and applies the generators' amplitude
scaling, so a bank here equals the JAX env's.
"""
from __future__ import annotations

import functools
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch.physics.engine import HFIELD_RES

BANKS = Path(__file__).resolve().parent.parent / "data" / "terrain_banks.npz"
# smoothing of each noise terrain kind (apex_tpu/envs/cassie.py:218-226)
SMOOTHNESS = {"noise": 3, "hill": 9}


def smooth_noise(u: torch.Tensor, smoothness: int = 3) -> torch.Tensor:
    """Uniform draws u (..., res, res) in [-1, 1) smoothed twice by a
    `smoothness`^2 box filter ("same" convolution, zero padding, as
    jax.scipy.signal.convolve2d) and centred on zero: the noise terrain
    before its amplitude scaling."""
    s = smoothness
    lead = u.shape[:-2]
    h = u.reshape(-1, 1, *u.shape[-2:])
    kernel = torch.full((1, 1, s, s), 1.0 / (s * s), dtype=u.dtype,
                        device=u.device)
    for _ in range(2):
        # "same" keeps the full convolution's entries from (s - 1) // 2 on
        h = F.conv2d(F.pad(h, (s // 2, (s - 1) // 2, s // 2, (s - 1) // 2)),
                     kernel)
    h = h - h.mean(dim=(-2, -1), keepdim=True)
    return h.reshape(*lead, *u.shape[-2:])


def scale_noise(h: torch.Tensor, amplitude: float) -> torch.Tensor:
    """Centred noise h (..., res, res) scaled to +- amplitude, as the
    generator's last step: amplitude * h / max(|h|)."""
    scale = torch.clamp(h.abs().amax(dim=(-2, -1), keepdim=True), min=1e-6)
    return amplitude * h / scale


def noise_hfield(generator: torch.Generator, amplitude: float = 0.05,
                 smoothness: int = 3, res: int = HFIELD_RES,
                 device=None) -> torch.Tensor:
    """Smoothed uniform noise terrain, zero-mean, +-amplitude."""
    u = 2.0 * torch.rand((res, res), generator=generator,
                         device=device) - 1.0
    return scale_noise(smooth_noise(u, smoothness), amplitude)


def slope_hfield(pitch: float = 0.03, roll: float = 0.0,
                 radius: float = 10.0, res: int = HFIELD_RES,
                 device=None) -> torch.Tensor:
    """Planar incline expressed as a heightfield (tilt-terrain variants)."""
    xs = torch.linspace(-radius, radius, res, device=device)
    X, Y = torch.meshgrid(xs, xs, indexing="ij")
    return X * math.tan(pitch) + Y * math.tan(roll)


def nearest_resize(coarse: torch.Tensor, res: int) -> torch.Tensor:
    """(..., c, c) -> (..., res, res) by nearest-neighbour sampling at the
    cell centres, as jax.image.resize(method="nearest")."""
    c = coarse.shape[-1]
    idx = torch.floor((torch.arange(res, dtype=torch.float64) + 0.5)
                      * c / res).long().clamp(max=c - 1).to(coarse.device)
    return coarse[..., idx, :][..., idx]


def steps_hfield(generator: torch.Generator, step_height: float = 0.05,
                 cells: int = 4, res: int = HFIELD_RES,
                 device=None) -> torch.Tensor:
    """Random terraced steps (drop-step / stair variants)."""
    coarse = 2.0 * torch.rand((cells, cells), generator=generator,
                              device=device) - 1.0
    return step_height * nearest_resize(coarse, res)


@functools.lru_cache(maxsize=None)
def _bank_rows(kind: str) -> np.ndarray:
    with np.load(BANKS) as f:
        return f[kind]


def terrain_bank(kind: str, amplitude: float, device=None) -> torch.Tensor:
    """(64, HFIELD_RES, HFIELD_RES) terrain tables of `kind` ("noise",
    "hill" or "steps") at `amplitude`: the JAX env's bank
    (apex_tpu/envs/cassie.py:209-229), from the committed file of the
    generators' draws before their amplitude scaling."""
    if kind not in ("noise", "hill", "steps"):
        raise ValueError(f"unknown terrain {kind}")
    rows = torch.as_tensor(_bank_rows(kind), device=device)
    if kind == "steps":
        return amplitude * rows
    return scale_noise(rows, amplitude)
