"""Environment protocol and mirror tables.

Port of `apex_tpu/envs/base.py`. A port env is a static object over an
explicit, batch-last state; its randomness enters as explicit draws, so a
test can hand the same numbers to the JAX env and to the port:

    noise             = env.sample_reset_noise(generator, batch)
    state, obs        = env.reset(noise)
    noise             = env.sample_step_noise(generator, batch)
    state, obs, r, term = env.step(state, action, noise)

obs is (B, obs_dim) and action (B, act_dim), batch-first, as the policy
networks take them; reward and termination are (B,).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch


class Env:
    """Static environment description (reference env surface:
    observation/action sizes, signed mirror index lists, clock indices)."""

    observation_size: int
    action_size: int
    mirrored_obs: Optional[Sequence[float]] = None
    mirrored_acts: Optional[Sequence[float]] = None
    clock_inds: Optional[Sequence[int]] = None

    def sample_reset_noise(self, generator: torch.Generator, batch: int):
        raise NotImplementedError

    def sample_step_noise(self, generator: torch.Generator, batch: int):
        raise NotImplementedError

    def reset(self, noise) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def step(self, state, action: torch.Tensor, noise
             ) -> Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]:
        raise NotImplementedError


def mirror_matrix(mirrored: Sequence[float]) -> np.ndarray:
    """Signed permutation matrix from a mirror index list, so that
    mirrored = obs @ M (reference _get_symmetry_matrix,
    rl/envs/wrappers.py:70-77; the -0.1 trick encodes "negate index 0")."""
    n = len(mirrored)
    mat = np.zeros((n, n), dtype=np.float32)
    for i, m in enumerate(mirrored):
        mat[i, int(abs(m))] = np.sign(m)
    return mat.T


def mirror_clock(obs_mirrored: torch.Tensor,
                 clock_inds: Sequence[int]) -> torch.Tensor:
    """Advance the sin/cos clock by half a period after mirroring
    (reference mirror_clock_observation, wrappers.py:59-67)."""
    out = obs_mirrored.clone()
    out[..., list(clock_inds)] *= -1.0
    return out
