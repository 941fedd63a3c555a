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

import dataclasses
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.device import resolve_device


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

    def reset_fresh(self, noise) -> Tuple[Any, torch.Tensor]:
        """The reset of a fresh fleet (`init_runner`). JAX compiles it as
        a program of its own, and an env whose reset that program computes
        otherwise than the auto-reset overrides this."""
        return self.reset(noise)

    def step(self, state, action: torch.Tensor, noise
             ) -> Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def checkpoint_leaves(self, state, obs: torch.Tensor) -> List[np.ndarray]:
        """The leaves of the JAX package's (batch-first) env state for this
        fleet state, in its flattening order, as a checkpoint stores them."""
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


def to_batch_first(x: torch.Tensor) -> np.ndarray:
    """A batch-last tensor as the batch-first numpy array JAX stores."""
    return np.array(np.moveaxis(x.detach().cpu().numpy(), -1, 0), order="C")


@dataclasses.dataclass
class PointMassState:
    """Planar double integrator tracking a commanded velocity, batch-last."""
    pos: torch.Tensor   # (2, B)
    vel: torch.Tensor   # (2, B)
    cmd: torch.Tensor   # (2, B)
    t: torch.Tensor     # (B,) int32


class PointMassResetNoise(NamedTuple):
    cmd: torch.Tensor   # (2, B) U[-max_cmd, max_cmd)
    vel: torch.Tensor   # (2, B) N(0, 0.1^2)


class PointMassStepNoise(NamedTuple):
    change: torch.Tensor   # (B,) bool, P = 0.01
    new_cmd: torch.Tensor  # (2, B) U[-max_cmd, max_cmd)


class PointMassEnv(Env):
    """Port of `apex_tpu.envs.base.PointMassEnv`: the small control env
    that validates the training stack on the CPU. Obs [vel(2), cmd(2)];
    action: acceleration (2), clipped to [-1, 1]; reward exp(-|vel - cmd|)
    minus a small action penalty; mirror symmetry flips y."""

    observation_size = 4
    action_size = 2
    mirrored_obs = [0.1, -1, 2, -3]
    mirrored_acts = [0.1, -1]
    clock_inds = None

    def __init__(self, dt: float = 0.05, max_cmd: float = 1.0, device=None):
        self.dt = dt
        self.max_cmd = max_cmd
        self.device = resolve_device(device)

    def _uniform(self, generator, shape):
        return -self.max_cmd + 2.0 * self.max_cmd * torch.rand(
            shape, generator=generator, device=self.device)

    def sample_reset_noise(self, generator: torch.Generator,
                           batch: int) -> PointMassResetNoise:
        return PointMassResetNoise(
            cmd=self._uniform(generator, (2, batch)),
            vel=0.1 * torch.randn((2, batch), generator=generator,
                                  device=self.device))

    def sample_step_noise(self, generator: torch.Generator,
                          batch: int) -> PointMassStepNoise:
        return PointMassStepNoise(
            change=torch.rand((batch,), generator=generator,
                              device=self.device) < 0.01,
            new_cmd=self._uniform(generator, (2, batch)))

    def reset(self, noise: PointMassResetNoise):
        B = noise.cmd.shape[-1]
        state = PointMassState(
            pos=torch.zeros((2, B), device=self.device), vel=noise.vel,
            cmd=noise.cmd,
            t=torch.zeros((B,), dtype=torch.int32, device=self.device))
        return state, self._obs(state)

    def _obs(self, state: PointMassState) -> torch.Tensor:
        return torch.cat([state.vel, state.cmd]).T

    def step(self, state: PointMassState, action: torch.Tensor,
             noise: PointMassStepNoise):
        act = torch.clamp(action.T, -1.0, 1.0)
        vel = state.vel + self.dt * act
        pos = state.pos + self.dt * vel
        cmd = torch.where(noise.change, noise.new_cmd, state.cmd)
        state = PointMassState(pos=pos, vel=vel, cmd=cmd, t=state.t + 1)
        err = vel - cmd
        reward = (torch.exp(-torch.sqrt(torch.sum(err * err, dim=0)))
                  - 0.01 * torch.sum(act ** 2, dim=0))
        terminated = torch.sqrt(torch.sum(vel * vel, dim=0)) > 10.0
        return state, self._obs(state), reward, terminated

    def checkpoint_leaves(self, state: PointMassState,
                          obs: torch.Tensor) -> List[np.ndarray]:
        return [to_batch_first(x)
                for x in (state.pos, state.vel, state.cmd, state.t)]

    def state_from_checkpoint_leaves(self, leaves) -> PointMassState:
        """The inverse of `checkpoint_leaves`."""
        return PointMassState(*(torch.as_tensor(np.asarray(x).T.copy(),
                                                device=self.device)
                                for x in leaves))
