"""Walker2d: the planar 7-body walker on the fleet or the per-env tier.

Port of `apex_tpu/envs/walker2d.py`. Classic gym semantics: obs =
[qpos[1:], clip(qvel, +-10)] (17), reward = forward velocity + alive bonus
- 1e-3 |a|^2, termination when the torso height leaves [0.8, 2.0], |pitch|
> 1 or the state is not finite. A step is `frame_skip` = 4 substeps of
the model's own 0.002 s, as `engine.step` under vmap is in the JAX
package: by default through the batch-last fleet step (`fleet_step`: K2
for the kinematics, K3 for (M + hD)^-1), its default route; with
`pd_tier="per_env"` through the per-env engine (`engine.step`: K3's
batch-first route for (M + hD)^-1), its route under APEX_TPU_NO_FLEET=1.
The action is the actuators' control, clamped to [-1, 1] by the step.
Resets draw from the generator and launch no kernel; steps draw nothing.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import const, resolve_device
from apex_tpu_torch.envs.base import Env, to_batch_first
from apex_tpu_torch.physics import engine
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.physics.fleet import fleet_step
from apex_tpu_torch.physics.models.walker2d import make_model


@functools.lru_cache(maxsize=None)
def walker_model():
    return make_model()


@dataclasses.dataclass
class WalkerState:
    """Batch-last generalized coordinates of the fleet."""
    qpos: torch.Tensor   # (nq, B)
    qvel: torch.Tensor   # (nv, B)


class WalkerResetNoise(NamedTuple):
    qpos: torch.Tensor   # (nq, B) U[-1, 1)
    qvel: torch.Tensor   # (nv, B) U[-1, 1)


class Walker2dEnv(Env):
    """Port of `apex_tpu.envs.walker2d.Walker2dEnv` on a fleet."""

    frame_skip = 4
    ctrl_cost = 1e-3
    alive_bonus = 1.0
    reset_noise = 5e-3

    observation_size = 17
    action_size = 6
    # mirror: swap left/right legs (obs layout: [z, pitch, 3 left joints,
    # 3 right joints, vx, vz, vpitch, 3 left jvel, 3 right jvel]); 0.1
    # stands for "index 0, negated" (mirror_matrix)
    mirrored_obs = [0.1, 1, 5, 6, 7, 2, 3, 4, 8, 9, 10, 14, 15, 16, 11, 12,
                    13]
    mirrored_acts = [3, 4, 5, 0.1, 1, 2]
    clock_inds = None

    PD_TIERS = ("fleet", "per_env")

    def __init__(self, device=None, pd_tier: str | None = None):
        if pd_tier not in (None, *self.PD_TIERS):
            raise ValueError(f"Walker2d: pd_tier must be None or one of "
                             f"{self.PD_TIERS}, got {pd_tier!r}")
        self.device = resolve_device(device)
        self.model = walker_model()
        self.pd_tier = pd_tier or "fleet"
        self._params: Dict[int, PhysParams] = {}

    def params(self, batch: int) -> PhysParams:
        """The model's parameters for a fleet of `batch` envs, built once
        per fleet size (no env randomizes them): batch-last for the fleet
        tier, batch-first for the per-env tier."""
        p = self._params.get(batch)
        if p is None:
            p = PhysParams.from_model(self.model, batch, self.device)
            if self.pd_tier == "per_env":
                p = engine.params_batch_first(p)
            self._params[batch] = p
        return p

    def sample_reset_noise(self, generator: torch.Generator,
                           batch: int) -> WalkerResetNoise:
        u = lambda n: 2.0 * torch.rand((n, batch), generator=generator,
                                       device=self.device) - 1.0
        return WalkerResetNoise(qpos=u(self.model.nq), qvel=u(self.model.nv))

    def sample_step_noise(self, generator: torch.Generator, batch: int):
        return None

    def reset(self, noise: WalkerResetNoise):
        qpos0 = const(self.model.qpos0, self.device)[:, None]
        qpos = qpos0 + self.reset_noise * noise.qpos
        qvel = self.reset_noise * noise.qvel
        return WalkerState(qpos=qpos, qvel=qvel), self._obs(qpos, qvel)

    @staticmethod
    def _obs(qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
        return torch.cat([qpos[1:], torch.clamp(qvel, -10.0, 10.0)]).T

    def step(self, state: WalkerState, action: torch.Tensor, noise=None):
        m = self.model
        params = self.params(action.shape[0])
        if self.pd_tier == "per_env":
            qpos, qvel = state.qpos.T, state.qvel.T
            for _ in range(self.frame_skip):
                out = engine.step(m, params, qpos, qvel, action)
                qpos, qvel = out.qpos, out.qvel
            qpos, qvel = qpos.T.contiguous(), qvel.T.contiguous()
        else:
            ctrl = action.T.contiguous()
            qpos, qvel = state.qpos, state.qvel
            for _ in range(self.frame_skip):
                _, _, qpos, qvel, _, _ = fleet_step(m, params, qpos, qvel,
                                                    ctrl)

        dt = m.timestep * self.frame_skip
        forward_vel = (qpos[0] - state.qpos[0]) / dt
        reward = (forward_vel + self.alive_bonus
                  - self.ctrl_cost * torch.sum(torch.square(action), dim=1))
        # a non-finite reward in a replay ring would poison every update
        # that samples it
        reward = torch.where(torch.isfinite(reward), reward, 0.0)
        height, pitch = qpos[1], qpos[2]
        # NaN passes the range checks (its comparisons are False)
        bad = ~(torch.isfinite(qpos).all(dim=0)
                & torch.isfinite(qvel).all(dim=0))
        terminated = ((height < 0.8) | (height > 2.0)
                      | (torch.abs(pitch) > 1.0) | bad)
        new = WalkerState(qpos=qpos, qvel=qvel)
        return new, self._obs(qpos, qvel), reward, terminated

    def checkpoint_leaves(self, state: WalkerState,
                          obs: torch.Tensor) -> List[np.ndarray]:
        """JAX's batch-first `WalkerState(qpos, qvel)`."""
        return [to_batch_first(state.qpos), to_batch_first(state.qvel)]

    def state_from_checkpoint_leaves(self, leaves) -> WalkerState:
        """The inverse of `checkpoint_leaves`."""
        qpos, qvel = (torch.as_tensor(np.asarray(x).T.copy(),
                                      device=self.device) for x in leaves)
        return WalkerState(qpos=qpos, qvel=qvel)
