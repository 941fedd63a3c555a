"""CassieStandingEnv (CassieStanding-v0): standing and balance, as a fleet.

Port of `apex_tpu/envs/cassie_standing.py` (reference
cassie/cassie_standing_env.py): the 46-entry state-estimator observation;
a capture-point, pose and COM-velocity reward with a penalty for losing
ground contact (:142-196); resets onto random phases of the stepping
reference trajectory (:129-139); termination on the pelvis height.

Two reference quirks are kept, as the JAX env keeps them:

- the reward's height terms read qpos[1] (the pelvis y), with a floor of
  1e-6 on |qpos[1]| so that the capture-point velocity stays finite;
- the ground-contact test reads the right heel twice, so the right toe
  never counts.

Every state field is batch-last; a reset's only draw is each env's phase
of the trajectory (`StandingResetNoise`), and a step draws nothing.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import resolve_device
from apex_tpu_torch.envs.base import Env, to_batch_first
from apex_tpu_torch.envs.cassie import _last_substep
from apex_tpu_torch.envs.trajectory import CassieTrajectory
from apex_tpu_torch.physics.cassie_sim import (
    NEUTRAL_OFFSET,
    PD_TIERS,
    CassiePhysState,
    PDCommand,
    cassie_model,
    estimate_state,
    pd_scan,
    static_diag,
)
from apex_tpu_torch.physics.engine import PhysParams


@dataclasses.dataclass
class StandingState:
    phys: CassiePhysState
    phase: torch.Tensor      # (B,)
    counter: torch.Tensor    # (B,) int32
    time: torch.Tensor       # (B,) int32


class StandingResetNoise(NamedTuple):
    phase: torch.Tensor      # (B,) int64 in [0, phaselen]


@dataclasses.dataclass
class CassieStandingEnv(Env):
    simrate: int = 60
    traj: str = "stepping"
    device: object = None
    pd_tier: str | None = None

    observation_size = 46
    action_size = 10
    mirrored_obs = None
    mirrored_acts = None
    clock_inds = None

    def __post_init__(self):
        if self.pd_tier not in (None, *PD_TIERS):
            raise ValueError(f"pd_tier must be None or one of {PD_TIERS}, "
                             f"got {self.pd_tier!r}")
        self.device = dev = resolve_device(self.device)
        self.model = cassie_model()
        trajectory = CassieTrajectory(self.traj)
        self.phaselen = int(np.floor(len(trajectory) / self.simrate)) - 1
        # reset states at each phase (reference get_ref_state, :198-210:
        # qpos with y zeroed, qvel as recorded)
        idx = np.arange(self.phaselen + 1) * self.simrate
        qpos = trajectory.qpos[idx].copy()
        qpos[:, 1] = 0.0
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self._ref_qpos = f32(qpos)
        self._ref_qvel = f32(trajectory.qvel[idx])
        self._offset = f32(NEUTRAL_OFFSET)[:, None]
        self._params = {}

    def params(self, batch: int) -> PhysParams:
        """The model's default parameters for a fleet of `batch` envs (the
        JAX env's static params)."""
        if batch not in self._params:
            self._params[batch] = PhysParams.from_model(self.model, batch,
                                                        self.device)
        return self._params[batch]

    def sample_reset_noise(self, generator: torch.Generator,
                           batch: int) -> StandingResetNoise:
        return StandingResetNoise(torch.randint(
            0, self.phaselen + 1, (batch,), generator=generator,
            device=self.device))

    def sample_step_noise(self, generator: torch.Generator, batch: int):
        return None

    def reset(self, noise: StandingResetNoise):
        B = noise.phase.shape[0]
        phys = CassiePhysState(
            qpos=self._ref_qpos[noise.phase].T.contiguous(),
            qvel=self._ref_qvel[noise.phase].T.contiguous(),
            qacc=torch.zeros((32, B), device=self.device))
        zi = torch.zeros((B,), dtype=torch.int32, device=self.device)
        state = StandingState(phys=phys, phase=noise.phase.to(torch.float32),
                              counter=zi, time=zi.clone())
        est = estimate_state(self.model, phys,
                             static_diag(self.model, self.params(B), phys,
                                         self.pd_tier))
        return state, self._obs(est)

    def _obs(self, est) -> torch.Tensor:
        """The 46-entry robot state (reference get_full_state, :274-287),
        (B, 46)."""
        return torch.cat([
            (est.pelvis_position[2] - est.terrain_height)[None],
            est.pelvis_orientation, est.motor_position,
            est.pelvis_trans_vel, est.pelvis_rot_vel, est.motor_velocity,
            est.pelvis_trans_accel, est.joint_position,
            est.joint_velocity]).T

    def step(self, state: StandingState, action: torch.Tensor, noise=None):
        m = self.model
        cmd = PDCommand.from_targets(action.T + self._offset)
        phys, diag_seq, _, _ = pd_scan(
            m, self.params(action.shape[0]), state.phys, cmd, self.simrate,
            self.pd_tier)
        diag = _last_substep(diag_seq)
        est = estimate_state(m, phys, diag)
        reward = self._reward(phys, est, diag)
        phase = state.phase + 1.0
        wrapped = phase > self.phaselen
        height = phys.qpos[2]
        terminated = ~((height > 0.4) & (height < 3.0))
        new_state = StandingState(
            phys=phys, phase=torch.where(wrapped, 0.0, phase),
            counter=state.counter + wrapped.to(torch.int32),
            time=state.time + 1)
        return new_state, self._obs(est), reward, terminated

    def _reward(self, phys, est, diag) -> torch.Tensor:
        """compute_reward (:142-196)."""
        qpos, qvel = phys.qpos, phys.qvel
        lf, rf = est.left_foot_position, est.right_foot_position
        # upper body pose modulation
        r_pose = 0.25 * (torch.exp(-qpos[6] ** 2) + torch.exp(-qpos[8] ** 2)
                         + torch.exp(-qpos[13] ** 2)
                         + torch.exp(-qpos[15] ** 2))
        # capture point
        cp_pos = torch.sqrt(
            0.5 * (torch.abs(lf[0]) + torch.abs(rf[0])) ** 2
            + 0.5 * (torch.abs(lf[1]) + torch.abs(rf[1])) ** 2)
        xy_com_pos = torch.exp(-cp_pos ** 2)
        z_com_pos = torch.exp(-(qpos[1] - 0.9) ** 2)   # qpos[1]: the quirk
        r_com_pos = 0.5 * xy_com_pos + 0.5 * z_com_pos
        cp_vel = cp_pos * torch.sqrt(
            9.8 / torch.clamp(torch.abs(qpos[1]), min=1e-6))
        xy_com_vel = torch.exp(
            -(cp_vel - torch.sqrt(qvel[0] ** 2 + qvel[1] ** 2)) ** 2)
        z_com_vel = torch.exp(-qvel[2] ** 2)

        norm = lambda v: torch.sqrt(torch.sum(v * v, dim=0))
        thf = diag.toe_heel_force                    # (2, 2, 3, B)
        l_heel, l_toe, r_heel = norm(thf[0, 1]), norm(thf[0, 0]), norm(
            thf[1, 1])
        # the right toe is unused: the reference reads the right heel twice
        any_light = (l_heel < 5) | (l_toe < 5) | (r_heel < 5)
        r_com_vel = torch.where(any_light, z_com_vel,
                                0.5 * xy_com_vel + 0.5 * z_com_vel)
        reward = 0.33 * r_pose + 0.33 * r_com_pos + 0.34 * r_com_vel
        all_light = (l_heel < 5) & (l_toe < 5) & (r_heel < 5)
        return torch.where(all_light, reward - 0.5, reward)

    def checkpoint_leaves(self, state: StandingState, obs: torch.Tensor):
        """The JAX StandingState's leaves (envs/cassie_standing.py:40-45),
        batch-first."""
        return [to_batch_first(x) for x in (
            state.phys.qpos, state.phys.qvel, state.phys.qacc, state.phase,
            state.counter, state.time)]
