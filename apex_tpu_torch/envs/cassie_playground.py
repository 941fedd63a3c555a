"""CassiePlayground: mission (waypoint command) following, as a fleet.

Port of `apex_tpu/envs/cassie_playground.py` (reference
cassie/cassie_playground.py): the env walks a mission's command schedule
(speed, heading and position per 30 Hz step, `envs/trajectory.py`
CommandTrajectory); the observation is the 46-dim robot state in the
commanded-heading frame and [sin, cos, speed] of the clock (49 dims); the
reward is command_reward's speed, position and heading tracking
(rewards/command_reward.py:51-123); an episode ends on the pelvis height
or on reward < 0.3 (:330-339).

Every state field is batch-last, and the fleet may mix missions: with
`mission` a tuple of names, env b follows mission b % len(mission), each
with its own command table (padded to the longest) and its own schedule
length. Upstream quirks kept as the JAX env keeps them:

- the heading frame subtracts the pelvis quaternion's y component, not
  its yaw, from the commanded heading (`_obs`);
- the command counter wraps one row before the table's end and adds the
  table's last position to `last_position`;
- the observation is not sanitized and the estimator is exact (no
  firmware filter lag).
"""
from __future__ import annotations

import dataclasses
from math import floor
from typing import Tuple

import numpy as np
import torch

from apex_tpu_torch.device import resolve_device
from apex_tpu_torch.envs.base import Env, to_batch_first
from apex_tpu_torch.envs.trajectory import CassieTrajectory, CommandTrajectory
from apex_tpu_torch.physics.cassie_sim import (
    PD_TIERS,
    CassiePhysState,
    NEUTRAL_OFFSET,
    PDCommand,
    cassie_model,
    estimate_state,
    pd_scan,
    static_diag,
)
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.utils.quaternion import (
    euler2quat,
    quat2euler,
    quat_inverse,
    quat_mul,
    quat_rotate,
)

REWARDS = ("command", "command_no_pos", "keepalive")


@dataclasses.dataclass
class PlaygroundState:
    phys: CassiePhysState
    params: PhysParams
    phase: torch.Tensor            # (B,)
    counter: torch.Tensor          # (B,) int32
    command_counter: torch.Tensor  # (B,) int64, row of the command table
    time: torch.Tensor             # (B,) int32
    last_position: torch.Tensor    # (3, B) mission-origin offset
    prev_action: torch.Tensor      # (10, B)


@dataclasses.dataclass
class CassiePlayground(Env):
    simrate: int = 60
    mission: str | Tuple[str, ...] = "default"
    reward: str = "command"        # command | command_no_pos | keepalive
    traj: str = "walking"
    # heightfield model switch (the reference 5k matrix swaps in hfield
    # terrain xmls); per-env tables then flow through params.hfield
    hfield: bool = False
    device: object = None
    pd_tier: str | None = None

    observation_size = 49
    action_size = 10
    mirrored_obs = None
    mirrored_acts = None
    clock_inds = [46, 47]

    def __post_init__(self):
        if self.reward not in REWARDS:
            raise ValueError(f"reward must be one of {REWARDS}, got "
                             f"{self.reward!r}")
        if self.pd_tier not in (None, *PD_TIERS):
            raise ValueError(f"pd_tier must be None or one of {PD_TIERS}, "
                             f"got {self.pd_tier!r}")
        self.device = dev = resolve_device(self.device)
        self.model = cassie_model(enable_hfield=self.hfield)
        self.phaselen = float(floor(len(CassieTrajectory(self.traj))
                                    / self.simrate) - 1)
        self.missions = ((self.mission,) if isinstance(self.mission, str)
                         else tuple(self.mission))
        cmds = [CommandTrajectory(m) for m in self.missions]
        self.trajlens = [c.trajlen for c in cmds]
        T = max(self.trajlens)
        pad = lambda a: np.concatenate(
            [a, np.repeat(a[-1:], T - len(a), axis=0)])
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        # (T, M) and (T, 3, M) tables, padded with each table's last row
        self._cmd_speed = f32(np.stack([pad(c.speed_cmd) for c in cmds], -1))
        self._cmd_orient = f32(np.stack([pad(c.orient) for c in cmds], -1))
        self._cmd_pos = f32(np.stack([pad(c.global_pos) for c in cmds], -1))
        self._last_pos = f32(np.stack([c.global_pos[-1] for c in cmds], -1))
        self._trajlen = torch.as_tensor(self.trajlens, device=dev)
        self._offset = f32(NEUTRAL_OFFSET)[:, None]

    # ------------------------------------------------------------------
    def mission_index(self, batch: int) -> torch.Tensor:
        """(B,) index into `missions` of each env: b % len(missions)."""
        return torch.arange(batch, device=self.device) % len(self.missions)

    def command(self, state: PlaygroundState):
        """The commanded (position (3, B), speed (B,), heading (B,)) at each
        env's command counter, position in the mission's frame."""
        cc = state.command_counter
        mi = self.mission_index(cc.shape[0])
        return (self._cmd_pos[cc, :, mi].T, self._cmd_speed[cc, mi],
                self._cmd_orient[cc, mi])

    def sample_reset_noise(self, generator: torch.Generator, batch: int):
        """The reset is deterministic: its "draws" are the fleet size."""
        return batch

    def sample_step_noise(self, generator: torch.Generator, batch: int):
        return None

    def reset(self, batch: int):
        dev = self.device
        phys = CassiePhysState.standing(batch, dev)
        params = PhysParams.from_model(self.model, batch, dev)
        zi = torch.zeros((batch,), dtype=torch.int32, device=dev)
        last = torch.tensor([0.0, 0.0, 1.0], device=dev)[:, None]
        state = PlaygroundState(
            phys=phys, params=params, phase=torch.zeros((batch,), device=dev),
            counter=zi,
            command_counter=torch.zeros((batch,), dtype=torch.int64,
                                        device=dev),
            time=zi.clone(), last_position=last.expand(3, batch).clone(),
            prev_action=torch.zeros((10, batch), device=dev))
        est = estimate_state(self.model, phys,
                             static_diag(self.model, params, phys,
                                         self.pd_tier))
        return state, self._obs(state, est)

    def _obs(self, state: PlaygroundState, est) -> torch.Tensor:
        """(B, 49): the robot state rotated into the commanded-heading frame
        (reference cassie_playground.py:578-585) and the clock and speed
        command. The heading subtracts the pelvis quaternion's y component,
        not its yaw: the reference's quirk, kept so that commanded rotation
        means what it does there."""
        _, speed, orient = self.command(state)
        phase_frac = 2.0 * np.pi * state.phase / self.phaselen
        ext = torch.stack([torch.sin(phase_frac), torch.cos(phase_frac),
                           speed])
        orient_add = orient - est.pelvis_orientation[2]
        z = torch.zeros_like(orient_add)
        iq = quat_inverse(euler2quat(z=orient_add, y=z, x=z))
        robot = torch.cat([
            (est.pelvis_position[2] - est.terrain_height)[None],
            quat_mul(iq, est.pelvis_orientation), est.motor_position,
            quat_rotate(iq, est.pelvis_trans_vel), est.pelvis_rot_vel,
            est.motor_velocity, quat_rotate(iq, est.pelvis_trans_accel),
            est.joint_position, est.joint_velocity])
        return torch.cat([robot, ext]).T

    def step(self, state: PlaygroundState, action: torch.Tensor, noise=None):
        m = self.model
        act = action.T
        cmd = PDCommand.from_targets(act + self._offset)
        phys, diag_seq, _, _ = pd_scan(m, state.params, state.phys, cmd,
                                       self.simrate, self.pd_tier)
        est = estimate_state(m, phys, type(diag_seq)(*(x[-1]
                                                       for x in diag_seq)))

        phase = state.phase + 1.0
        wrapped = phase > self.phaselen
        counter = state.counter + wrapped.to(torch.int32)
        phase = torch.where(wrapped, 0.0, phase)

        # the counter wraps one row before the table's end, carrying the
        # mission's end position into the origin offset
        B = phase.shape[0]
        mi = self.mission_index(B)
        cc = state.command_counter + 1
        cc_wrap = cc >= self._trajlen[mi] - 1
        last_position = torch.where(cc_wrap, state.last_position
                                    + self._last_pos[:, mi],
                                    state.last_position)
        cc = torch.where(cc_wrap, 0, cc)

        new_state = PlaygroundState(
            phys=phys, params=state.params, phase=phase, counter=counter,
            command_counter=cc, time=state.time + 1,
            last_position=last_position, prev_action=act)
        reward = self._reward(new_state)
        height = phys.qpos[2]
        terminated = ~((height > 0.4) & (height < 3.0)) | (reward < 0.3)
        return new_state, self._obs(new_state, est), reward, terminated

    def _reward(self, state: PlaygroundState) -> torch.Tensor:
        """command_reward (rewards/command_reward.py:51-123)."""
        qpos, qvel = state.phys.qpos, state.phys.qvel
        curr_orient = quat2euler(qpos[3:7])[2]
        pos, speed, orient = self.command(state)
        compos_error = torch.linalg.vector_norm(
            qpos[0:3] - (pos + state.last_position), dim=0)
        speed_error = torch.abs(qvel[0] - speed)
        orient_error = torch.abs(curr_orient - orient)
        if self.reward == "command_no_pos":
            return 0.5 * torch.exp(-speed_error) + 0.5 * torch.exp(
                -orient_error)
        if self.reward == "keepalive":
            return torch.ones_like(speed_error)
        return (0.2 * torch.exp(-speed_error) + 0.3 * torch.exp(-compos_error)
                + 0.5 * torch.exp(-orient_error))

    def checkpoint_leaves(self, state: PlaygroundState, obs: torch.Tensor):
        """The JAX PlaygroundState's leaves (envs/cassie_playground.py:44),
        batch-first."""
        return [to_batch_first(x) for x in (
            state.phys.qpos, state.phys.qvel, state.phys.qacc,
            *(getattr(state.params, f.name)
              for f in dataclasses.fields(state.params)),
            state.phase, state.counter,
            state.command_counter.to(torch.int32), state.time,
            state.last_position, state.prev_action)]
