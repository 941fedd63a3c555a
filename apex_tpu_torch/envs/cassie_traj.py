"""CassieTrajEnv (CassieTraj-v0): reference-trajectory tracking, as a fleet.

Port of `apex_tpu/envs/cassie_traj.py` (reference cassie/cassie_traj.py):
CassieEnv's physics and observation on top of a reference gait, either
the Agility 2 kHz trajectories ("walking", "stepping") or the 21-speed
ASLIP task-space gait library with its IK-net joint targets
(`envs/trajectory.py`). Episodes start on the reference trajectory at a
random phase. The PD baseline is the neutral offset (`no_delta`), the
reference's next motor positions, or with `ik_baseline` on the aslip
library the IK net's output. Command profiles: clock or phase (as
CassieEnv), or traj, which appends the next-phase reference state (40
Agility entries or the 18-entry aslip task state). Rewards: the iros_paper
tracking reward (also `trajmatch`), the foot-orientation trajmatch,
jonah_RNN, aslip_old on the aslip library, and the clock family.

Every state field is batch-last; randomness enters as explicit draws
(`TrajResetNoise`, `TrajStepNoise`). As in the JAX env, the estimator is
exact, the observation is not sanitized, and the aslip trajectories are
padded to the longest with a per-speed length table.
"""
from __future__ import annotations

import dataclasses
from math import floor
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import const, resolve_device
from apex_tpu_torch.envs.base import Env, to_batch_first
from apex_tpu_torch.envs.cassie import (
    _DAMP_SCALED,
    MIRROR_ACTS,
    MIRROR_ACTS_GAINS,
    MIRROR_OBS_FULL,
    MIRROR_OBS_MIN,
    NEUTRAL_FOOT_ORIENT,
    _last_substep,
    robot_obs,
)
from apex_tpu_torch.envs.trajectory import (
    CassieTrajectory,
    get_all_aslip_trajectories,
)
from apex_tpu_torch.physics.cassie_sim import (
    DEFAULT_D_GAIN,
    DEFAULT_P_GAIN,
    MOTOR_QPOS_IDX,
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
from apex_tpu_torch.rewards.clock import (
    REWARD_FUNCS,
    STANCE_AERIAL,
    STANCE_GROUNDED,
    STANCE_ZERO,
    GaitClock,
    RewardInputs,
    build_clock,
    speed_to_durations,
)
from apex_tpu_torch.utils.quaternion import euler2quat

# obs slices of the reference state (cassie.py:103-104)
POS_INDEX = np.array([1, 2, 3, 4, 5, 6, 7, 8, 9, 14, 15, 16, 20, 21, 22, 23,
                      28, 29, 30, 34])
VEL_INDEX = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 12, 13, 14, 18, 19, 20, 21,
                      25, 26, 27, 31])

# mirrored ref-traj index lists (cassie_traj.py:317-324)
MIRROR_TRAJ_ASLIP = [6, 7, 8, 9, 10, 11, 0.1, 1, 2, 3, 4, 5, 12, 13, 14, 15,
                     16, 17]
MIRROR_TRAJ_AGILITY = [0.1, 1, 2, 3, 4, 5, -13, -14, 15, 16, 17, 18, 19, -6,
                       -7, 8, 9, 10, 11, 12, 20, 21, 22, 23, 24, 25, -33,
                       -34, 35, 36, 37, 38, 39, -26, -27, 28, 29, 30, 31, 32]

# per-motor weights of the tracking rewards' joint error
_JOINT_WEIGHT = [0.15, 0.15, 0.1, 0.05, 0.05, 0.15, 0.15, 0.1, 0.05, 0.05]
_SPRING_IDX = [15, 29]


@dataclasses.dataclass
class CassieTrajEnvState:
    """Fleet state, batch-last, with the JAX CassieTrajEnvState's fields
    (envs/cassie_traj.py:82-105): the gait clock's arrays apart (zeros
    but for the clock and phase profiles), phaselen the clock's or the
    trajectory's."""
    phys: CassiePhysState
    params: PhysParams
    clock: torch.Tensor             # (24, B) knots
    clock_y: torch.Tensor           # (4, 24, B)
    clock_d: torch.Tensor           # (4, 24, B)
    phaselen: torch.Tensor          # (B,)
    phase: torch.Tensor             # (B,)
    counter: torch.Tensor           # (B,) int32
    time: torch.Tensor              # (B,) int32
    simsteps: torch.Tensor          # (B,) int32
    traj_idx: torch.Tensor          # (B,) int64 aslip speed (0 for Agility)
    speed: torch.Tensor             # (B,)
    side_speed: torch.Tensor        # (B,)
    orient_add: torch.Tensor        # (B,)
    swing_duration: torch.Tensor    # (B,)
    stance_duration: torch.Tensor   # (B,)
    stance_mode: torch.Tensor       # (3, B)
    motor_enc_noise: torch.Tensor   # (10, B)
    joint_enc_noise: torch.Tensor   # (6, B)
    prev_action: torch.Tensor       # (action_size, B)
    prev_torque: torch.Tensor       # (10, B)
    obs_history: torch.Tensor       # (history + 1, base_obs, B)


class TrajResetNoise(NamedTuple):
    """The random draws of one fleet reset (envs/cassie_traj.py:322-343,
    _sample_params :288-318)."""
    speed_idx: torch.Tensor    # (B,) int64: aslip speed, or speed x 10
    side_speed: torch.Tensor   # (B,)
    phase_u: torch.Tensor      # (B,) U[0, 1)
    damp_scale: torch.Tensor   # (nv, B)
    mass_scale: torch.Tensor   # (nbody, B)
    friction: torch.Tensor     # (B,)
    roll: torch.Tensor         # (B,)
    pitch: torch.Tensor        # (B,)
    motor_enc: torch.Tensor    # (10, B)
    joint_enc: torch.Tensor    # (6, B)
    # the phase command profile's gait (envs/cassie_traj.py:276-281)
    swing: torch.Tensor = None
    stance: torch.Tensor = None
    mode: torch.Tensor = None


class TrajStepNoise(NamedTuple):
    """The heading change of one fleet step (envs/cassie_traj.py:449-453)."""
    orient_hit: torch.Tensor   # (B,) bool, P = 1/300
    orient_delta: torch.Tensor  # (B,)


@dataclasses.dataclass
class CassieTrajEnv(Env):
    """Static config mirrors `apex_tpu.envs.cassie_traj.CassieTrajEnv`."""
    traj: str = "walking"                # walking | stepping | aslip
    simrate: int = 50
    command_profile: str = "clock"       # clock | phase | traj
    input_profile: str = "full"
    dynamics_randomization: bool = True
    learn_gains: bool = False
    reward: str = "iros_paper"
    no_delta: bool = True
    ik_baseline: bool = False
    history: int = 0
    max_speed: float = 4.0
    min_speed: float = -0.3
    max_side_speed: float = 0.3
    min_side_speed: float = -0.3
    max_orient_change: float = 0.2
    damping_low: float = 0.3
    damping_high: float = 5.0
    mass_low: float = 0.5
    mass_high: float = 1.5
    fric_low: float = 0.4
    fric_high: float = 1.1
    max_pitch_incline: float = 0.03
    max_roll_incline: float = 0.03
    encoder_noise: float = 0.01
    strict_relaxer: float = 0.1
    device: object = None
    pd_tier: str | None = None

    def __post_init__(self):
        if self.pd_tier not in (None, *PD_TIERS):
            raise ValueError(f"pd_tier must be None or one of {PD_TIERS}, "
                             f"got {self.pd_tier!r}")
        self.device = dev = resolve_device(self.device)
        self.model = cassie_model()
        self.aslip = self.traj == "aslip"
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        if self.aslip:
            trajs = get_all_aslip_trajectories()
            self.num_speeds = len(trajs)
            maxlen = max(t.length for t in trajs)

            def pad(arrs):
                # (speeds, maxlen, ...) padded with each cycle's last row
                out = np.zeros((len(trajs), maxlen) + arrs[0].shape[1:],
                               np.float32)
                for i, a in enumerate(arrs):
                    out[i, :len(a)] = a
                    out[i, len(a):] = a[-1]
                return f32(out)

            self._traj_qpos = pad([t.qpos for t in trajs])
            self._traj_ik = pad([t.ik_pos for t in trajs])
            self._task = {k: pad([getattr(t, k) for t in trajs])
                          for k in ("rpos", "rvel", "lpos", "lvel", "cpos",
                                    "cvel")}
            self._traj_len = torch.as_tensor([t.length for t in trajs],
                                             device=dev)
            self._traj_x_span = f32([t.qpos[-1, 0] - t.qpos[0, 0]
                                     for t in trajs])
            self._speeds = f32([0.1 * i for i in range(21)])
        else:
            trajectory = CassieTrajectory(self.traj)
            self._traj_qpos = f32(trajectory.qpos)
            self._traj_qvel = f32(trajectory.qvel)
            self._x_span = float(trajectory.qpos[-1, 0]
                                 - trajectory.qpos[0, 0])
            self._agility_phaselen = float(
                floor(len(trajectory) / self.simrate) - 1)

        base = 46 if self.input_profile == "full" else 21
        if self.command_profile == "clock":
            ext = 4
        elif self.command_profile == "phase":
            ext = 9
        else:
            ext = 18 if self.aslip else 40
        self._base_obs = base + ext
        self.observation_size = self._base_obs * (1 + self.history)
        self.action_size = 30 if self.learn_gains else 10
        self.mirrored_acts = (MIRROR_ACTS_GAINS if self.learn_gains
                              else MIRROR_ACTS)
        base_mir = (MIRROR_OBS_FULL if self.input_profile == "full"
                    else MIRROR_OBS_MIN)
        if self.command_profile in ("clock", "phase"):
            self.mirrored_obs = list(base_mir) + list(
                range(len(base_mir), self._base_obs))
            self.clock_inds = [len(base_mir), len(base_mir) + 1]
        else:
            # signed ref-traj mirror with offset (cassie_traj.py:325-327)
            mt = MIRROR_TRAJ_ASLIP if self.aslip else MIRROR_TRAJ_AGILITY
            self.mirrored_obs = list(base_mir) + [
                np.sign(m) * (base + np.floor(abs(m))) for m in mt]
            self.clock_inds = None

        # reward dispatch (envs/cassie_traj.py:186-214); trajmatch is
        # iros_paper with an overwritten preamble
        self.have_incentive = "no_incentive" not in self.reward
        self._iros = self.reward in ("iros_paper", "trajmatch",
                                     "trajmatch_reward")
        self._trajmatch_fo = self.reward in (
            "trajmatch_footorient_hiprollvelact",
            "trajmatch_footorient_hiprollvelact_reward")
        self._jonah = self.reward in ("jonah_RNN", "jonah_RNN_reward")
        key = next((k for k in ("early", "no_speed", "max_vel")
                    if k in self.reward), None)
        self._clock_reward = REWARD_FUNCS[
            "clock" if key is None else f"{key}_clock"]
        stance = (STANCE_GROUNDED if "grounded" in self.reward else
                  STANCE_AERIAL if "aerial" in self.reward else STANCE_ZERO)
        self._stance_mode = f32(stance)[:, None]
        if self._iros or self._trajmatch_fo or self._jonah:
            self._early_term_cutoff = 0.3    # cassie_traj.py:59
        elif self.reward == "aslip_old":
            self._early_term_cutoff = 0.0    # cassie_traj.py:912
        else:
            self._early_term_cutoff = -99.0

        self._freq = 2000 // self.simrate
        self._offset = f32(NEUTRAL_OFFSET)[:, None]
        self._p_gain = f32(DEFAULT_P_GAIN)[:, None]
        self._d_gain = f32(DEFAULT_D_GAIN)[:, None]
        self._neutral_foot = f32(NEUTRAL_FOOT_ORIENT)[:, None]
        self._damp_scaled = torch.as_tensor(_DAMP_SCALED, device=dev)[:, None]
        self._motor_idx = const(MOTOR_QPOS_IDX, dev, torch.int64)

    # ------------------------------------------------------------------
    def sample_reset_noise(self, generator: torch.Generator,
                           batch: int) -> TrajResetNoise:
        m, dev = self.model, self.device
        u = lambda *shape, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(
            shape + (batch,), generator=generator, device=dev)
        randint = lambda lo, hi: torch.randint(
            lo, hi, (batch,), generator=generator, device=dev)
        noise = TrajResetNoise(
            speed_idx=randint(0, self.num_speeds if self.aslip else 41),
            side_speed=u(lo=self.min_side_speed, hi=self.max_side_speed),
            phase_u=u(),
            damp_scale=u(m.nv, lo=self.damping_low, hi=self.damping_high),
            mass_scale=u(m.nbody, lo=self.mass_low, hi=self.mass_high),
            friction=u(lo=self.fric_low, hi=self.fric_high),
            roll=u(lo=-self.max_roll_incline, hi=self.max_roll_incline),
            pitch=u(lo=-self.max_pitch_incline, hi=self.max_pitch_incline),
            motor_enc=u(10, lo=-self.encoder_noise, hi=self.encoder_noise),
            joint_enc=u(6, lo=-self.encoder_noise, hi=self.encoder_noise))
        if self.command_profile == "phase":
            noise = noise._replace(swing=randint(1, 51) / 100.0,
                                   stance=randint(1, 31) / 100.0,
                                   mode=randint(0, 3))
        return noise

    def sample_step_noise(self, generator: torch.Generator,
                          batch: int) -> TrajStepNoise:
        dev = self.device
        hit = torch.randint(0, 300, (batch,), generator=generator,
                            device=dev) == 0
        delta = -self.max_orient_change + 2 * self.max_orient_change * \
            torch.rand((batch,), generator=generator, device=dev)
        return TrajStepNoise(orient_hit=hit, orient_delta=delta)

    # ------------------------------------------------------------------
    def get_ref_state(self, state: CassieTrajEnvState, phase: torch.Tensor):
        """(ref qpos (35, B), ref qvel (32, B)) at a phase (B,)
        (cassie_traj.py:926-972): the trajectory's row, its x advanced by
        the cycles completed, y zeroed; the Agility trajectory's x scaled
        by the commanded speed; the aslip library stores no velocities."""
        phase = torch.where(phase > state.phaselen, 0.0, phase)
        if self.aslip:
            t, idx = self._aslip_row(state, phase)
            pos = self._traj_qpos[t, idx].T.clone()
            pos[0] = pos[0] + self._traj_x_span[t] * state.counter
            pos[1] = 0.0
            return pos, torch.zeros((32,) + phase.shape, device=phase.device)
        idx = (phase * self.simrate).to(torch.int64).clamp(
            0, self._traj_qpos.shape[0] - 1)
        pos = self._traj_qpos[idx].T.clone()
        pos[0] = pos[0] * state.speed
        pos[0] = pos[0] + (self._x_span * state.counter.to(torch.float32)
                           * state.speed)
        pos[1] = 0.0
        vel = self._traj_qvel[idx].T.clone()
        vel[0] = vel[0] * state.speed
        return pos, vel

    def _sample_params(self, noise: TrajResetNoise):
        """Dynamics randomization (envs/cassie_traj.py:288-318): the body
        masses scaled without CassieEnv's clamp at 0."""
        B = noise.side_speed.shape[-1]
        params = PhysParams.from_model(self.model, B, self.device)
        if not self.dynamics_randomization:
            return (params, torch.zeros_like(noise.motor_enc),
                    torch.zeros_like(noise.joint_enc))
        damping = torch.where(self._damp_scaled,
                              params.dof_damping * noise.damp_scale,
                              params.dof_damping)
        params = dataclasses.replace(
            params, body_mass=params.body_mass * noise.mass_scale,
            dof_damping=torch.clamp(damping, min=0.0),
            friction=noise.friction,
            floor_quat=euler2quat(z=torch.zeros_like(noise.pitch),
                                  y=noise.pitch, x=noise.roll))
        return params, noise.motor_enc, noise.joint_enc

    def reset_fresh(self, noise: TrajResetNoise):
        return self.reset(noise, fresh_fleet=True)

    def reset(self, noise: TrajResetNoise, fresh_fleet: bool = False):
        """The auto-reset's arithmetic, or with `fresh_fleet` that of JAX's
        `init_runner` program (`speed_to_durations`)."""
        B, dev = noise.side_speed.shape[-1], self.device
        if self.aslip:
            traj_idx = noise.speed_idx
            speed = self._speeds[traj_idx]
            phaselen = (self._traj_len[traj_idx] - 1).to(torch.float32)
        else:
            traj_idx = torch.zeros((B,), dtype=torch.int64, device=dev)
            # randint(0, 41) / 10.0, which XLA compiles as randint * 0.1f
            # (one ulp from the quotient at some speeds)
            speed = noise.speed_idx.to(torch.float32) * 0.1
            phaselen = torch.full((B,), self._agility_phaselen, device=dev)
        if self.command_profile == "phase":
            swing, stance = noise.swing, noise.stance
            mode = torch.nn.functional.one_hot(noise.mode, 3).T.to(
                swing.dtype)
        else:
            swing, stance = speed_to_durations(speed, fresh_fleet)
            mode = self._stance_mode.expand(3, B)
        clock = build_clock(swing, stance, mode, self.strict_relaxer,
                            self.have_incentive, float(self._freq))
        if self.command_profile in ("clock", "phase"):
            phaselen = clock.phaselen
        phase = torch.floor(noise.phase_u * torch.floor(phaselen + 1.0))
        params, menc, jenc = self._sample_params(noise)
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        state = CassieTrajEnvState(
            phys=None, params=params, clock=clock.x, clock_y=clock.y,
            clock_d=clock.d, phaselen=phaselen, phase=phase, counter=zi,
            time=zi.clone(), simsteps=zi.clone(), traj_idx=traj_idx,
            speed=speed, side_speed=noise.side_speed,
            orient_add=torch.zeros((B,), device=dev),
            swing_duration=swing, stance_duration=stance,
            stance_mode=mode.contiguous(), motor_enc_noise=menc,
            joint_enc_noise=jenc,
            prev_action=torch.zeros((self.action_size, B), device=dev),
            prev_torque=torch.zeros((10, B), device=dev),
            obs_history=torch.zeros((self.history + 1, self._base_obs, B),
                                    device=dev))
        # reset onto the reference trajectory (cassie_traj.py:750-760)
        ref_pos, ref_vel = self.get_ref_state(state, phase)
        phys = CassiePhysState(qpos=ref_pos.contiguous(),
                               qvel=ref_vel.contiguous(),
                               qacc=torch.zeros((32, B), device=dev))
        state = dataclasses.replace(state, phys=phys)
        est = estimate_state(self.model, phys,
                             static_diag(self.model, params, phys,
                                         self.pd_tier))
        return self._observe(state, est)

    # ------------------------------------------------------------------
    def step(self, state: CassieTrajEnvState, action: torch.Tensor,
             noise: TrajStepNoise):
        return self._step(state, action, noise, with_info=False)[:4]

    def step_info(self, state: CassieTrajEnvState, action: torch.Tensor,
                  noise: TrajStepNoise):
        """`step`, and the JAX step's info diagnostics for the analysis
        tools (envs/cassie_traj.py:456-466): (state, obs, reward,
        terminated, info), info's entries batch-last, grf_seq (simrate, 2,
        B)."""
        return self._step(state, action, noise, with_info=True)

    def _step(self, state: CassieTrajEnvState, action: torch.Tensor,
              noise: TrajStepNoise, with_info: bool):
        m = self.model
        act = action.T                                    # (action_size, B)
        # PD baseline: neutral offset, reference motors (delta mode), or
        # the IK output (cassie_traj.py:346-357)
        if self.ik_baseline and self.aslip:
            t, idx = self._aslip_row(state, state.phase)
            offset = self._traj_ik[t, idx].T[self._motor_idx]
        elif self.no_delta:
            offset = self._offset
        else:
            next_ref_pos, _ = self.get_ref_state(state, state.phase + 1.0)
            offset = next_ref_pos[self._motor_idx]
        target = act[:10] + offset - state.motor_enc_noise
        if self.learn_gains:
            cmd = PDCommand.from_targets(target, self._p_gain + act[10:20],
                                         self._d_gain + act[20:30])
        else:
            cmd = PDCommand.from_targets(target)
        phys, diag_seq, qvel_seq, _ = pd_scan(
            m, state.params, state.phys, cmd, self.simrate, self.pd_tier)
        diag_last = _last_substep(diag_seq)
        # the first substep's previous foot position: FK of the pre-step
        # state (one K2 launch on the megakernel tier)
        prev_foot0 = static_diag(m, state.params, state.phys,
                                 self.pd_tier).foot_pos
        prev_pos_seq = torch.cat([prev_foot0[None], diag_seq.foot_pos[:-1]])
        foot_vel_seq = (diag_seq.foot_pos - prev_pos_seq) / m.timestep
        orient = (1.0 - torch.sum(diag_seq.foot_quat * self._neutral_foot,
                                  dim=2) ** 2).mean(dim=0)      # (2, B)
        hiproll_cost = ((torch.abs(qvel_seq[:, 6])
                         + torch.abs(qvel_seq[:, 19])) / 3.0).mean(dim=0)

        phase = state.phase + 1.0
        wrapped = phase > state.phaselen
        new_state = dataclasses.replace(
            state, phys=phys, phase=torch.where(wrapped, 0.0, phase),
            counter=state.counter + wrapped.to(torch.int32),
            time=state.time + 1, simsteps=state.simsteps + self.simrate)

        est = estimate_state(m, phys, diag_last)
        first = state.time == 0
        prev_action = torch.where(first, act, state.prev_action)
        prev_torque = torch.where(first, diag_last.motor_torque,
                                  state.prev_torque)
        if self.reward == "aslip_old" and self.aslip:
            reward = self._aslip_old_reward(
                new_state, est, act[:10], prev_action[:10],
                orient[0] + orient[1])
        elif self._iros:
            reward = self._iros_reward(new_state)
        elif self._trajmatch_fo:
            hiproll_act = 2.0 * torch.linalg.vector_norm(
                prev_action[[0, 5]] - act[[0, 5]], dim=0)
            reward = self._trajmatch_footorient_reward(
                new_state, orient[0], orient[1], hiproll_cost, hiproll_act)
        elif self._jonah:
            reward = self._jonah_rnn_reward(new_state)
        else:
            clock = GaitClock(x=state.clock, y=state.clock_y,
                              d=state.clock_d, phaselen=state.phaselen)
            frc = diag_seq.foot_frc_z.mean(dim=0)
            ri = RewardInputs(
                qpos=phys.qpos, qvel=phys.qvel,
                l_foot_frc=frc[0], r_foot_frc=frc[1],
                l_foot_vel=foot_vel_seq[-1, 0],
                r_foot_vel=foot_vel_seq[-1, 1],
                l_foot_orient_cost=orient[0], r_foot_orient_cost=orient[1],
                speed=state.speed, phase=new_state.phase,
                pelvis_rot_vel=est.pelvis_rot_vel,
                pelvis_accel=est.pelvis_trans_accel,
                motor_torque=diag_last.motor_torque, prev_torque=prev_torque,
                action=act[:10], prev_action=prev_action[:10])
            reward = self._clock_reward(clock, ri)

        height = phys.qpos[2]
        terminated = ((height < 0.4) | (height > 3.0)
                      | (reward < self._early_term_cutoff))
        # random heading changes (as CassieEnv's)
        orient_add = state.orient_add + torch.where(
            noise.orient_hit, noise.orient_delta, 0.0)
        new_state = dataclasses.replace(
            new_state, orient_add=orient_add, prev_action=act,
            prev_torque=diag_last.motor_torque)
        new_state, obs = self._observe(new_state, est)
        info = None
        if with_info:
            info = {"grf_seq": diag_seq.foot_frc_z,
                    "foot_pos": diag_last.foot_pos,
                    "est_lfoot_pos": est.left_foot_position,
                    "est_rfoot_pos": est.right_foot_position,
                    "qpos": phys.qpos}
        return new_state, obs, reward, terminated, info

    # ------------------------------------------------------------------
    def _tracking_errors(self, state: CassieTrajEnvState, joint_scale: float):
        """(joint, com, spring) errors of qpos against the reference at
        the state's phase: the weighted squared motor error times
        joint_scale, the squared pelvis position error, 1000x the squared
        spring error; and the (ref, qpos) pair."""
        qpos = state.phys.qpos
        ref_pos, _ = self.get_ref_state(state, state.phase)
        mi, dev = self._motor_idx, qpos.device
        w = const(_JOINT_WEIGHT, dev)[:, None]
        joint = torch.sum(joint_scale * w * (ref_pos[mi] - qpos[mi]) ** 2,
                          dim=0)
        com = torch.sum((ref_pos[0:3] - qpos[0:3]) ** 2, dim=0)
        si = const(_SPRING_IDX, dev, torch.int64)
        spring = torch.sum(1000.0 * (ref_pos[si] - qpos[si]) ** 2, dim=0)
        return joint, com, spring, ref_pos, qpos

    def _iros_reward(self, state: CassieTrajEnvState) -> torch.Tensor:
        """iros_paper_reward (rewards/iros_paper_reward.py:3-59)."""
        joint, com, spring, ref_pos, qpos = self._tracking_errors(state, 30.0)
        orient = torch.sum((ref_pos[4:7] - qpos[4:7]) ** 2, dim=0)
        return (0.5 * torch.exp(-joint) + 0.3 * torch.exp(-com)
                + 0.1 * torch.exp(-orient) + 0.1 * torch.exp(-spring))

    def _trajmatch_footorient_reward(self, state, l_orient, r_orient,
                                     hiproll_cost, hiproll_act):
        """trajmatch_footorient_hiprollvelact_reward
        (rewards/trajmatch_reward.py:77-151): the iros tracking terms at
        0.3/0.2/0.1/0.1 plus foot-orient and hip-roll vel/act terms."""
        joint, com, spring, ref_pos, qpos = self._tracking_errors(state, 30.0)
        orient = torch.sum((ref_pos[4:7] - qpos[4:7]) ** 2, dim=0)
        return (0.3 * torch.exp(-joint) + 0.2 * torch.exp(-com)
                + 0.1 * torch.exp(-orient) + 0.1 * torch.exp(-spring)
                + 0.075 * torch.exp(-l_orient) + 0.075 * torch.exp(-r_orient)
                + 0.1 * torch.exp(-hiproll_cost)
                + 0.05 * torch.exp(-hiproll_act))

    def _jonah_rnn_reward(self, state) -> torch.Tensor:
        """jonah_RNN_reward (rewards/rnn_dyn_random_reward.py:3-50):
        joint 50x, com 10x, quaternion inner-product orientation 5x."""
        joint, _, spring, ref_pos, qpos = self._tracking_errors(state, 50.0)
        com = torch.sum(10.0 * (ref_pos[0:3] - qpos[0:3]) ** 2, dim=0)
        orient = 5.0 * (1.0 - torch.sum(qpos[3:7] * ref_pos[3:7],
                                        dim=0) ** 2)
        return (0.200 * torch.exp(-joint) + 0.450 * torch.exp(-com)
                + 0.300 * torch.exp(-orient) + 0.050 * torch.exp(-spring))

    def _aslip_row(self, state: CassieTrajEnvState, phase: torch.Tensor):
        """(speed index, row) of the aslip library at a phase."""
        t = state.traj_idx
        return t, torch.minimum(phase.to(torch.int64),
                                self._traj_len[t] - 1).clamp(min=0)

    def _aslip_old_reward(self, state, est, action, prev_action,
                          foot_orient_cost):
        """aslip_old_reward (rewards/aslip_rewards.py:5-69): task-space foot
        and com-velocity tracking against the gait library."""
        p = torch.where(state.phase > state.phaselen, 0.0, state.phase)
        t, idx = self._aslip_row(state, p)
        ref = lambda k: self._task[k][t, idx].T
        footpos_error = (
            torch.sum(torch.abs(est.left_foot_position - ref("lpos")), dim=0)
            + torch.sum(torch.abs(est.right_foot_position - ref("rpos")),
                        dim=0))
        com_vel_error = torch.sum(torch.abs(est.pelvis_trans_vel
                                            - ref("cvel")), dim=0)
        action_penalty = torch.linalg.vector_norm(action - prev_action, dim=0)
        straight_diff = torch.abs(state.phys.qpos[1])
        straight_diff = torch.where(straight_diff < 0.05, 0.0, straight_diff)
        return (0.3 * torch.exp(-footpos_error)
                + 0.3 * torch.exp(-com_vel_error)
                + 0.1 * torch.exp(-action_penalty)
                + 0.2 * torch.exp(-foot_orient_cost)
                + 0.1 * torch.exp(-straight_diff))

    # ------------------------------------------------------------------
    def _observe(self, state: CassieTrajEnvState, est):
        """The observation pushed onto the state's history (the JAX
        env's _build_obs): (state, obs (B, observation_size))."""
        phase_frac = 2.0 * np.pi * state.phase / state.phaselen
        clock = [torch.sin(phase_frac), torch.cos(phase_frac)]
        if self.command_profile == "phase":
            ext = torch.stack([*clock, state.swing_duration,
                               state.stance_duration, *state.stance_mode,
                               state.speed, state.side_speed])
        elif self.command_profile == "clock":
            ext = torch.stack([*clock, state.speed, state.side_speed])
        elif self.aslip:
            # the 18-entry aslip task state (aslip_trajectory.py:139-160)
            p = torch.where(state.phase == 0, state.phaselen - 1.0,
                            state.phase)
            t, idx = self._aslip_row(state, p)
            ext = torch.cat([self._task[k][t, idx].T for k in (
                "rpos", "rvel", "lpos", "lvel", "cpos", "cvel")])
        else:
            ref_pos, ref_vel = self.get_ref_state(state, state.phase + 1.0)
            ext = torch.cat([ref_pos[const(POS_INDEX, ref_pos.device,
                                           torch.int64)],
                             ref_vel[const(VEL_INDEX, ref_vel.device,
                                           torch.int64)]])
        profile = "min" if self.input_profile == "min" else "full"
        base = torch.cat([robot_obs(profile, state, est), ext])
        hist = torch.cat([base[None], state.obs_history[:-1]])
        obs = hist.reshape(-1, base.shape[-1]).T
        return dataclasses.replace(state, obs_history=hist), obs

    def checkpoint_leaves(self, state: CassieTrajEnvState,
                          obs: torch.Tensor):
        """The JAX CassieTrajEnvState's leaves (envs/cassie_traj.py:83),
        batch-first."""
        fields = [state.phys.qpos, state.phys.qvel, state.phys.qacc,
                  *(getattr(state.params, f.name)
                    for f in dataclasses.fields(state.params)),
                  state.clock, state.clock_y, state.clock_d, state.phaselen,
                  state.phase, state.counter, state.time, state.simsteps,
                  state.traj_idx.to(torch.int32), state.speed,
                  state.side_speed, state.orient_add, state.swing_duration,
                  state.stance_duration, state.stance_mode,
                  state.motor_enc_noise, state.joint_enc_noise,
                  state.prev_action, state.prev_torque, state.obs_history]
        return [to_batch_first(x) for x in fields]
