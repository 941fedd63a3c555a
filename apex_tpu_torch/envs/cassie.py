"""CassieEnv: the 40 Hz bipedal-locomotion environment, default config.

Port of `apex_tpu/envs/cassie.py` for the configuration the main path runs
(Cassie-v0 with its defaults, as `curves/cassie_mk4_hardened_ckpt` was
trained): clock commands, full observations, dynamics randomization, the
firmware-estimator lag, the early_clock reward and flat ground. Any other
configuration raises NotImplementedError.

The env is a fleet: every state field is batch-last (rows, B), the
physics runs through the PD scan of `physics/cassie_sim.py` (K1 or the
batch-last fleet step), and randomness enters as explicit draws
(`ResetNoise`, `StepNoise`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import resolve_device
from apex_tpu_torch.envs.base import Env, to_batch_first
from apex_tpu_torch.physics.cassie_sim import (
    PD_TIERS,
    CassiePhysState,
    CassieStateOut,
    NEUTRAL_OFFSET,
    PDCommand,
    cassie_model,
    estimate_state,
    pd_scan,
    static_diag,
)
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.rewards.clock import (
    GaitClock,
    RewardInputs,
    STANCE_ZERO,
    build_clock,
    early_clock_reward,
    speed_to_durations,
)
from apex_tpu_torch.utils.quaternion import (
    euler2quat,
    quat_inverse,
    quat_mul,
    quat_rotate,
)

# global flat foot orientation (reference cassie.py:121)
NEUTRAL_FOOT_ORIENT = np.array(
    [-0.24790886454547323, -0.24679713195445646, -0.6609396704367185,
     0.663921021343526])

# mirror index tables (reference cassie.py:244-255 full, :64-69 actions)
MIRROR_OBS_FULL = [
    0.1, 1, -2, 3, -4, -10, -11, 12, 13, 14, -5, -6, 7, 8, 9, 15, -16, 17,
    -18, 19, -20, -26, -27, 28, 29, 30, -21, -22, 23, 24, 25, 31, -32, 33,
    37, 38, 39, 34, 35, 36, 43, 44, 45, 40, 41, 42]
MIRROR_ACTS = [-5, -6, 7, 8, 9, -0.1, -1, 2, 3, 4]

# dyn-rand dof-damping scaling mask (reference cassie.py:571-596: pelvis,
# heel-spring and plantar-rod dofs keep default damping)
_DAMP_SCALED = np.ones(32, dtype=bool)
_DAMP_SCALED[0:6] = False          # pelvis
_DAMP_SCALED[15] = False           # left heel spring
_DAMP_SCALED[17] = False           # left plantar rod
_DAMP_SCALED[28] = False           # right heel spring
_DAMP_SCALED[30] = False           # right plantar rod


@dataclasses.dataclass
class CassieEnvState:
    """Fleet state, batch-last. The JAX state's remaining fields
    (obs_history, prev_action, prev_torque, the swing-apex flags,
    phase_add) feed only configurations the port does not run."""
    phys: CassiePhysState
    params: PhysParams
    clock: GaitClock
    phase: torch.Tensor             # (B,)
    counter: torch.Tensor           # (B,) int32
    time: torch.Tensor              # (B,) int32
    speed: torch.Tensor             # (B,)
    side_speed: torch.Tensor        # (B,)
    orient_add: torch.Tensor        # (B,)
    swing_duration: torch.Tensor    # (B,)
    stance_duration: torch.Tensor   # (B,)
    stance_mode: torch.Tensor       # (3, B) one-hot [grounded, aerial, zero]
    motor_enc_noise: torch.Tensor   # (10, B)
    joint_enc_noise: torch.Tensor   # (6, B)


class ResetNoise(NamedTuple):
    """The random draws of one fleet reset (envs/cassie.py reset and
    _sample_params), already scaled to their ranges."""
    speed: torch.Tensor        # (B,)
    side_speed: torch.Tensor   # (B,)
    phase_u: torch.Tensor      # (B,) U[0, 1), scaled by the clock length
    damp_scale: torch.Tensor   # (nv, B)
    mass_scale: torch.Tensor   # (nbody, B)
    friction: torch.Tensor     # (B,)
    roll: torch.Tensor         # (B,) floor incline
    pitch: torch.Tensor        # (B,)
    motor_enc: torch.Tensor    # (10, B) encoder offsets
    joint_enc: torch.Tensor    # (6, B)


class StepNoise(NamedTuple):
    """The random command changes of one fleet step (cassie.py:483-491)."""
    orient_hit: torch.Tensor   # (B,) bool, P = 1/300
    orient_delta: torch.Tensor  # (B,)
    speed_hit: torch.Tensor    # (B,) bool, P = 1/100
    new_speed: torch.Tensor    # (B,)
    side_hit: torch.Tensor     # (B,) bool, P = 1/300
    new_side: torch.Tensor     # (B,)


@dataclasses.dataclass
class CassieEnv(Env):
    """Static config mirrors `apex_tpu.envs.cassie.CassieEnv`; only the
    defaults are implemented."""
    simrate: int = 50
    command_profile: str = "clock"
    input_profile: str = "full"
    dynamics_randomization: bool = True
    learn_gains: bool = False
    reward: str = "early_clock"
    history: int = 0
    estimator: str = "firmware"
    estimator_tau: float = 0.012
    estimator_noise: float = 0.0
    terrain: str = "flat"
    max_speed: float = 4.0
    min_speed: float = -0.3
    max_side_speed: float = 0.3
    min_side_speed: float = -0.3
    max_orient_change: float = 0.2
    orient_jump_prob: float = 0.0
    speed_phase_add: bool = False
    # dynamics randomization ranges (cassie.py:149-161)
    damping_low: float = 0.3
    damping_high: float = 5.0
    mass_low: float = 0.5
    mass_high: float = 1.5
    fric_low: float = 0.4
    fric_high: float = 1.1
    max_pitch_incline: float = 0.03
    max_roll_incline: float = 0.03
    encoder_noise: float = 0.01
    strict_relaxer: float = 0.1          # cassie.py:92
    device: object = None
    # physics tier of the PD scan: "megakernel" (K1), "fleet", or None for
    # the device's default (megakernel on CUDA, fleet on the CPU)
    pd_tier: str | None = None

    def __post_init__(self):
        unsupported = {
            k: getattr(self, k) for k, v in (
                ("command_profile", "clock"), ("input_profile", "full"),
                ("dynamics_randomization", True), ("learn_gains", False),
                ("reward", "early_clock"), ("history", 0),
                ("estimator", "firmware"), ("estimator_noise", 0.0),
                ("terrain", "flat"), ("orient_jump_prob", 0.0),
                ("speed_phase_add", False))
            if getattr(self, k) != v}
        if unsupported:
            raise NotImplementedError(
                "apex_tpu_torch ports the default Cassie-v0 configuration "
                "only (clock commands, full observations, dyn-rand, "
                "firmware estimator without noise, early_clock reward, flat "
                f"ground); not yet: {unsupported}")
        if self.pd_tier not in (None, *PD_TIERS):
            raise ValueError(f"pd_tier must be None or one of {PD_TIERS}, "
                             f"got {self.pd_tier!r}")
        self.device = resolve_device(self.device)
        self.model = cassie_model()
        self.observation_size = 46 + 4
        self.action_size = 10
        self.mirrored_acts = MIRROR_ACTS
        self.mirrored_obs = list(MIRROR_OBS_FULL) + list(range(46, 50))
        self.clock_inds = [46, 47]
        self._freq = 2000 // self.simrate
        dev = self.device
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        self._offset = f32(NEUTRAL_OFFSET)[:, None]
        self._neutral_foot = f32(NEUTRAL_FOOT_ORIENT)[:, None]
        self._damp_scaled = torch.as_tensor(_DAMP_SCALED, device=dev)[:, None]
        self._stance_mode = f32(STANCE_ZERO)[:, None]
        # firmware-estimator filter: e_t = a e_{t-1} + (1 - a) v_t per
        # substep, in closed form over the simrate substeps
        # (envs/cassie.py:575-581)
        a = float(np.exp(-self.model.timestep / self.estimator_tau))
        L = self.simrate
        self._ema_decay = a ** L
        self._w_ema = f32((1.0 - a) * a ** np.arange(L - 1, -1, -1.0))

    # ------------------------------------------------------------------
    def sample_reset_noise(self, generator: torch.Generator,
                           batch: int) -> ResetNoise:
        m, dev = self.model, self.device
        u = lambda *shape, lo=0.0, hi=1.0: lo + (hi - lo) * torch.rand(
            shape + (batch,), generator=generator, device=dev)
        return ResetNoise(
            speed=u(lo=self.min_speed, hi=self.max_speed),
            side_speed=u(lo=self.min_side_speed, hi=self.max_side_speed),
            phase_u=u(),
            damp_scale=u(m.nv, lo=self.damping_low, hi=self.damping_high),
            mass_scale=u(m.nbody, lo=self.mass_low, hi=self.mass_high),
            friction=u(lo=self.fric_low, hi=self.fric_high),
            roll=u(lo=-self.max_roll_incline, hi=self.max_roll_incline),
            pitch=u(lo=-self.max_pitch_incline, hi=self.max_pitch_incline),
            motor_enc=u(10, lo=-self.encoder_noise, hi=self.encoder_noise),
            joint_enc=u(6, lo=-self.encoder_noise, hi=self.encoder_noise))

    def sample_step_noise(self, generator: torch.Generator,
                          batch: int) -> StepNoise:
        dev = self.device
        hit = lambda n: torch.randint(0, n, (batch,), generator=generator,
                                      device=dev) == 0
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(
            (batch,), generator=generator, device=dev)
        return StepNoise(
            orient_hit=hit(300),
            orient_delta=u(-self.max_orient_change, self.max_orient_change),
            speed_hit=hit(100),
            new_speed=u(self.min_speed, self.max_speed),
            side_hit=hit(300),
            new_side=u(self.min_side_speed, self.max_side_speed))

    # ------------------------------------------------------------------
    def _sample_params(self, noise: ResetNoise):
        """Dynamics randomization (reference reset, cassie.py:567-657)."""
        B = noise.speed.shape[-1]
        default = PhysParams.from_model(self.model, B, self.device)
        damping = torch.where(self._damp_scaled,
                              default.dof_damping * noise.damp_scale,
                              default.dof_damping)
        mass = default.body_mass * noise.mass_scale
        floor_quat = euler2quat(z=torch.zeros_like(noise.pitch),
                                y=noise.pitch, x=noise.roll)
        return dataclasses.replace(
            default, body_mass=torch.clamp(mass, min=0.0),
            dof_damping=torch.clamp(damping, min=0.0),
            friction=noise.friction, floor_quat=floor_quat)

    def reset(self, noise: ResetNoise):
        B = noise.speed.shape[-1]
        dev = self.device
        swing, stance = speed_to_durations(noise.speed)
        mode = self._stance_mode.expand(3, B)
        clock = build_clock(swing, stance, mode, self.strict_relaxer,
                            True, float(self._freq))
        # random starting phase (cassie.py:561)
        phase = torch.floor(noise.phase_u * torch.floor(clock.phaselen + 1.0))
        phys = CassiePhysState.standing(B, dev)
        params = self._sample_params(noise)
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        state = CassieEnvState(
            phys=phys, params=params, clock=clock, phase=phase,
            counter=zi, time=zi.clone(), speed=noise.speed,
            side_speed=noise.side_speed,
            orient_add=torch.zeros((B,), device=dev),
            swing_duration=swing, stance_duration=stance,
            stance_mode=mode.contiguous(), motor_enc_noise=noise.motor_enc,
            joint_enc_noise=noise.joint_enc)
        # populate the estimator from FK (the reference reset ends with
        # one step_pd to refresh cassie_state, cassie.py:665)
        est = estimate_state(self.model, phys,
                             static_diag(self.model, params, phys))
        return state, self._build_obs(state, est)

    # ------------------------------------------------------------------
    def step(self, state: CassieEnvState, action: torch.Tensor,
             noise: StepNoise):
        m = self.model
        act = action.T                                    # (10, B)
        target = act + self._offset - state.motor_enc_noise
        cmd = PDCommand.from_targets(target)

        phys, diag_seq, qvel_seq, qacc_seq = pd_scan(
            m, state.params, state.phys, cmd, self.simrate, self.pd_tier)

        # firmware-estimator EMA in closed form:
        # e_L = a^L e_0 + (1-a) sum_t a^(L-1-t) v_t
        ema_v = (self._ema_decay * state.phys.qvel
                 + torch.tensordot(self._w_ema, qvel_seq, dims=1))
        ema_a = (self._ema_decay * state.phys.qacc
                 + torch.tensordot(self._w_ema, qacc_seq, dims=1))

        # position-difference foot velocities (reference cassie.py:330-331);
        # the first substep's previous foot position is the FK of the
        # pre-step state (StepOut.kin is the input-qpos FK)
        prev_foot0 = static_diag(m, state.params, state.phys).foot_pos
        prev_pos_seq = torch.cat([prev_foot0[None], diag_seq.foot_pos[:-1]])
        foot_vel_seq = (diag_seq.foot_pos - prev_pos_seq) / m.timestep

        fq = diag_seq.foot_quat                           # (L, 2, 4, B)
        orient = 1.0 - torch.sum(fq * self._neutral_foot, dim=2) ** 2
        l_orient_cost, r_orient_cost = orient.mean(dim=0)  # (B,) each
        l_foot_frc, r_foot_frc = diag_seq.foot_frc_z.mean(dim=0)

        # phase advance (cassie.py:447-453)
        time_ = state.time + 1
        phase = state.phase + 1.0
        wrapped = phase > state.clock.phaselen
        counter = state.counter + wrapped.to(torch.int32)
        phase = torch.where(wrapped, 0.0, phase)

        # reward (compute_reward, cassie.py:770-785), on the firmware
        # estimator's filtered velocities
        est = estimate_state(
            m, dataclasses.replace(phys, qvel=ema_v, qacc=ema_a),
            _last_substep(diag_seq))
        ri = RewardInputs(
            qpos=phys.qpos, qvel=phys.qvel,
            l_foot_frc=l_foot_frc, r_foot_frc=r_foot_frc,
            l_foot_vel=foot_vel_seq[-1, 0], r_foot_vel=foot_vel_seq[-1, 1],
            l_foot_orient_cost=l_orient_cost,
            r_foot_orient_cost=r_orient_cost,
            speed=state.speed, phase=phase)
        reward = early_clock_reward(state.clock, ri)

        # termination (cassie.py:462-465) and the finite-state guard
        height = phys.qpos[2]
        terminated = ((height < 0.4) | (height > 3.0)
                      | ~torch.isfinite(phys.qpos).all(dim=0)
                      | ~torch.isfinite(phys.qvel).all(dim=0))
        reward = torch.where(torch.isfinite(reward), reward, 0.0)

        # random command changes (cassie.py:483-491)
        orient_add = state.orient_add + torch.where(
            noise.orient_hit, noise.orient_delta, 0.0)
        speed = torch.where(
            noise.speed_hit,
            torch.clamp(noise.new_speed, self.min_speed, self.max_speed),
            state.speed)
        side_speed = torch.where(noise.side_hit, noise.new_side,
                                 state.side_speed)

        new_state = dataclasses.replace(
            state, phys=phys, phase=phase, counter=counter, time=time_,
            speed=speed, side_speed=side_speed, orient_add=orient_add)
        return new_state, self._build_obs(new_state, est), reward, terminated

    def checkpoint_leaves(self, state: CassieEnvState,
                          obs: torch.Tensor):
        """The JAX CassieEnvState's leaves (envs/cassie.py:120-145), batch-
        first. The fields the port does not carry hold what the default
        configuration leaves in them: zero previous action and torque, the
        current observation as the one-frame history, no swing-apex flags,
        a phase increment of 1."""
        B = obs.shape[0]
        fields = [state.phys.qpos, state.phys.qvel, state.phys.qacc,
                  *(getattr(state.params, f.name)
                    for f in dataclasses.fields(state.params)),
                  *(getattr(state.clock, f.name)
                    for f in dataclasses.fields(state.clock)),
                  state.phase, state.counter, state.time, state.speed,
                  state.side_speed, state.orient_add, state.swing_duration,
                  state.stance_duration, state.stance_mode,
                  state.motor_enc_noise, state.joint_enc_noise]
        return [to_batch_first(x) for x in fields] + [
            np.zeros((B, 10), np.float32), np.zeros((B, 10), np.float32),
            obs.detach().cpu().numpy()[:, None, :].astype(np.float32),
            np.zeros(B, bool), np.zeros(B, bool), np.ones(B, np.float32)]

    # ------------------------------------------------------------------
    def _rotate_to_orient(self, orient_add: torch.Tensor, vec: torch.Tensor):
        """reference rotate_to_orient (cassie.py:280-291)."""
        z = torch.zeros_like(orient_add)
        iq = quat_inverse(euler2quat(z=orient_add, y=z, x=z))
        if vec.shape[0] == 3:
            return quat_rotate(iq, vec)
        out = quat_mul(iq, vec)
        return torch.where(out[0:1] < 0, -out, out)

    def _build_obs(self, state: CassieEnvState,
                   est: CassieStateOut) -> torch.Tensor:
        """get_full_state (cassie.py:787-859), full profile with the clock
        command appendix -> (B, 50)."""
        phase_frac = 2.0 * np.pi * state.phase / state.clock.phaselen
        ext = torch.stack([torch.sin(phase_frac), torch.cos(phase_frac),
                           state.speed, state.side_speed])
        robot = torch.cat([
            (est.pelvis_position[2] - est.terrain_height)[None],
            self._rotate_to_orient(state.orient_add, est.pelvis_orientation),
            est.motor_position + state.motor_enc_noise,
            self._rotate_to_orient(state.orient_add, est.pelvis_trans_vel),
            est.pelvis_rot_vel,
            est.motor_velocity,
            self._rotate_to_orient(state.orient_add, est.pelvis_trans_accel),
            est.joint_position + state.joint_enc_noise,
            est.joint_velocity])
        base = torch.cat([robot, ext])
        # a physics blow-up NaNs the estimator outputs one step before the
        # termination guards fire; a NaN frame would poison the obs
        # normalizer, so sanitize at the single obs chokepoint
        base = torch.where(torch.isfinite(base), base, 0.0)
        return base.T


def _last_substep(diag_seq):
    """The last substep's diagnostics of a (L, ...) sequence."""
    return type(diag_seq)(*(x[-1] for x in diag_seq))
