"""CassieEnv: the 40 Hz bipedal-locomotion environment.

Port of `apex_tpu/envs/cassie.py` with every switch of the JAX env: clock
or phase commands; the full, min and research input profiles (footdist,
noaccel_footdist, novel_footdist, noaccel_footdist_nojoint) with their
mirror tables; the firmware estimator (filter lag, optional measurement
noise) or the exact one; dynamics randomization on or off; learned PD
gains (30-wide actions); an observation history; the omniscient
appendix; the heading curriculum (`orient_jump_prob`) and
`speed_phase_add`; any simrate; the clock rewards with their name
modifiers (`rewards/clock.py`), the precomputed `load_<name>` clocks and
the speedmatch family (`rewards/speedmatch.py`); flat ground or
heightfield terrain ("noise", "hill", "steps": the JAX env's terrain bank,
drawn per episode).

The env is a fleet: every state field is batch-last (rows, B), the
physics runs through the PD scan of `physics/cassie_sim.py` (K1 or the
batch-last fleet step), and randomness enters as explicit draws
(`ResetNoise`, `StepNoise`); a switch's draws are taken only when it is
on, so the draws of every other configuration stay as they were. Beside
reset and step, the entry points of the eval suites
(`runtime/eval_suites.py`): the deterministic `reset_for_test`,
`update_speed_state` and `step_basic`, and the state's per-env phase
increment `phase_add`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import const, resolve_device
from apex_tpu_torch.envs.base import Env, to_batch_first
from apex_tpu_torch.physics.cassie_sim import (
    DEFAULT_D_GAIN,
    DEFAULT_P_GAIN,
    MOTOR_QPOS_IDX,
    MOTOR_QVEL_IDX,
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
    REWARD_FUNCS,
    GaitClock,
    RewardInputs,
    STANCE_AERIAL,
    STANCE_GROUNDED,
    STANCE_ZERO,
    build_clock,
    load_reward_clock,
    speed_to_durations,
)
from apex_tpu_torch.rewards.speedmatch import (
    SPEEDMATCH_FUNCS,
    SpeedmatchInputs,
)
from apex_tpu_torch.utils.quaternion import (
    euler2quat,
    quat_inverse,
    quat_mul,
    quat_rotate,
)
from apex_tpu_torch.utils.terrain import terrain_bank

# global flat foot orientation (reference cassie.py:121)
NEUTRAL_FOOT_ORIENT = np.array(
    [-0.24790886454547323, -0.24679713195445646, -0.6609396704367185,
     0.663921021343526])

# mirror index tables (reference cassie.py:244-255 full, :248-255 min,
# :64-69 actions)
MIRROR_OBS_FULL = [
    0.1, 1, -2, 3, -4, -10, -11, 12, 13, 14, -5, -6, 7, 8, 9, 15, -16, 17,
    -18, 19, -20, -26, -27, 28, 29, 30, -21, -22, 23, 24, 25, 31, -32, 33,
    37, 38, 39, 34, 35, 36, 43, 44, 45, 40, 41, 42]
MIRROR_OBS_MIN = [
    3, 4, 5, 0.1, 1, 2, 6, -7, 8, -9, -10, 11, -12, 17, -18, 19, -20, 13,
    -14, 15, -16]
MIRROR_ACTS = [-5, -6, 7, 8, 9, -0.1, -1, 2, 3, 4]
MIRROR_ACTS_GAINS = [
    -5, -6, 7, 8, 9, -0.1, -1, 2, 3, 4,
    -15, -16, 17, 18, 19, -10, -11, 12, 13, 14,
    -25, -26, 27, 28, 29, -20, -21, 22, 23, 24]
# research-variant mirror tables (cassie_footdist_env.py:229-231,
# cassie_noaccel_footdist_env.py:259-261)
MIRROR_OBS_FOOTDIST = [
    3, 4, 5, 0.1, 1, 2, 6, -7, 8, -9, -15, -16, 17, 18, 19, -10, -11, 12,
    13, 14, 20, -21, 22, -23, 24, -25, -31, -32, 33, 34, 35, -26, -27, 28,
    29, 30, 36, -37, 38, 42, 43, 44, 39, 40, 41, 48, 49, 50, 45, 46, 47]
MIRROR_OBS_NOACCEL_FOOTDIST = [
    3, 4, 5, 0.1, 1, 2, 6, -7, 8, -9, -15, -16, 17, 18, 19, -10, -11, 12,
    13, 14, 20, -21, 22, -23, 24, -25, -31, -32, 33, 34, 35, -26, -27, 28,
    29, 30, 38, 39, 36, 37, 42, 43, 40, 41]
# cassie_novel_footdist_env.py:261-263 (no pelvis trans vel/accel)
MIRROR_OBS_NOVEL_FOOTDIST = [
    3, 4, 5, 0.1, 1, 2, 6, -7, 8, -9, -15, -16, 17, 18, 19, -10, -11, 12,
    13, 14, -20, 21, -22, -28, -29, 30, 31, 32, -23, -24, 25, 26, 27,
    35, 36, 33, 34, 39, 40, 37, 38]
# cassie_noaccel_footdist_nojoint_env.py:232-233 (no joint pos/vel)
MIRROR_OBS_NOJOINT = [
    3, 4, 5, 0.1, 1, 2, 6, -7, 8, -9, -15, -16, 17, 18, 19, -10, -11, 12,
    13, 14, 20, -21, 22, -23, 24, -25, -31, -32, 33, 34, 35, -26, -27, 28,
    29, 30]
# robot-state mirror table of each input profile; its length is the
# profile's robot-state width (envs/cassie.py:235-237)
MIRROR_OBS = {"full": MIRROR_OBS_FULL, "min": MIRROR_OBS_MIN,
              "footdist": MIRROR_OBS_FOOTDIST,
              "noaccel_footdist": MIRROR_OBS_NOACCEL_FOOTDIST,
              "novel_footdist": MIRROR_OBS_NOVEL_FOOTDIST,
              "noaccel_footdist_nojoint": MIRROR_OBS_NOJOINT}
TERRAINS = ("flat", "noise", "hill", "steps")

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
    """Fleet state, batch-last, with the JAX CassieEnvState's fields."""
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
    prev_action: torch.Tensor       # (10, B) or (30, B) with learn_gains
    prev_torque: torch.Tensor       # (10, B)
    # the last history + 1 observation frames, newest first
    obs_history: torch.Tensor       # (history + 1, base_obs, B)
    # swing-apex flags: set when a foot clears 0.19 m, cleared on contact
    # (reference cassie_footdist_env.py:313-320); the speedmatch rewards
    # update them, the clock rewards leave them False
    l_high: torch.Tensor            # (B,) bool
    r_high: torch.Tensor            # (B,) bool
    # per-step phase increment (envs/cassie.py:145): 1 from a reset; the
    # command suite sets 1.5 above 1.4 m/s, the scripted drive's j/h keys
    # move it by 0.1
    phase_add: torch.Tensor         # (B,)


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
    terrain_idx: torch.Tensor = None   # (B,) int64 table of the bank
    # the phase command profile's gait (envs/cassie.py:361-365)
    swing: torch.Tensor = None         # (B,) randint(1, 51) / 100
    stance: torch.Tensor = None        # (B,) randint(1, 31) / 100
    mode: torch.Tensor = None          # (B,) int64 stance mode, 0-2


class StepNoise(NamedTuple):
    """The random command changes of one fleet step (cassie.py:483-491),
    the heading curriculum's jump (envs/cassie.py:804-811) and the
    firmware estimator's measurement noise (:704-718)."""
    orient_hit: torch.Tensor   # (B,) bool, P = 1/300
    orient_delta: torch.Tensor  # (B,)
    speed_hit: torch.Tensor    # (B,) bool, P = 1/100
    new_speed: torch.Tensor    # (B,)
    side_hit: torch.Tensor     # (B,) bool, P = 1/300
    new_side: torch.Tensor     # (B,)
    jump_size: torch.Tensor = None  # (B,) U(pi/6, pi/3)
    jump_sign: torch.Tensor = None  # (B,) bool, True: +, P = 1/2
    jump_u: torch.Tensor = None     # (B,) U[0, 1), jumps below the prob
    # (22, B) N(0, 1): pelvis translational velocity (3), rotational
    # velocity (3), motor velocities (10), joint velocities (6)
    est_noise: torch.Tensor = None


@dataclasses.dataclass
class CassieEnv(Env):
    """Static config mirrors `apex_tpu.envs.cassie.CassieEnv`."""
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
    terrain_amplitude: float = 0.05
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
    # append the true randomized dynamics parameters (dof damping, body
    # masses, friction) to the observation
    omniscient: bool = False
    device: object = None
    # physics tier of the PD scan: "megakernel" (K1), "fleet", "per_env"
    # (the per-env engine), or None for the device's default (megakernel
    # on CUDA, fleet on the CPU)
    pd_tier: str | None = None

    def __post_init__(self):
        if self.terrain not in TERRAINS:
            raise ValueError(f"unknown terrain {self.terrain}")
        if self.pd_tier not in (None, *PD_TIERS):
            raise ValueError(f"pd_tier must be None or one of {PD_TIERS}, "
                             f"got {self.pd_tier!r}")
        self.device = resolve_device(self.device)
        self.model = cassie_model(enable_hfield=self.terrain != "flat")
        # the JAX env's 64-table terrain bank (envs/cassie.py:209-229)
        self._terrain_bank = (
            None if self.terrain == "flat" else
            terrain_bank(self.terrain, self.terrain_amplitude, self.device))
        # input profiles (envs/cassie.py:230-261): the research variants
        # append [clock, speed], the others the clock or phase command
        base_mir = MIRROR_OBS[self.input_profile]
        self._research_variant = self.input_profile not in ("full", "min")
        if self._research_variant:
            ext = 3
        else:
            ext = 4 if self.command_profile == "clock" else 9
        self._base_obs = len(base_mir) + ext
        if self.omniscient:
            # dof damping (32) + body masses (25) + friction (1)
            self._base_obs += 32 + 25 + 1
        self.observation_size = self._base_obs * (1 + self.history)
        self.action_size = 30 if self.learn_gains else 10
        self.mirrored_acts = (MIRROR_ACTS_GAINS if self.learn_gains
                              else MIRROR_ACTS)
        # the command appendix (and omniscient params) mirror to themselves
        self.mirrored_obs = list(base_mir) + list(
            range(len(base_mir), self._base_obs))
        self.clock_inds = [len(base_mir), len(base_mir) + 1]

        # reward dispatch with its name modifiers (envs/cassie.py:263-300)
        self.have_incentive = "no_incentive" not in self.reward
        self._speedmatch = SPEEDMATCH_FUNCS.get(self.reward)
        key = next((k for k in ("early", "no_speed", "max_vel", "aslip")
                    if k in self.reward), None)
        reward_key = "clock" if key is None else f"{key}_clock"
        stance = (STANCE_GROUNDED if "grounded" in self.reward else
                  STANCE_AERIAL if "aerial" in self.reward else STANCE_ZERO)
        self._switch = "switch" in self.reward   # cassie.py:225-228
        self.switch_speed = 1.8
        # "load_<name>": the precomputed clock of every episode, phaselen
        # 32 (envs/cassie.py:288-300)
        self._loaded_clock = None
        if self.reward.startswith("load_"):
            self._loaded_clock = load_reward_clock(
                self.reward[len("load_"):], 1, self.device, phaselen=32.0)
            reward_key = "clock"
        self._clock_reward = REWARD_FUNCS[reward_key]

        self._freq = 2000 // self.simrate
        dev = self.device
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        self._offset = f32(NEUTRAL_OFFSET)[:, None]
        self._p_gain = f32(DEFAULT_P_GAIN)[:, None]
        self._d_gain = f32(DEFAULT_D_GAIN)[:, None]
        self._neutral_foot = f32(NEUTRAL_FOOT_ORIENT)[:, None]
        self._damp_scaled = torch.as_tensor(_DAMP_SCALED, device=dev)[:, None]
        self._stance_mode = f32(stance)[:, None]
        self._firmware = self.estimator == "firmware"
        self._est_noise = self._firmware and self.estimator_noise > 0.0
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
        randint = lambda lo, hi: torch.randint(
            lo, hi, (batch,), generator=generator, device=dev)
        terrain_idx = None if self._terrain_bank is None else randint(
            0, self._terrain_bank.shape[0])
        noise = ResetNoise(
            speed=u(lo=self.min_speed, hi=self.max_speed),
            side_speed=u(lo=self.min_side_speed, hi=self.max_side_speed),
            phase_u=u(),
            damp_scale=u(m.nv, lo=self.damping_low, hi=self.damping_high),
            mass_scale=u(m.nbody, lo=self.mass_low, hi=self.mass_high),
            friction=u(lo=self.fric_low, hi=self.fric_high),
            roll=u(lo=-self.max_roll_incline, hi=self.max_roll_incline),
            pitch=u(lo=-self.max_pitch_incline, hi=self.max_pitch_incline),
            motor_enc=u(10, lo=-self.encoder_noise, hi=self.encoder_noise),
            joint_enc=u(6, lo=-self.encoder_noise, hi=self.encoder_noise),
            terrain_idx=terrain_idx)
        if self.command_profile == "phase" and self._loaded_clock is None:
            noise = noise._replace(swing=randint(1, 51) / 100.0,
                                   stance=randint(1, 31) / 100.0,
                                   mode=randint(0, 3))
        return noise

    def sample_step_noise(self, generator: torch.Generator,
                          batch: int) -> StepNoise:
        dev = self.device
        hit = lambda n: torch.randint(0, n, (batch,), generator=generator,
                                      device=dev) == 0
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(
            (batch,), generator=generator, device=dev)
        noise = StepNoise(
            orient_hit=hit(300),
            orient_delta=u(-self.max_orient_change, self.max_orient_change),
            speed_hit=hit(100),
            new_speed=u(self.min_speed, self.max_speed),
            side_hit=hit(300),
            new_side=u(self.min_side_speed, self.max_side_speed))
        if self.orient_jump_prob > 0.0:
            noise = noise._replace(jump_size=u(np.pi / 6, np.pi / 3),
                                   jump_sign=u(0.0, 1.0) < 0.5,
                                   jump_u=u(0.0, 1.0))
        if self._est_noise:
            noise = noise._replace(est_noise=torch.randn(
                (22, batch), generator=generator, device=dev))
        return noise

    # ------------------------------------------------------------------
    def _sample_params(self, noise: ResetNoise):
        """Dynamics randomization (reference reset, cassie.py:567-657) and
        the episode's terrain table: (params, motor and joint encoder
        offsets). Without dyn-rand, the default params and no encoder
        offsets (envs/cassie.py:343-344)."""
        B = noise.speed.shape[-1]
        params = PhysParams.from_model(self.model, B, self.device)
        menc, jenc = noise.motor_enc, noise.joint_enc
        if self.dynamics_randomization:
            damping = torch.where(self._damp_scaled,
                                  params.dof_damping * noise.damp_scale,
                                  params.dof_damping)
            mass = params.body_mass * noise.mass_scale
            floor_quat = euler2quat(z=torch.zeros_like(noise.pitch),
                                    y=noise.pitch, x=noise.roll)
            params = dataclasses.replace(
                params, body_mass=torch.clamp(mass, min=0.0),
                dof_damping=torch.clamp(damping, min=0.0),
                friction=noise.friction, floor_quat=floor_quat)
        else:
            menc, jenc = torch.zeros_like(menc), torch.zeros_like(jenc)
        if self._terrain_bank is not None:
            # a table of the bank per env (envs/cassie.py:345-353)
            params = dataclasses.replace(
                params,
                hfield=self._terrain_bank[noise.terrain_idx].permute(
                    1, 2, 0).contiguous(),
                hfield_active=torch.ones_like(params.hfield_active))
        return params, menc, jenc

    def _clock(self, swing, stance, mode, fused: bool = True) -> GaitClock:
        return build_clock(swing, stance, mode, self.strict_relaxer,
                           self.have_incentive, float(self._freq), fused)

    def _make_clock(self, noise: ResetNoise, fresh_fleet: bool = False):
        """The episode's gait clock (envs/cassie.py:356-375): the loaded
        clock, the phase profile's drawn gait, or the commanded speed's
        with the reward's stance mode (with "switch", grounded below 1.8
        m/s and aerial above); `fresh_fleet` as `speed_to_durations`
        takes it. Returns (clock, swing, stance, mode)."""
        B = noise.speed.shape[-1]
        if self._loaded_clock is not None:
            swing, stance = speed_to_durations(noise.speed, fresh_fleet)
            return (self._loaded(B), swing, stance,
                    self._stance_mode.expand(3, B))
        if self.command_profile == "phase":
            swing, stance = noise.swing, noise.stance
            mode = torch.nn.functional.one_hot(noise.mode, 3).T.to(
                swing.dtype)
        else:
            swing, stance = speed_to_durations(noise.speed, fresh_fleet)
            mode = self._stance_mode.expand(3, B)
            if self._switch:
                mode = torch.where(
                    noise.speed < self.switch_speed,
                    const(STANCE_GROUNDED, self.device)[:, None],
                    const(STANCE_AERIAL, self.device)[:, None])
        return self._clock(swing, stance, mode), swing, stance, mode

    def _loaded(self, batch: int) -> GaitClock:
        c = self._loaded_clock
        return GaitClock(x=c.x.expand(-1, batch), y=c.y.expand(-1, -1, batch),
                         d=c.d.expand(-1, -1, batch),
                         phaselen=c.phaselen.expand(batch))

    def _empty_state(self, phys, params, clock, phase, speed, side_speed,
                     swing, stance, mode, menc, jenc, phase_add):
        """A fresh episode's state (time 0, no previous action or torque,
        an empty history, the apex flags down)."""
        B, dev = phase.shape[-1], self.device
        zi = torch.zeros((B,), dtype=torch.int32, device=dev)
        no = torch.zeros((B,), dtype=torch.bool, device=dev)
        return CassieEnvState(
            phys=phys, params=params, clock=clock, phase=phase,
            counter=zi, time=zi.clone(), speed=speed,
            side_speed=side_speed,
            orient_add=torch.zeros((B,), device=dev),
            swing_duration=swing, stance_duration=stance,
            stance_mode=mode.contiguous(), motor_enc_noise=menc,
            joint_enc_noise=jenc,
            prev_action=torch.zeros((self.action_size, B), device=dev),
            prev_torque=torch.zeros((10, B), device=dev),
            obs_history=torch.zeros((self.history + 1, self._base_obs, B),
                                    device=dev),
            l_high=no, r_high=no.clone(), phase_add=phase_add)

    def reset_fresh(self, noise: ResetNoise):
        return self.reset(noise, fresh_fleet=True)

    def reset(self, noise: ResetNoise, fresh_fleet: bool = False):
        """The auto-reset's arithmetic, or with `fresh_fleet` that of JAX's
        `init_runner` program (`speed_to_durations`)."""
        B = noise.speed.shape[-1]
        dev = self.device
        clock, swing, stance, mode = self._make_clock(noise, fresh_fleet)
        # random starting phase (cassie.py:561)
        phase = torch.floor(noise.phase_u * torch.floor(clock.phaselen + 1.0))
        phys = CassiePhysState.standing(B, dev)
        params, menc, jenc = self._sample_params(noise)
        phase_add = (torch.where(noise.speed > 1.4, 1.5, 1.0)
                     if self.speed_phase_add
                     else torch.ones((B,), device=dev))
        state = self._empty_state(phys, params, clock, phase, noise.speed,
                                  noise.side_speed, swing, stance, mode,
                                  menc, jenc, phase_add)
        # populate the estimator from FK (the reference reset ends with
        # one step_pd to refresh cassie_state, cassie.py:665)
        est = estimate_state(self.model, phys,
                             static_diag(self.model, params, phys,
                                         self.pd_tier))
        return self._observe(state, est)

    def reset_for_test(self, batch: int):
        """Deterministic eval reset (envs/cassie.py:412-444, reference
        reset_for_test, cassie.py:682-733): default dynamics, zero encoder
        noise, speed, side speed, orient_add and phase 0, and a grounded
        clock with swing 0.15 / stance 0.25 (the loaded clock for the
        `load_*` rewards). The command and 5k suites drive the env from
        this state."""
        dev = self.device
        full = lambda v: torch.full((batch,), v, device=dev)
        swing, stance = full(0.15), full(0.25)
        mode = const(STANCE_GROUNDED, dev)[:, None].expand(3, batch)
        # XLA folds this clock's constants op by op: phaselen uncontracted
        # (at simrate 60 the contracted sum is an ulp short)
        clock = (self._clock(swing, stance, mode, fused=False)
                 if self._loaded_clock is None else self._loaded(batch))
        phys = CassiePhysState.standing(batch, dev)
        params = PhysParams.from_model(self.model, batch, dev)
        state = self._empty_state(
            phys, params, clock, full(0.0), full(0.0), full(0.0), swing,
            stance, mode, torch.zeros((10, batch), device=dev),
            torch.zeros((6, batch), device=dev), full(1.0))
        est = estimate_state(self.model, phys,
                             static_diag(self.model, params, phys,
                                         self.pd_tier))
        return self._observe(state, est)

    def update_speed_state(self, state: CassieEnvState, new_speed,
                           new_side_speed=0.0, quantize_phase: bool = True):
        """The reference's update_speed (envs/cassie.py:445-474,
        cassie.py:751-768): clamp the commanded speed, rebuild the
        speed-dependent durations and gait clock, and rescale the phase
        into the new clock's length. quantize_phase floors the rescaled
        phase as the reference's int() does; called every step of a
        speed ramp, the floor cancels the phase advance and freezes the
        gait clock for the ramp. The 5k suite keeps that quirk (PARITY.md
        row 34)."""
        B, dev = state.phase.shape[-1], self.device
        as_b = lambda v: torch.as_tensor(
            v, dtype=torch.float32, device=dev).expand(B)
        speed = torch.clamp(as_b(new_speed), self.min_speed, self.max_speed)
        side = torch.clamp(as_b(new_side_speed), self.min_side_speed,
                           self.max_side_speed)
        swing, stance = speed_to_durations(speed)
        clock = self._clock(swing, stance, state.stance_mode)
        phase = clock.phaselen * state.phase / state.clock.phaselen
        if quantize_phase:
            phase = torch.floor(phase)
        return dataclasses.replace(
            state, speed=speed, side_speed=side, swing_duration=swing,
            stance_duration=stance, clock=clock, phase=phase)

    # ------------------------------------------------------------------
    def _physics(self, state: CassieEnvState, act: torch.Tensor):
        """The PD scan from the policy's action act (action_size, B): the
        targets, and with learn_gains the per-env gains added to the
        defaults (envs/cassie.py:525-532); and the estimator's view of its
        end, filtered by the firmware estimator or exact. Returns (PD
        targets, phys, diag_seq, qvel_seq, qacc_seq, est)."""
        m = self.model
        target = act[:10] + self._offset - state.motor_enc_noise
        if self.learn_gains:
            cmd = PDCommand.from_targets(target, self._p_gain + act[10:20],
                                         self._d_gain + act[20:30])
        else:
            cmd = PDCommand.from_targets(target)
        phys, diag_seq, qvel_seq, qacc_seq = pd_scan(
            m, state.params, state.phys, cmd, self.simrate, self.pd_tier)
        if not self._firmware:
            return (target, phys, diag_seq, qvel_seq, qacc_seq,
                    estimate_state(m, phys, _last_substep(diag_seq)))
        # firmware-estimator EMA in closed form:
        # e_L = a^L e_0 + (1-a) sum_t a^(L-1-t) v_t
        ema_v = (self._ema_decay * state.phys.qvel
                 + torch.tensordot(self._w_ema, qvel_seq, dims=1))
        ema_a = (self._ema_decay * state.phys.qacc
                 + torch.tensordot(self._w_ema, qacc_seq, dims=1))
        est = estimate_state(
            m, dataclasses.replace(phys, qvel=ema_v, qacc=ema_a),
            _last_substep(diag_seq))
        return target, phys, diag_seq, qvel_seq, qacc_seq, est

    def _advance_phase(self, state: CassieEnvState):
        """(time, phase, counter) after one policy step (cassie.py:447-453):
        the phase moves by phase_add and wraps to 0 past the clock."""
        phase = state.phase + state.phase_add
        wrapped = phase > state.clock.phaselen
        return (state.time + 1, torch.where(wrapped, 0.0, phase),
                state.counter + wrapped.to(torch.int32))

    def step_basic(self, state: CassieEnvState, action: torch.Tensor):
        """The reference's step_basic (envs/cassie.py:476-520, cassie.py:
        499-521): physics, phase advance and observation; no reward, no
        tracking costs, no random command changes. The 5k suite drives the
        policy through it. Returns (state, obs)."""
        act = action.T
        _, phys, diag_seq, _, _, est = self._physics(state, act)
        time_, phase, counter = self._advance_phase(state)
        new_state = dataclasses.replace(
            state, phys=phys, phase=phase, counter=counter, time=time_,
            prev_action=act, prev_torque=diag_seq.motor_torque[-1])
        return self._observe(new_state, est)

    def step(self, state: CassieEnvState, action: torch.Tensor,
             noise: StepNoise):
        return self._step(state, action, noise, with_info=False)[:4]

    def step_info(self, state: CassieEnvState, action: torch.Tensor,
                  noise: StepNoise):
        """`step`, and the JAX step's info diagnostics (envs/cassie.py:
        835-850) that the recording and driving tools read: (state, obs,
        reward, terminated, info), info's entries batch-last."""
        return self._step(state, action, noise, with_info=True)

    def _step(self, state: CassieEnvState, action: torch.Tensor,
              noise: StepNoise, with_info: bool):
        m = self.model
        act = action.T                                    # (action_size, B)
        target, phys, diag_seq, qvel_seq, qacc_seq, est = self._physics(
            state, act)
        if self._est_noise:
            # the firmware estimator's white measurement noise
            # (envs/cassie.py:707-718)
            nz = self.estimator_noise * noise.est_noise
            est = dataclasses.replace(
                est, pelvis_trans_vel=est.pelvis_trans_vel + nz[0:3],
                pelvis_rot_vel=est.pelvis_rot_vel + nz[3:6],
                motor_velocity=est.motor_velocity + nz[6:16],
                joint_velocity=est.joint_velocity + nz[16:22])

        # position-difference foot velocities (reference cassie.py:330-331);
        # the first substep's previous foot position is the FK of the
        # pre-step state (StepOut.kin is the input-qpos FK)
        prev_foot0 = static_diag(m, state.params, state.phys,
                                 self.pd_tier).foot_pos
        prev_pos_seq = torch.cat([prev_foot0[None], diag_seq.foot_pos[:-1]])
        foot_vel_seq = (diag_seq.foot_pos - prev_pos_seq) / m.timestep

        fq = diag_seq.foot_quat                           # (L, 2, 4, B)
        orient_seq = 1.0 - torch.sum(fq * self._neutral_foot, dim=2) ** 2
        frc_seq = diag_seq.foot_frc_z                     # (L, 2, B)
        motor_torque = diag_seq.motor_torque[-1]

        time_, phase, counter = self._advance_phase(state)

        # reward (compute_reward, cassie.py:770-785)
        # the swing-apex flags feed only the speedmatch rewards; the clock
        # rewards leave them at the reset's False
        l_high, r_high = state.l_high, state.r_high
        if self._speedmatch is not None:
            # swing-apex flags (cassie_footdist_env.py:313-320), after every
            # substep
            lz, rz = diag_seq.foot_pos[:, 0, 2], diag_seq.foot_pos[:, 1, 2]
            l_high_seq = _flag_seq(l_high, frc_seq[:, 0] > 0, lz >= 0.19)
            r_high_seq = _flag_seq(r_high, frc_seq[:, 1] > 0, rz >= 0.19)
            l_high, r_high = l_high_seq[-1], r_high_seq[-1]
            si = self._speedmatch_inputs(
                state, act, phys, est, diag_seq, qvel_seq, qacc_seq,
                foot_vel_seq, orient_seq, l_high_seq, r_high_seq, time_)
            reward = self._speedmatch(si)
        else:
            first = state.time == 0
            prev_action = torch.where(first, act, state.prev_action)
            prev_torque = torch.where(first, motor_torque, state.prev_torque)
            l_foot_frc, r_foot_frc = frc_seq.mean(dim=0)
            l_orient_cost, r_orient_cost = orient_seq.mean(dim=0)
            ri = RewardInputs(
                qpos=phys.qpos, qvel=phys.qvel,
                l_foot_frc=l_foot_frc, r_foot_frc=r_foot_frc,
                l_foot_vel=foot_vel_seq[-1, 0],
                r_foot_vel=foot_vel_seq[-1, 1],
                l_foot_orient_cost=l_orient_cost,
                r_foot_orient_cost=r_orient_cost,
                speed=state.speed, phase=phase,
                pelvis_rot_vel=est.pelvis_rot_vel,
                pelvis_accel=est.pelvis_trans_accel,
                motor_torque=motor_torque, prev_torque=prev_torque,
                action=act[:10], prev_action=prev_action[:10],
                est_lfoot_orient=est.left_foot_orientation,
                est_rfoot_orient=est.right_foot_orientation)
            reward = self._clock_reward(state.clock, ri)

        # termination (cassie.py:462-465) and the finite-state guard
        height = phys.qpos[2]
        terminated = ((height < 0.4) | (height > 3.0)
                      | ~torch.isfinite(phys.qpos).all(dim=0)
                      | ~torch.isfinite(phys.qvel).all(dim=0))
        reward = torch.where(torch.isfinite(reward), reward, 0.0)

        # random command changes (cassie.py:483-491)
        orient_add = state.orient_add + torch.where(
            noise.orient_hit, noise.orient_delta, 0.0)
        if self.orient_jump_prob > 0.0:
            # the heading curriculum's occasional large jumps
            jump = noise.jump_size * torch.where(noise.jump_sign, 1.0, -1.0)
            orient_add = orient_add + torch.where(
                noise.jump_u < self.orient_jump_prob, jump, 0.0)
        speed = torch.where(
            noise.speed_hit,
            torch.clamp(noise.new_speed, self.min_speed, self.max_speed),
            state.speed)
        side_speed = torch.where(noise.side_hit, noise.new_side,
                                 state.side_speed)
        phase_add = (torch.where(speed > 1.4, 1.5, 1.0)
                     if self.speed_phase_add else state.phase_add)

        new_state = dataclasses.replace(
            state, phys=phys, phase=phase, counter=counter, time=time_,
            speed=speed, side_speed=side_speed, orient_add=orient_add,
            phase_add=phase_add, prev_action=act, prev_torque=motor_torque,
            l_high=l_high, r_high=r_high)
        new_state, obs = self._observe(new_state, est)
        info = None
        if with_info:
            # every key of the JAX step's info (envs/cassie.py:834-850);
            # grf_seq is (simrate, 2, B)
            dev = phys.qpos.device
            l_foot_frc, r_foot_frc = frc_seq.mean(dim=0)
            info = {"l_foot_frc": l_foot_frc, "r_foot_frc": r_foot_frc,
                    "height": height, "grf_seq": frc_seq,
                    "foot_pos": diag_seq.foot_pos[-1],
                    "est_lfoot_pos": est.left_foot_position,
                    "est_rfoot_pos": est.right_foot_position,
                    "qpos": phys.qpos, "pd_target": target,
                    "motor_pos": phys.qpos[const(MOTOR_QPOS_IDX, dev,
                                                 torch.int64)],
                    "motor_vel": phys.qvel[const(MOTOR_QVEL_IDX, dev,
                                                 torch.int64)],
                    "motor_torque": motor_torque}
        return new_state, obs, reward, terminated, info

    def _speedmatch_inputs(self, state, act, phys, est, diag_seq, qvel_seq,
                           qacc_seq, foot_vel_seq, orient_seq, l_high_seq,
                           r_high_seq, time_):
        """The tracking layer of the research envs (cassie_mininput_env.py:
        418-521, cassie_footdist_env.py:313-387): per-substep cost
        sequences reduced by their mean over the substeps, and the inputs
        of the speedmatch rewards (envs/cassie.py:537-690, :735-782)."""
        m = self.model
        prev_action = torch.where(state.time == 0, act, state.prev_action)
        L = qvel_seq.shape[0]
        # smooth foot-height clocks, constant over the control step
        pl1 = state.clock.phaselen + 1.0
        one2one = 0.5 * (torch.cos(2 * np.pi / pl1 * state.phase) + 1.0)
        zero2zero = 0.5 * (torch.cos(
            2 * np.pi / pl1 * (state.phase - pl1 / 2.0)) + 1.0)
        des_height = 0.15
        first_half = state.phase < state.clock.phaselen / 2.0

        hiproll_seq = (torch.abs(qvel_seq[:, 6])
                       + torch.abs(qvel_seq[:, 19])) / 3.0
        hipyaw_seq = torch.abs(qvel_seq[:, 7]) + torch.abs(qvel_seq[:, 20])
        lz, rz = diag_seq.foot_pos[:, 0, 2], diag_seq.foot_pos[:, 1, 2]
        l_frc_seq = diag_seq.foot_frc_z[:, 0]
        r_frc_seq = diag_seq.foot_frc_z[:, 1]
        norm3 = lambda v: torch.sqrt(torch.sum(v * v, dim=1))
        l_ground = lz ** 2 + norm3(foot_vel_seq[:, 0])
        l_height = 40.0 * (des_height - lz) ** 2
        r_ground = rz ** 2 + norm3(foot_vel_seq[:, 1])
        r_height = 40.0 * (des_height - rz) ** 2
        l_smooth_seq = zero2zero * l_height + one2one * l_ground
        r_smooth_seq = one2one * r_height + zero2zero * r_ground
        # var quirk: one2one_var, zero2zero_var = 1, 0
        # (cassie_mininput_env.py:420); no loaded clock: both gates 0
        l_var_seq, r_var_seq = l_ground, r_height
        l_ck_seq, r_ck_seq = l_ground, r_ground
        # force/high-gated costs use des_height 0.2, incl. the upstream
        # quirk of gating the left lift branch on r_high
        # (cassie_footdist_env.py:343-387)
        l_height2 = 40.0 * (0.2 - lz) ** 2
        r_height2 = 40.0 * (0.2 - rz) ** 2
        l_td = 40.0 * lz ** 2 * foot_vel_seq[:, 0, 2] ** 2
        r_td = 40.0 * rz ** 2 * foot_vel_seq[:, 1, 2] ** 2
        r_cost_seq = torch.where(l_frc_seq == 0.0, r_ground,
                                 torch.where(~r_high_seq, r_height2, r_td))
        l_cost_seq = torch.where(r_frc_seq == 0.0, l_ground,
                                 torch.where(~r_high_seq, l_height2, l_td))
        l_even_seq = torch.where(first_half,
                                 torch.where(~l_high_seq, l_height2, l_td),
                                 l_ground)
        r_even_seq = torch.where(first_half, r_ground,
                                 torch.where(~r_high_seq, r_height2, r_td))

        # torque costs (cassie_mininput_env.py:512-521); the first substep
        # of an episode has no previous torque and contributes 0
        tau_seq = diag_seq.motor_torque                   # (L, 10, B)
        prev_tau_seq = torch.cat([state.prev_torque[None], tau_seq[:-1]])
        have_prev = torch.ones_like(tau_seq[:, 0], dtype=torch.bool)
        have_prev[0] = state.time > 0
        norm_sq = lambda x: torch.sqrt(torch.sum((x * x) ** 2, dim=1))
        smooth_seq = torch.where(
            have_prev, 1e-4 * norm_sq(tau_seq - prev_tau_seq), 0.0)
        torque_seq = 6e-5 * norm_sq(tau_seq)
        l_ry_seq = zero2zero * 6e-3 * norm_sq(tau_seq[:, 0:2])
        r_ry_seq = one2one * 6e-3 * norm_sq(tau_seq[:, 5:7])
        pel_stable_seq = 0.05 * (torch.abs(qvel_seq[:, 3:6]).sum(dim=1)
                                 + torch.abs(qacc_seq[:, 0:3]).sum(dim=1))

        (l_orient, r_orient, hiproll_cost, hipyaw_cost, l_smooth_cost,
         r_smooth_cost, l_var_cost, r_var_cost, l_ck_cost, r_ck_cost,
         l_foot_cost, r_foot_cost, l_even_cost, r_even_cost, torque_cost,
         smooth_cost, l_ry_cost, r_ry_cost, pel_stable_cost) = torch.stack([
             orient_seq[:, 0], orient_seq[:, 1], hiproll_seq, hipyaw_seq,
             l_smooth_seq, r_smooth_seq, l_var_seq, r_var_seq, l_ck_seq,
             r_ck_seq, l_cost_seq, r_cost_seq, l_even_seq, r_even_seq,
             torque_seq, smooth_seq, l_ry_seq, r_ry_seq,
             pel_stable_seq]).mean(dim=1)

        pair = lambda x, i, j: torch.stack([x[i], x[j]])
        hiproll_act = 2.0 * torch.linalg.vector_norm(
            pair(prev_action, 0, 5) - pair(act, 0, 5), dim=0)
        hipyaw_act = 2.0 * torch.linalg.vector_norm(
            pair(prev_action, 1, 6) - pair(act, 1, 6), dim=0)
        # profile-dependent foot-orient scale: the footdist env accumulates
        # 1x (cassie_footdist_env.py:337), every other research env 20x
        # (cassie_mininput_env.py:426)
        oscale = 1.0 if self.input_profile == "footdist" else 20.0
        foot_pos = diag_seq.foot_pos[-1]
        return SpeedmatchInputs(
            qpos=phys.qpos, qvel=phys.qvel, speed=state.speed,
            orient_add=state.orient_add,
            pelvis_orientation=est.pelvis_orientation,
            l_foot_orient_cost=l_orient, r_foot_orient_cost=r_orient,
            hiproll_cost=hiproll_cost, hiproll_act=hiproll_act,
            hipyaw_vel=hipyaw_cost, hipyaw_act=hipyaw_act,
            l_foot_cost_smooth=l_smooth_cost,
            r_foot_cost_smooth=r_smooth_cost,
            side_speed=state.side_speed, time=time_,
            l_foot_orient=oscale * l_orient,
            r_foot_orient=oscale * r_orient,
            l_foot_cost=l_foot_cost, r_foot_cost=r_foot_cost,
            l_foot_cost_even=l_even_cost, r_foot_cost_even=r_even_cost,
            l_foot_cost_var=l_var_cost, r_foot_cost_var=r_var_cost,
            l_foot_cost_clock=l_ck_cost, r_foot_cost_clock=r_ck_cost,
            torque_cost=torque_cost, smooth_cost=smooth_cost,
            pel_stable=pel_stable_cost,
            left_rollyaw_torque_cost=l_ry_cost,
            right_rollyaw_torque_cost=r_ry_cost,
            foot_pos=foot_pos, lfoot_vel=foot_vel_seq[-1, 0],
            rfoot_vel=foot_vel_seq[-1, 1],
            l_high=l_high_seq[-1].to(foot_pos.dtype),
            r_high=r_high_seq[-1].to(foot_pos.dtype),
            # reward-time instantaneous forces (the reference rewards call
            # sim.get_foot_forces() after the substep loop)
            l_foot_frc=diag_seq.foot_frc_z[-1, 0],
            r_foot_frc=diag_seq.foot_frc_z[-1, 1],
            pelvis_accel=est.pelvis_trans_accel,
            action=act[:10], prev_action=prev_action[:10])

    def checkpoint_leaves(self, state: CassieEnvState,
                          obs: torch.Tensor):
        """The JAX CassieEnvState's leaves (envs/cassie.py:120-145), batch-
        first."""
        fields = [state.phys.qpos, state.phys.qvel, state.phys.qacc,
                  *(getattr(state.params, f.name)
                    for f in dataclasses.fields(state.params)),
                  *(getattr(state.clock, f.name)
                    for f in dataclasses.fields(state.clock)),
                  state.phase, state.counter, state.time, state.speed,
                  state.side_speed, state.orient_add, state.swing_duration,
                  state.stance_duration, state.stance_mode,
                  state.motor_enc_noise, state.joint_enc_noise,
                  state.prev_action, state.prev_torque, state.obs_history,
                  state.l_high, state.r_high, state.phase_add]
        return [to_batch_first(x) for x in fields]

    def _observe(self, state: CassieEnvState, est: CassieStateOut):
        """The observation (get_full_state) pushed onto the state's history:
        (state, obs (B, observation_size)), the newest frame first."""
        if self._research_variant:
            # [clock, speed] with the phaselen + 1 divisor
            phase_frac = (2.0 * np.pi * state.phase
                          / (state.clock.phaselen + 1.0))
            ext = [torch.sin(phase_frac), torch.cos(phase_frac),
                   state.speed]
        else:
            phase_frac = 2.0 * np.pi * state.phase / state.clock.phaselen
            ext = [torch.sin(phase_frac), torch.cos(phase_frac)]
            if self.command_profile == "phase":
                ext += [state.swing_duration, state.stance_duration,
                        *state.stance_mode]
            ext += [state.speed, state.side_speed]
        base = torch.cat([robot_obs(self.input_profile, state, est),
                          torch.stack(ext)])
        if self.omniscient:
            base = torch.cat([base, state.params.dof_damping,
                              state.params.body_mass,
                              state.params.friction[None]])
        # a physics blow-up NaNs the estimator outputs one step before the
        # termination guards fire; a NaN frame would poison the obs
        # normalizer, so sanitize at the single obs chokepoint
        base = torch.where(torch.isfinite(base), base, 0.0)
        hist = torch.cat([base[None], state.obs_history[:-1]])
        B = base.shape[-1]
        obs = hist.reshape(-1, B).T
        return dataclasses.replace(state, obs_history=hist), obs


def rotate_to_orient(orient_add: torch.Tensor, vec: torch.Tensor
                     ) -> torch.Tensor:
    """reference rotate_to_orient (cassie.py:280-291): a vector (3, B) or
    quaternion (4, B) in the frame turned by -orient_add about z, the
    quaternion with a non-negative w."""
    z = torch.zeros_like(orient_add)
    iq = quat_inverse(euler2quat(z=orient_add, y=z, x=z))
    if vec.shape[0] == 3:
        return quat_rotate(iq, vec)
    out = quat_mul(iq, vec)
    return torch.where(out[0:1] < 0, -out, out)


def robot_obs(profile: str, state, est: CassieStateOut) -> torch.Tensor:
    """The robot state of an input profile (get_full_state, cassie.py:
    787-859; the research variants' get_full_state, envs/cassie.py:
    867-913), (rows, B), from the estimator's outputs and the state's
    heading offset and encoder offsets."""
    rot = lambda v: rotate_to_orient(state.orient_add, v)
    feet = [est.left_foot_position, est.right_foot_position]
    motor_pos = est.motor_position + state.motor_enc_noise
    if profile == "full":
        return torch.cat([
            (est.pelvis_position[2] - est.terrain_height)[None],
            rot(est.pelvis_orientation), motor_pos,
            rot(est.pelvis_trans_vel), est.pelvis_rot_vel,
            est.motor_velocity, rot(est.pelvis_trans_accel),
            est.joint_position + state.joint_enc_noise, est.joint_velocity])
    if profile == "min":
        return torch.cat([
            *feet, rot(est.pelvis_orientation), est.pelvis_rot_vel,
            est.left_foot_orientation, est.right_foot_orientation])
    if profile == "footdist":
        return torch.cat([
            *feet, rot(est.pelvis_orientation), motor_pos,
            rot(est.pelvis_trans_vel), est.pelvis_rot_vel,
            est.motor_velocity, rot(est.pelvis_trans_accel),
            est.joint_position + state.joint_enc_noise, est.joint_velocity])
    # novel_footdist drops the pelvis translational velocity
    moving = [] if profile == "novel_footdist" else [
        rot(est.pelvis_trans_vel)]
    robot = [*feet, rot(est.pelvis_orientation), motor_pos, *moving,
             est.pelvis_rot_vel, est.motor_velocity]
    if profile != "noaccel_footdist_nojoint":
        # no foot-joint entries; the joint velocities repeat the left
        # shin and tarsus (the reference's slice quirk)
        jp = est.joint_position + state.joint_enc_noise
        jv = est.joint_velocity
        robot += [jp[0:2], jp[3:5], jv[0:2], jv[0:2]]
    return torch.cat(robot)


def _flag_seq(init: torch.Tensor, a: torch.Tensor, b: torch.Tensor
              ) -> torch.Tensor:
    """The 1-bit recurrence h_t = (not a_t) if h_(t-1) else b_t over the
    substeps, from h_(-1) = init (B,): its value after every substep, (L,
    B), as the JAX env's associative scan gives it (envs/cassie.py:595-
    605). Each substep maps h to a constant (when b_t == not a_t), keeps
    it (b_t = 0, a_t = 0) or flips it (b_t = 1, a_t = 1); so h_t is the
    last constant (or init) flipped once per flip since."""
    L = a.shape[0]
    const = b == ~a
    t = torch.arange(L, device=a.device)[:, None].expand_as(a)
    last = torch.cummax(torch.where(const, t, -1), dim=0).values
    flips = torch.cumsum((a & b).to(torch.int32), dim=0)
    at_last = last.clamp(min=0)
    base = torch.where(last >= 0, b.gather(0, at_last), init[None])
    since = flips - torch.where(last >= 0, flips.gather(0, at_last), 0)
    return base ^ (since % 2 == 1)


def _last_substep(diag_seq):
    """The last substep's diagnostics of a (L, ...) sequence."""
    return type(diag_seq)(*(x[-1] for x in diag_seq))
