"""Periodic-gait clocks and the clock-based rewards, batch-last.

Port of `apex_tpu/rewards/clock.py`: the per-episode clock construction
(reference cassie/phase_function.py:5-136, PCHIP splines over swing/stance
segments, 3-cycle tiling), the precomputed clocks of
`data/reward_clocks.npz` (`load_reward_clock`), `speed_to_durations`, and
the clock rewards of reference cassie/rewards/clock_rewards.py (`clock`,
`early_clock`, `no_speed_clock`, `max_vel_clock`, `aslip_clock`;
`REWARD_FUNCS`). A clock is x (n, B), y and d (4, n, B), phaselen (B,),
n = 24 for a built clock and 512 for a loaded one; channel order in y:
[l_frc, l_vel, r_frc, r_vel].
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import const
from apex_tpu_torch.utils.pchip import pchip_derivatives, pchip_eval


@dataclasses.dataclass
class GaitClock:
    x: torch.Tensor         # (24, B) knot positions (phase units)
    y: torch.Tensor         # (4, 24, B) values [l_frc, l_vel, r_frc, r_vel]
    d: torch.Tensor         # (4, 24, B) pchip derivatives
    phaselen: torch.Tensor  # (B,)

    def eval(self, phase: torch.Tensor):
        """(l_frc, l_vel, r_frc, r_vel), each (B,), at phase (B,)."""
        v = pchip_eval(self.x, self.y, self.d, phase)
        return v[0], v[1], v[2], v[3]


# stance-mode one-hots [grounded, aerial, zero]
STANCE_GROUNDED = (1.0, 0.0, 0.0)
STANCE_AERIAL = (0.0, 1.0, 0.0)
STANCE_ZERO = (0.0, 0.0, 1.0)


def _value_table(stance_mode: torch.Tensor, have_incentive: bool
                 ) -> torch.Tensor:
    """(4, 8, B) knot values for stance_mode (3, B); columns grouped as
    [right_swing x2, dbl_stance x2, left_swing x2, dbl_stance2 x2]
    (phase_function.py:26-97)."""
    inc = 1.0 if have_incentive else 0.0
    base = np.zeros((4, 8), np.float32)
    base[1, 0:2] = -1.0          # l_vel penalized during right swing
    base[2, 0:2] = -1.0          # r_frc penalized
    base[0, 0:2] = inc           # l_frc incentivized
    base[3, 0:2] = inc           # r_vel incentivized
    base[0, 4:6] = -1.0          # l_frc penalized during left swing
    base[3, 4:6] = -1.0          # r_vel penalized
    base[1, 4:6] = inc           # l_vel incentivized
    base[2, 4:6] = inc           # r_frc incentivized
    if have_incentive:
        grounded = [1.0, -1.0, 1.0, -1.0]   # frc good, vel bad
        aerial = [-1.0, 1.0, -1.0, 1.0]     # vel good, frc bad
    else:
        # the reference's no-incentive grounded quirk
        # (phase_function.py:54-55), kept for parity
        grounded = [-1.0, 0.0, 0.0, -1.0]
        aerial = [-1.0, 0.0, -1.0, 0.0]
    modes = const(np.stack([grounded, aerial, np.zeros(4)], axis=1),
                  stance_mode.device)
    stance_col = modes @ stance_mode                      # (4, B)
    B = stance_mode.shape[-1]
    out = const(base, stance_mode.device)[:, :, None]
    out = out.expand(4, 8, B).clone()
    for col in (2, 3, 6, 7):
        out[:, col] = stance_col
    return out


def build_clock(swing_duration: torch.Tensor, stance_duration: torch.Tensor,
                stance_mode: torch.Tensor, strict_relaxer: float = 0.1,
                have_incentive: bool = True, freq: float = 40.0,
                fused: bool = True) -> GaitClock:
    """Port of create_phase_reward (phase_function.py:5-136): durations
    (B,), stance_mode one-hot (3, B). `fused=False` takes phaselen as the
    JAX package computes it op by op, outside a compiled program
    (`drive._apply_key`'s clock keys)."""
    sw = swing_duration * freq
    st = stance_duration * freq
    if fused:
        # phaselen 2 sw + 2 st, as XLA compiles it: the doublings folded
        # into the constant 2 freq and the sum contracted into one fused
        # multiply-add (the 5k's gait clock floors by it, so its ulp
        # counts)
        total = fma_f32(swing_duration, 2 * freq,
                        stance_duration * (2 * freq))
    else:
        total = 2 * sw + 2 * st
    off_sw = sw * strict_relaxer     # swing relax offset
    off_st = st * strict_relaxer     # double-stance relax offset

    x8 = torch.stack([
        0.0 + off_sw, sw - off_sw,                 # right swing
        sw + off_st, sw + st - off_st,             # first double stance
        sw + st + off_sw, 2 * sw + st - off_sw,    # left swing
        2 * sw + st + off_st, total - off_st,      # second double stance
    ])
    # 3-cycle tiling for continuity (phase_function.py:99-118)
    x24 = torch.cat([x8 - total, x8, x8 + total])
    y8 = _value_table(stance_mode, have_incentive)
    y24 = torch.cat([y8, y8, y8], dim=1)
    return GaitClock(x=x24, y=y24, d=pchip_derivatives(x24, y24),
                     phaselen=total)


REWARD_CLOCKS = (Path(__file__).resolve().parent.parent / "data"
                 / "reward_clocks.npz")


def load_reward_clock(name: str, batch: int, device,
                      phaselen: float = 32.0, speed_idx: int = None
                      ) -> GaitClock:
    """One of the reference's precomputed reward clocks (reference
    cassie/rewards/reward_clock_funcs/<name>.pkl, as the dense tables of
    `data/reward_clocks.npz`) over its 512-point grid, for a fleet of
    `batch` envs (clock.py:104-126). speed_idx picks a speed of the
    per-speed aslip libraries (the first by default)."""
    with np.load(REWARD_CLOCKS) as f:
        lo, hi = float(f["__grid_lo"]), float(f["__grid_hi"])
        tab = f[name]
    if tab.ndim == 3:
        tab = tab[0 if speed_idx is None else speed_idx]
    x = torch.as_tensor(np.linspace(lo, hi, tab.shape[-1]).astype(
        np.float32), device=device)[:, None]
    y = torch.as_tensor(np.asarray(tab, np.float32), device=device)[..., None]
    d = pchip_derivatives(x, y)
    return GaitClock(x=x.expand(-1, batch), y=y.expand(-1, -1, batch),
                     d=d.expand(-1, -1, batch),
                     phaselen=torch.full((batch,), phaselen, device=device))


def fma_f32(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add gives it,
    on any device: the product of two floats is exact in float64, TwoSum
    keeps the error of the float64 sum, and that error settles the one
    case where rounding the float64 sum to float32 rounds twice (the sum
    on a tie between two floats)."""
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(
        torch.float64)
    a, b, c = f64(a), f64(b), f64(c)
    p = a * b
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)        # p + c == s + err exactly
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    d = s - r64                          # where s lies from r
    away = torch.nextafter(r, torch.where(d > 0, torch.inf, -torch.inf))
    tie = (d != 0) & (2 * d == away.to(torch.float64) - r64)
    return torch.where(tie & (err * d > 0), away, r)


def speed_to_durations(speed: torch.Tensor, fresh_fleet: bool = False):
    """Swing/stance durations from commanded speed (cassie.py:556-558), as
    XLA compiles them: 0.9 - c |speed| is one fused multiply-add. In the
    program of a fresh fleet's reset (`init_runner`'s jit of the vmapped
    reset) XLA also contracts 0.30 + c |speed| and 0.70 - c |speed|
    (`tests/test_torch_clock_resets.py`)."""
    v = torch.abs(speed)
    total_duration = fma_f32(v, -(0.25 / 3.0), 0.9) / 2.0
    if fresh_fleet:
        swing = fma_f32(v, 0.40 / 3.0, 0.30) * total_duration
        stance = fma_f32(v, -(0.40 / 3.0), 0.70) * total_duration
    else:
        swing = (0.30 + (0.40 / 3.0) * v) * total_duration
        stance = (0.70 - (0.40 / 3.0) * v) * total_duration
    return swing, stance


class RewardInputs(NamedTuple):
    """The per-policy-step quantities the clock rewards read, batch-last.
    early_clock reads the first ten; the fields after them default to None
    for callers that run only it."""
    qpos: torch.Tensor                # (35, B) post-step
    qvel: torch.Tensor                # (32, B)
    l_foot_frc: torch.Tensor          # (B,) substep-mean z force
    r_foot_frc: torch.Tensor
    l_foot_vel: torch.Tensor          # (3, B) last-substep foot velocity
    r_foot_vel: torch.Tensor
    l_foot_orient_cost: torch.Tensor  # (B,) substep-mean 1 - <neutral, q>^2
    r_foot_orient_cost: torch.Tensor
    speed: torch.Tensor               # (B,)
    phase: torch.Tensor               # (B,)
    pelvis_rot_vel: torch.Tensor = None   # (3, B)
    pelvis_accel: torch.Tensor = None     # (3, B)
    motor_torque: torch.Tensor = None     # (10, B)
    prev_torque: torch.Tensor = None      # (10, B)
    action: torch.Tensor = None           # (10, B)
    prev_action: torch.Tensor = None      # (10, B)
    # estimator (pelvis-frame) foot orientations, read by aslip_clock
    # (clock_rewards.py:358-363)
    est_lfoot_orient: torch.Tensor = None  # (4, B)
    est_rfoot_orient: torch.Tensor = None


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the leading axis."""
    return torch.sqrt(torch.sum(v * v, dim=0))


def _scores(clock: GaitClock, ri: RewardInputs, des_frc: float,
            des_vel: float):
    """The clock's (l_frc, l_vel, r_frc, r_vel) at ri.phase, and the
    normalized forces and foot speeds (n_l_frc, n_r_frc, n_l_vel,
    n_r_vel)."""
    c = clock.eval(ri.phase)
    n = (torch.clamp(ri.l_foot_frc, max=des_frc) / des_frc,
         torch.clamp(ri.r_foot_frc, max=des_frc) / des_frc,
         torch.clamp(_norm(ri.l_foot_vel), max=des_vel) / des_vel,
         torch.clamp(_norm(ri.r_foot_vel), max=des_vel) / des_vel)
    return c, n


def _deadzone(x: torch.Tensor, zone) -> torch.Tensor:
    return torch.where(x < zone, 0.0, x)


def _pelvis_motion(ri: RewardInputs, acc: bool) -> torch.Tensor:
    """Lateral and height deviation outside their dead zones, and with
    `acc` a quarter of the pelvis rotational velocity and acceleration."""
    motion = (_deadzone(torch.abs(ri.qpos[1]), 0.05)
              + _deadzone(torch.abs(ri.qpos[2] - 0.9),
                          0.05 + 0.05 * ri.speed))
    if acc:
        motion = motion + 0.25 * (torch.abs(ri.pelvis_rot_vel).sum(dim=0)
                                  + torch.abs(ri.pelvis_accel).sum(dim=0))
    return motion


def _tan_scores(clock, ri, des_frc, des_vel):
    """The tan-form clock scores (frc_score, vel_score)."""
    (l_frc_c, l_vel_c, r_frc_c, r_vel_c), (nlf, nrf, nlv, nrv) = _scores(
        clock, ri, des_frc, des_vel)
    q = np.pi / 4.0
    return (torch.tan(q * l_frc_c * nlf) + torch.tan(q * r_frc_c * nrf),
            torch.tan(q * l_vel_c * nlv) + torch.tan(q * r_vel_c * nrv))


def _tanh_scores(clock, ri, des_frc, des_vel):
    """The tanh-form clock scores (frc_score, vel_score)."""
    (l_frc_c, l_vel_c, r_frc_c, r_vel_c), (nlf, nrf, nlv, nrv) = _scores(
        clock, ri, des_frc, des_vel)
    return (torch.tanh(l_frc_c * nlf) + torch.tanh(r_frc_c * nrf),
            torch.tanh(l_vel_c * nlv) + torch.tanh(r_vel_c * nrv))


def _effort_penalties(ri: RewardInputs):
    """(hip roll, torque change, action change) penalties of the tan-form
    rewards. The reference indexes qvel[6] and qvel[13] (clock_rewards.py:
    74), qvel[13] being the left shin; kept for parity."""
    return (torch.abs(ri.qvel[6]) + torch.abs(ri.qvel[13]),
            0.25 * torch.abs(ri.prev_torque - ri.motor_torque).mean(dim=0),
            5.0 * torch.abs(ri.prev_action - ri.action).mean(dim=0))


def clock_reward(clock: GaitClock, ri: RewardInputs) -> torch.Tensor:
    """Reference clock_reward (clock_rewards.py:6-110)."""
    frc_score, vel_score = _tan_scores(clock, ri, 250.0, 2.0)
    com_orient_error = 10.0 * (1.0 - ri.qpos[3] ** 2)
    foot_orient_error = 10.0 * (ri.l_foot_orient_cost + ri.r_foot_orient_cost)
    com_vel_error = torch.abs(ri.qvel[0] - ri.speed)
    hip_roll, torque, act = _effort_penalties(ri)
    return (0.200 * frc_score
            + 0.200 * vel_score
            + 0.200 * torch.exp(-(com_orient_error + foot_orient_error))
            + 0.150 * torch.exp(-_pelvis_motion(ri, acc=True))
            + 0.150 * torch.exp(-com_vel_error)
            + 0.050 * torch.exp(-hip_roll)
            + 0.025 * torch.exp(-torque)
            + 0.025 * torch.exp(-act))


def early_clock_reward(clock: GaitClock, ri: RewardInputs) -> torch.Tensor:
    """Reference early_clock_reward (clock_rewards.py:119-223): tanh
    scores, wider force/vel normalization, no pelvis-acc term."""
    des_frc, des_vel = 350.0, 3.0
    norm = lambda v: torch.sqrt(torch.sum(v * v, dim=0))
    n_l_frc = torch.clamp(ri.l_foot_frc, max=des_frc) / des_frc
    n_r_frc = torch.clamp(ri.r_foot_frc, max=des_frc) / des_frc
    n_l_vel = torch.clamp(norm(ri.l_foot_vel), max=des_vel) / des_vel
    n_r_vel = torch.clamp(norm(ri.r_foot_vel), max=des_vel) / des_vel

    com_orient_error = 1.0 * (1.0 - ri.qpos[3] ** 2)
    foot_orient_error = 1.0 * (ri.l_foot_orient_cost + ri.r_foot_orient_cost)
    com_vel_error = torch.abs(ri.speed - ri.qvel[0])

    straight_diff = torch.abs(ri.qpos[1])
    straight_diff = torch.where(straight_diff < 0.05, 0.0, straight_diff)
    height_diff = torch.abs(ri.qpos[2] - 0.9)
    deadzone = 0.05 + 0.05 * ri.speed
    height_diff = torch.where(height_diff < deadzone, 0.0, height_diff)
    pelvis_motion = straight_diff + height_diff

    l_frc_c, l_vel_c, r_frc_c, r_vel_c = clock.eval(ri.phase)
    frc_score = torch.tanh(l_frc_c * n_l_frc) + torch.tanh(r_frc_c * n_r_frc)
    vel_score = torch.tanh(l_vel_c * n_l_vel) + torch.tanh(r_vel_c * n_r_vel)

    return (0.250 * frc_score
            + 0.350 * vel_score
            + 0.200 * torch.exp(-com_vel_error)
            + 0.100 * torch.exp(-(com_orient_error + foot_orient_error))
            + 0.100 * torch.exp(-pelvis_motion))


def no_speed_clock_reward(clock: GaitClock, ri: RewardInputs
                          ) -> torch.Tensor:
    """Reference no_speed_clock_reward (clock_rewards.py:225-333): tan-form
    clock scores and no speed-matching term."""
    frc_score, vel_score = _tan_scores(clock, ri, 250.0, 3.0)
    com_orient_error = 10.0 * (1.0 - ri.qpos[3] ** 2)
    foot_orient_error = 10.0 * (ri.l_foot_orient_cost + ri.r_foot_orient_cost)
    hip_roll, torque, act = _effort_penalties(ri)
    return (0.250 * frc_score
            + 0.250 * vel_score
            + 0.225 * torch.exp(-(com_orient_error + foot_orient_error))
            + 0.175 * torch.exp(-_pelvis_motion(ri, acc=True))
            + 0.050 * torch.exp(-hip_roll)
            + 0.025 * torch.exp(-torque)
            + 0.025 * torch.exp(-act))


def _straight_height(ri: RewardInputs) -> torch.Tensor:
    """Lateral deviation outside 0.05 m plus the height's distance from
    1.0 m outside 0.2 m (max_vel and aslip clocks)."""
    return (_deadzone(torch.abs(ri.qpos[1]), 0.05)
            + _deadzone(torch.abs(ri.qpos[2] - 1.0), 0.2))


def max_vel_clock_reward(clock: GaitClock, ri: RewardInputs
                         ) -> torch.Tensor:
    """Reference max_vel_clock_reward (clock_rewards.py:418-): raw forward
    speed (qvel[0] / 3) in place of speed matching, tanh clock scores at
    400 N, 15x com orientation."""
    frc_score, vel_score = _tanh_scores(clock, ri, 400.0, 3.0)
    com_orient_error = 15.0 * (1.0 - ri.qpos[3] ** 2)
    foot_orient_error = 10.0 * (ri.l_foot_orient_cost + ri.r_foot_orient_cost)
    return (0.1 * torch.exp(-com_orient_error)
            + 0.1 * torch.exp(-foot_orient_error)
            + 0.1 * torch.exp(-_straight_height(ri))
            + 0.2 * frc_score
            + 0.2 * vel_score
            + 0.3 * (ri.qvel[0] / 3.0))


def aslip_clock_reward(clock: GaitClock, ri: RewardInputs) -> torch.Tensor:
    """Reference aslip_clock_reward (clock_rewards.py:325-433): tanh scores
    at 400 N, the foot-orientation error from the estimator's foot
    quaternions against identity, height 1.0 m with a 0.2 m dead zone."""
    frc_score, vel_score = _tanh_scores(clock, ri, 400.0, 3.0)
    com_orient_error = 10.0 * (1.0 - ri.qpos[3] ** 2)
    foot_orient_error = 10.0 * ((1.0 - ri.est_lfoot_orient[0] ** 2)
                                + (1.0 - ri.est_rfoot_orient[0] ** 2))
    com_vel_error = torch.abs(ri.qvel[0] - ri.speed)
    return (0.1 * torch.exp(-com_orient_error)
            + 0.1 * torch.exp(-foot_orient_error)
            + 0.2 * torch.exp(-com_vel_error)
            + 0.1 * torch.exp(-_straight_height(ri))
            + 0.25 * frc_score
            + 0.25 * vel_score)


REWARD_FUNCS = {
    "clock": clock_reward,
    "early_clock": early_clock_reward,
    "no_speed_clock": no_speed_clock_reward,
    "max_vel_clock": max_vel_clock_reward,
    "aslip_clock": aslip_clock_reward,
}
