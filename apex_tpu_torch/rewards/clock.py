"""Periodic-gait clocks and the early_clock reward, batch-last.

Port of the parts of `apex_tpu/rewards/clock.py` the default Cassie-v0
config runs: the per-episode clock construction (reference
cassie/phase_function.py:5-136, PCHIP splines over swing/stance segments,
3-cycle tiling), `speed_to_durations` and `early_clock_reward` (reference
cassie/rewards/clock_rewards.py:119-223). A clock is x (24, B), y and d
(4, 24, B), phaselen (B,); channel order in y: [l_frc, l_vel, r_frc, r_vel].
"""
from __future__ import annotations

import dataclasses
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
                have_incentive: bool = True, freq: float = 40.0
                ) -> GaitClock:
    """Port of create_phase_reward (phase_function.py:5-136): durations
    (B,), stance_mode one-hot (3, B)."""
    sw = swing_duration * freq
    st = stance_duration * freq
    total = 2 * sw + 2 * st          # phaselen
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


def speed_to_durations(speed: torch.Tensor):
    """Swing/stance durations from commanded speed (cassie.py:556-558)."""
    total_duration = (0.9 - 0.25 / 3.0 * torch.abs(speed)) / 2.0
    swing = (0.30 + (0.40 / 3.0) * torch.abs(speed)) * total_duration
    stance = (0.70 - (0.40 / 3.0) * torch.abs(speed)) * total_duration
    return swing, stance


class RewardInputs(NamedTuple):
    """The per-policy-step quantities the early_clock reward reads
    (the JAX RewardInputs carries more, for the other clock rewards),
    batch-last."""
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
