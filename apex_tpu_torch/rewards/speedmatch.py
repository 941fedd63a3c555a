"""The speed-matching reward family, batch-last.

Port of `apex_tpu/rewards/speedmatch.py`: every live function of the
reference's cassie/rewards/speedmatch_rewards.py (26), side_speedmatch_
rewards.py (5) and the step_* members of standing_rewards.py (4), over
`SpeedmatchInputs`, the per-policy-step quantities the env layer
accumulates across the substeps (reference cassie_mininput_env.py:392-544,
cassie_footdist_env.py:322-403). `5k_speed_reward` is `old_speed_reward`.

Each field is batch-last: qpos (35, B), qvel (32, B), a scalar per env
(B,), foot_pos (2, 3, B), the foot velocities and pelvis_accel (3, B), the
actions (10, B). The JAX module's notes on the reference's quirks hold
here as there: the profile-dependent foot-orient scale is applied by the
env, the left force/high gating reuses the right foot's flag, and the
trajectory-tracking fields that no live reference env computes default to
0.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from apex_tpu_torch.utils.quaternion import (
    euler2quat,
    quat_inverse,
    quat_mul,
    quat_rotate,
)


class SpeedmatchInputs(NamedTuple):
    qpos: torch.Tensor
    qvel: torch.Tensor
    speed: torch.Tensor
    orient_add: torch.Tensor
    pelvis_orientation: torch.Tensor
    l_foot_orient_cost: torch.Tensor   # substep-mean 1 - <neutral, q>^2 (1x)
    r_foot_orient_cost: torch.Tensor
    hiproll_cost: torch.Tensor         # substep-mean (|qvel6|+|qvel19|)/3
    hiproll_act: torch.Tensor
    hipyaw_vel: torch.Tensor           # substep-mean |qvel7|+|qvel20|
    hipyaw_act: torch.Tensor
    l_foot_cost_smooth: torch.Tensor   # substep-mean smooth height cost
    r_foot_cost_smooth: torch.Tensor
    # ---- extended tracking (cassie_mininput_env.py:392-544) ----
    side_speed: torch.Tensor = 0.0
    time: torch.Tensor = 0
    orient_time: torch.Tensor = 500     # research envs reset to 500
    l_foot_orient: torch.Tensor = 0.0   # profile-scaled (20x or 1x)
    r_foot_orient: torch.Tensor = 0.0
    l_foot_cost: torch.Tensor = 0.0     # force/high-gated (footdist env)
    r_foot_cost: torch.Tensor = 0.0
    l_foot_cost_even: torch.Tensor = 0.0   # phase-gated
    r_foot_cost_even: torch.Tensor = 0.0
    l_foot_cost_var: torch.Tensor = 0.0
    r_foot_cost_var: torch.Tensor = 0.0
    l_foot_cost_clock: torch.Tensor = 0.0  # loaded-clock gated
    r_foot_cost_clock: torch.Tensor = 0.0
    torque_cost: torch.Tensor = 0.0        # 0.00006*||tau^2|| substep mean
    smooth_cost: torch.Tensor = 0.0        # 0.0001*||dtau^2|| substep mean
    pel_stable: torch.Tensor = 0.0
    left_rollyaw_torque_cost: torch.Tensor = 0.0
    right_rollyaw_torque_cost: torch.Tensor = 0.0
    foot_pos: torch.Tensor = None          # (2, 3, B) end-of-step feet
    lfoot_vel: torch.Tensor = None         # (3, B) last-substep velocity
    rfoot_vel: torch.Tensor = None
    l_high: torch.Tensor = 0.0             # swing-apex flags (float 0/1)
    r_high: torch.Tensor = 0.0
    l_foot_frc: torch.Tensor = 0.0         # reward-time vertical force
    r_foot_frc: torch.Tensor = 0.0
    pelvis_accel: torch.Tensor = None      # (3, B)
    action: torch.Tensor = None            # (10, B)
    prev_action: torch.Tensor = None       # (10, B)
    # dead-in-reference trajectory-tracking terms (0 unless an env fills
    # them)
    joint_error: torch.Tensor = 0.0
    lf_heightvel: torch.Tensor = 0.0
    rf_heightvel: torch.Tensor = 0.0
    l_foot_diff: torch.Tensor = 0.0
    r_foot_diff: torch.Tensor = 0.0
    l_footvel_diff: torch.Tensor = 0.0
    r_footvel_diff: torch.Tensor = 0.0
    com_vel_error: torch.Tensor = 0.0
    com_error: torch.Tensor = 0.0
    orientation_error: torch.Tensor = 0.0


def _exp(x):
    """exp of a tensor, or of a field left at its float default."""
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the leading (component) axis."""
    return torch.sqrt(torch.sum(v * v, dim=0))


def _unit_quat_dist(q: torch.Tensor) -> torch.Tensor:
    """|| q - (1, 0, 0, 0) || of (4, B) quaternions."""
    return _norm(torch.cat([q[0:1] - 1.0, q[1:4]]))


def _deadzone(x, lo):
    return torch.where(x < lo, 0.0, x)


def _orient_terms(ri: SpeedmatchInputs):
    """The shared preamble of the speedmatch family
    (speedmatch_rewards.py:107-125 form, no orient-command rotation):
    forward/orient(30x)/straight/y_vel with their deadzones."""
    forward_diff = _deadzone(torch.abs(ri.qvel[0] - ri.speed), 0.05)
    orient_diff = 1.0 - ri.qpos[3] ** 2   # 1 - <(1,0,0,0), q>^2
    orient_diff = torch.where(orient_diff < 5e-3, 0.0, 30.0 * orient_diff)
    y_vel = _deadzone(torch.abs(ri.qvel[1]), 0.05)
    straight_diff = _deadzone(torch.abs(ri.qpos[1]), 0.05)
    return forward_diff, orient_diff, straight_diff, y_vel


def _orient_terms_rotated(ri: SpeedmatchInputs, always: bool = False):
    """Preamble WITH the orientation command active after orient_time
    (speedmatch_rewards.py:7-15, orientchange variant :396-413): the speed
    target rotates into the commanded frame and the orient error is
    measured against the command quaternion. y_offset is always 0 upstream
    (cassie_mininput_env.py:192)."""
    zero = torch.zeros_like(ri.orient_add)
    q_cmd = euler2quat(z=ri.orient_add, y=zero, x=zero)
    iq = quat_inverse(q_cmd)
    speed_t = quat_rotate(iq, torch.stack([ri.speed + zero, zero, zero]))
    if always:
        actual = quat_mul(iq, ri.qpos[3:7])
        orient_diff = 1.0 - actual[0] ** 2
        sx, sy = speed_t[0], speed_t[1]
    else:
        active = torch.as_tensor(ri.time) >= ri.orient_time
        sx = torch.where(active, speed_t[0], ri.speed)
        sy = torch.where(active, speed_t[1], 0.0)
        orient_diff = torch.where(
            active,
            1.0 - torch.sum(q_cmd * ri.qpos[3:7], dim=0) ** 2,
            1.0 - ri.qpos[3] ** 2)
    forward_diff = _deadzone(torch.abs(ri.qvel[0] - sx), 0.05)
    y_vel = _deadzone(torch.abs(ri.qvel[1] - sy), 0.05)
    orient_diff = torch.where(orient_diff < 5e-3, 0.0, 30.0 * orient_diff)
    straight_diff = _deadzone(8.0 * torch.abs(ri.qpos[1]), 8.0 * 0.05)
    return forward_diff, orient_diff, straight_diff, y_vel


def _foot_dist_penalty(ri: SpeedmatchInputs, thresh: float,
                       value: float = -0.2):
    """xy distance between feet below thresh -> flat penalty
    (speedmatch_rewards.py:500-506)."""
    d = _norm(ri.foot_pos[0, 0:2] - ri.foot_pos[1, 0:2])
    return torch.where(d < thresh, value, 0.0)


# ---------------------------------------------------------------------------
# speedmatch_rewards.py (26 live functions)
# ---------------------------------------------------------------------------

def speedmatch_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:4-35 (orient command after orient_time)."""
    f, o, s, y = _orient_terms_rotated(ri)
    return (0.5 * _exp(-f) + 0.2 * _exp(-o)
            + 0.15 * _exp(-s) + 0.15 * _exp(-y))


def speedmatch_footorient_hiprollvelact_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:37-62."""
    f, o, s, y = _orient_terms(ri)
    return (0.3 * _exp(-f) + 0.2 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.075 * _exp(-ri.l_foot_orient)
            + 0.075 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.hiproll_cost)
            + 0.05 * _exp(-ri.hiproll_act))


def old_speed_reward(ri: SpeedmatchInputs):
    """aka 5k_speed_reward (speedmatch_rewards.py:64-80)."""
    diff = _deadzone(torch.abs(ri.qvel[0] - ri.speed), 0.05)
    orient_diff = _unit_quat_dist(ri.qpos[3:7])
    y_vel = _deadzone(torch.abs(ri.qvel[1]), 0.03)
    straight_diff = _deadzone(torch.abs(ri.qpos[1]), 0.05)
    return (0.5 * _exp(-diff) + 0.15 * _exp(-orient_diff)
            + 0.1 * _exp(-y_vel) + 0.25 * _exp(-straight_diff))


def old_speed_footorient_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:82-104."""
    diff = _deadzone(torch.abs(ri.qvel[0] - ri.speed), 0.05)
    orient_diff = _unit_quat_dist(ri.qpos[3:7])
    y_vel = _deadzone(torch.abs(ri.qvel[1]), 0.03)
    straight_diff = _deadzone(torch.abs(ri.qpos[1]), 0.05)
    return (0.4 * _exp(-diff) + 0.1 * _exp(-orient_diff)
            + 0.1 * _exp(-y_vel) + 0.2 * _exp(-straight_diff)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient))


def speedmatch_footheightvelflag_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:106-131."""
    f, o, s, y = _orient_terms(ri)
    return (0.3 * _exp(-f) + 0.2 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost)
            + 0.15 * _exp(-ri.r_foot_cost))


def speedmatch_footheightvelflag_even_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:133-158."""
    f, o, s, y = _orient_terms(ri)
    return (0.3 * _exp(-f) + 0.2 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_even)
            + 0.15 * _exp(-ri.r_foot_cost_even))


def speedmatch_footheightsmooth_footorient_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:160-186."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_smooth)
            + 0.15 * _exp(-ri.r_foot_cost_smooth)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient))


def speedmatch_footheightsmooth_footorient_hiproll_torquecost_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:188-215."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_smooth)
            + 0.15 * _exp(-ri.r_foot_cost_smooth)
            + 0.075 * _exp(-ri.l_foot_orient)
            + 0.075 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.hiproll_cost)
            + 0.05 * _exp(-ri.torque_cost))


def speedmatch_footheightsmooth_footorient_hiproll_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:217-244."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_smooth)
            + 0.15 * _exp(-ri.r_foot_cost_smooth)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.hiproll_cost))


def speedmatch_footheightsmooth_footorient_hiprollvelact_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:246-273."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_smooth)
            + 0.15 * _exp(-ri.r_foot_cost_smooth)
            + 0.075 * _exp(-ri.l_foot_orient)
            + 0.075 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.hiproll_cost)
            + 0.05 * _exp(-ri.hiproll_act))


def speedmatch_footheightsmooth_footorient_hiprollyawvelact_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:275-303."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_smooth)
            + 0.15 * _exp(-ri.r_foot_cost_smooth)
            + 0.05 * _exp(-ri.l_foot_orient)
            + 0.05 * _exp(-ri.r_foot_orient)
            + 0.05 * _exp(-ri.hiproll_cost)
            + 0.05 * _exp(-ri.hiproll_act)
            + 0.05 * _exp(-ri.hipyaw_vel)
            + 0.05 * _exp(-ri.hipyaw_act))


def speedmatch_footheightsmooth_footorient_hiprollyawphasetorque_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:305-332."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_smooth)
            + 0.15 * _exp(-ri.r_foot_cost_smooth)
            + 0.05 * _exp(-ri.l_foot_orient)
            + 0.05 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.left_rollyaw_torque_cost)
            + 0.1 * _exp(-ri.right_rollyaw_torque_cost))


def speedmatch_footvarclock_footorient_hiprollyawvelact_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:334-362."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_var)
            + 0.15 * _exp(-ri.r_foot_cost_var)
            + 0.05 * _exp(-ri.l_foot_orient)
            + 0.05 * _exp(-ri.r_foot_orient)
            + 0.05 * _exp(-ri.hiproll_cost)
            + 0.05 * _exp(-ri.hiproll_act)
            + 0.05 * _exp(-ri.hipyaw_vel)
            + 0.05 * _exp(-ri.hipyaw_act))


def speedmatch_footheightsmooth_footorient_stablepel_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:364-391."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_smooth)
            + 0.15 * _exp(-ri.r_foot_cost_smooth)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.pel_stable))


def speedmatch_footheightsmooth_footorient_hiprollvelact_orientchange_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:393-420 (always rotates into the commanded
    orientation; no straight term)."""
    f, o, _, y = _orient_terms_rotated(ri, always=True)
    return (0.15 * _exp(-f) + 0.15 * _exp(-y) + 0.1 * _exp(-o)
            + 0.15 * _exp(-ri.l_foot_cost_smooth)
            + 0.15 * _exp(-ri.r_foot_cost_smooth)
            + 0.075 * _exp(-ri.l_foot_orient)
            + 0.075 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.hiproll_cost)
            + 0.05 * _exp(-ri.hiproll_act))


def speedmatch_footclock_footorient_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:423-449."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_clock)
            + 0.15 * _exp(-ri.r_foot_cost_clock)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient))


def speedmatch_footheightvelflag_even_footorient_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:451-477."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_even)
            + 0.15 * _exp(-ri.r_foot_cost_even)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient))


def speedmatch_footheightvelflag_even_footorient_footdist_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:479-514 (0.2 m foot-distance penalty)."""
    return (speedmatch_footheightvelflag_even_footorient_reward(ri)
            + _foot_dist_penalty(ri, 0.2))


def speedmatch_footheightvelflag_even_footorient_footdist_torquecost_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:516-551 (0.15 m penalty + torque cost)."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.075 * _exp(-s) + 0.075 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_even)
            + 0.15 * _exp(-ri.r_foot_cost_even)
            + 0.075 * _exp(-ri.l_foot_orient)
            + 0.075 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.torque_cost)
            + _foot_dist_penalty(ri, 0.15))


def speedmatch_footheightvelflag_even_footorient_footdist_torquecost_smooth_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:553-588."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.05 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_even)
            + 0.15 * _exp(-ri.r_foot_cost_even)
            + 0.075 * _exp(-ri.l_foot_orient)
            + 0.075 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.torque_cost)
            + 0.1 * _exp(-ri.smooth_cost)
            + _foot_dist_penalty(ri, 0.15))


def speedmatch_footheightvelflag_even_footorient_smooth_reward(
        ri: SpeedmatchInputs):
    """speedmatch_rewards.py:590-617."""
    f, o, s, y = _orient_terms(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.05 * _exp(-s) + 0.05 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_even)
            + 0.15 * _exp(-ri.r_foot_cost_even)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.smooth_cost))


def speedmatch_footheightvelflag_even_capzvel_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:619-651: -0.4 per foot moving fast vertically
    while flagged high."""
    f, o, s, y = _orient_terms(ri)
    l_pen = torch.where((ri.l_high > 0) & (torch.abs(ri.lfoot_vel[2]) > 0.6),
                      -0.4, 0.0)
    r_pen = torch.where((ri.r_high > 0) & (torch.abs(ri.rfoot_vel[2]) > 0.6),
                      -0.4, 0.0)
    return (0.3 * _exp(-f) + 0.2 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.15 * _exp(-ri.l_foot_cost_even)
            + 0.15 * _exp(-ri.r_foot_cost_even)
            + l_pen + r_pen)


def speedmatch_footorient_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:654-686."""
    f, o, s, y = _orient_terms_rotated(ri)
    return (0.3 * _exp(-f) + 0.2 * _exp(-o)
            + 0.15 * _exp(-s) + 0.15 * _exp(-y)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient))


def speedmatch_footorient_joint_smooth_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:688-723 (reads `self.joint_error`, which no
    live reference env computes — see module docstring)."""
    f, o, s, y = _orient_terms_rotated(ri)
    return (0.25 * _exp(-f) + 0.1 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.smooth_cost)
            + 0.15 * _exp(-ri.joint_error))


def speedmatch_footorient_footheightvel_smooth_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:725-760 (lf/rf_heightvel dead upstream)."""
    f, o, s, y = _orient_terms_rotated(ri)
    return (0.2 * _exp(-f) + 0.1 * _exp(-o)
            + 0.1 * _exp(-s) + 0.1 * _exp(-y)
            + 0.1 * _exp(-ri.lf_heightvel)
            + 0.1 * _exp(-ri.rf_heightvel)
            + 0.1 * _exp(-ri.l_foot_orient)
            + 0.1 * _exp(-ri.r_foot_orient)
            + 0.1 * _exp(-ri.smooth_cost))


def speedmatch_heuristic_reward(ri: SpeedmatchInputs):
    """speedmatch_rewards.py:762-823: the live return line consumes aslip
    task-space tracking terms (com_vel_error, l_foot_diff, ...) that only
    deprecated envs computed; our traj env fills them, others leave 0."""
    # the reference's live expression (speedmatch_rewards.py:820-823):
    return (0.2 * _exp(-ri.com_vel_error) + 0.1 * _exp(-ri.com_error)
            + 0.1 * _exp(-ri.orientation_error)
            + 0.1 * _exp(-20.0 * ri.l_foot_diff)
            + 0.1 * _exp(-5.0 * ri.l_footvel_diff)
            + 0.1 * _exp(-20.0 * ri.r_foot_diff)
            + 0.1 * _exp(-5.0 * ri.r_footvel_diff)
            + 0.1 * _exp(-ri.l_foot_orient_cost)
            + 0.1 * _exp(-ri.r_foot_orient_cost))


# ---------------------------------------------------------------------------
# side_speedmatch_rewards.py (5 live functions)
# ---------------------------------------------------------------------------

def _side_terms(ri: SpeedmatchInputs):
    """side_speedmatch_rewards.py:3-13 preamble."""
    forward_diff = _deadzone(torch.abs(ri.qvel[0] - ri.speed), 0.05)
    orient_diff = _unit_quat_dist(ri.qpos[3:7])
    side_diff = _deadzone(torch.abs(ri.qvel[1] - ri.side_speed), 0.05)
    return forward_diff, orient_diff, side_diff


def side_speedmatch_reward(ri: SpeedmatchInputs):
    """side_speedmatch_rewards.py:3-17."""
    f, o, s = _side_terms(ri)
    return 0.4 * _exp(-f) + 0.4 * _exp(-s) + 0.2 * _exp(-o)


def side_speedmatch_torquesmooth_reward(ri: SpeedmatchInputs):
    """side_speedmatch_rewards.py:19-34."""
    f, o, s = _side_terms(ri)
    return (0.25 * _exp(-f) + 0.25 * _exp(-s) + 0.2 * _exp(-o)
            + 0.1 * _exp(-ri.torque_cost) + 0.2 * _exp(-ri.smooth_cost))


def side_speedmatch_foottraj_reward(ri: SpeedmatchInputs):
    """side_speedmatch_rewards.py:36-53 (foot-traj diffs dead upstream;
    traj env fills them)."""
    f, o, s = _side_terms(ri)
    return (0.15 * _exp(-f) + 0.15 * _exp(-s) + 0.1 * _exp(-o)
            + 0.1 * _exp(-20.0 * ri.l_foot_diff)
            + 0.1 * _exp(-20.0 * ri.r_foot_diff)
            + 0.1 * _exp(-5.0 * ri.l_footvel_diff)
            + 0.1 * _exp(-5.0 * ri.r_footvel_diff)
            + 0.1 * _exp(-ri.l_foot_orient_cost)
            + 0.1 * _exp(-ri.r_foot_orient_cost))


def side_speedmatch_heightvel_reward(ri: SpeedmatchInputs):
    """side_speedmatch_rewards.py:55-72."""
    f, o, s = _side_terms(ri)
    return (0.2 * _exp(-f) + 0.2 * _exp(-s) + 0.1 * _exp(-o)
            + 0.1 * _exp(-ri.l_foot_orient_cost)
            + 0.1 * _exp(-ri.r_foot_orient_cost)
            + 0.15 * _exp(-ri.lf_heightvel)
            + 0.15 * _exp(-ri.rf_heightvel))


def side_speedmatch_heuristic_reward(ri: SpeedmatchInputs):
    """side_speedmatch_rewards.py:74-125: heuristic penalties on foot
    distance, contact force, pelvis z-accel and near-ground slow feet."""
    f, o, s = _side_terms(ri)
    foot_dist = _norm(ri.foot_pos[0, 0:2] - ri.foot_pos[1, 0:2])
    foot_penalty = torch.where(foot_dist < 0.22, 0.2, 0.0)
    lforce = torch.clamp((ri.l_foot_frc - 700.0) / 1000.0, min=0.0)
    rforce = torch.clamp((ri.r_foot_frc - 700.0) / 1000.0, min=0.0)
    pelaccel = torch.abs(ri.pelvis_accel[2])
    pelaccel_penalty = torch.where(pelaccel > 6.0, (pelaccel - 6.0) / 30.0, 0.0)
    l_slow = ((_norm(ri.lfoot_vel) < 0.05)
              & (ri.foot_pos[0, 2] < 0.2) & (ri.l_foot_frc == 0.0))
    r_slow = ((_norm(ri.rfoot_vel) < 0.05)
              & (ri.foot_pos[1, 2] < 0.2) & (ri.r_foot_frc == 0.0))
    footheight_penalty = torch.where(l_slow | r_slow, 0.2, 0.0)
    return (0.25 * _exp(-f) + 0.25 * _exp(-s) + 0.1 * _exp(-o)
            + 0.1 * _exp(-ri.torque_cost) + 0.1 * _exp(-ri.smooth_cost)
            + 0.1 * _exp(-ri.l_foot_orient_cost)
            + 0.1 * _exp(-ri.r_foot_orient_cost)
            - pelaccel_penalty - foot_penalty - lforce - rforce
            - footheight_penalty)


# ---------------------------------------------------------------------------
# standing_rewards.py step_* members (consume the same tracked costs)
# ---------------------------------------------------------------------------

def stand_reward(ri: SpeedmatchInputs):
    """standing_rewards.py:3-12."""
    com_vel = _norm(ri.qvel[0:3])
    com_height = (0.9 - ri.qpos[2]) ** 2
    return 0.5 * _exp(-com_vel) + 0.5 * _exp(-com_height)


def step_even_reward(ri: SpeedmatchInputs):
    """standing_rewards.py:14-24."""
    com_vel = _norm(ri.qvel[0:3])
    com_height = (0.9 - ri.qpos[2]) ** 2
    return (0.2 * _exp(-com_vel) + 0.2 * _exp(-com_height)
            + 0.3 * _exp(-ri.l_foot_cost_even)
            + 0.3 * _exp(-ri.r_foot_cost_even))


def step_even_pelheight_reward(ri: SpeedmatchInputs):
    """standing_rewards.py:26-37 (height error zeroed above 0.8 m)."""
    com_height = torch.where(ri.qpos[2] > 0.8, 0.0, (0.9 - ri.qpos[2]) ** 2)
    return (0.2 * _exp(-com_height)
            + 0.4 * _exp(-ri.l_foot_cost_even)
            + 0.4 * _exp(-ri.r_foot_cost_even))


def step_smooth_pelheight_reward(ri: SpeedmatchInputs):
    """standing_rewards.py:39-49."""
    com_height = torch.where(ri.qpos[2] > 0.8, 0.0, (0.9 - ri.qpos[2]) ** 2)
    return (0.2 * _exp(-com_height)
            + 0.4 * _exp(-ri.l_foot_cost_smooth)
            + 0.4 * _exp(-ri.r_foot_cost_smooth))


def _norm_name(n: str) -> str:
    return n[:-len("_reward")] if n.endswith("_reward") else n


SPEEDMATCH_FUNCS = {}
for _fn in (
        speedmatch_reward,
        speedmatch_footorient_hiprollvelact_reward,
        old_speed_reward,
        old_speed_footorient_reward,
        speedmatch_footheightvelflag_reward,
        speedmatch_footheightvelflag_even_reward,
        speedmatch_footheightsmooth_footorient_reward,
        speedmatch_footheightsmooth_footorient_hiproll_torquecost_reward,
        speedmatch_footheightsmooth_footorient_hiproll_reward,
        speedmatch_footheightsmooth_footorient_hiprollvelact_reward,
        speedmatch_footheightsmooth_footorient_hiprollyawvelact_reward,
        speedmatch_footheightsmooth_footorient_hiprollyawphasetorque_reward,
        speedmatch_footvarclock_footorient_hiprollyawvelact_reward,
        speedmatch_footheightsmooth_footorient_stablepel_reward,
        speedmatch_footheightsmooth_footorient_hiprollvelact_orientchange_reward,
        speedmatch_footclock_footorient_reward,
        speedmatch_footheightvelflag_even_footorient_reward,
        speedmatch_footheightvelflag_even_footorient_footdist_reward,
        speedmatch_footheightvelflag_even_footorient_footdist_torquecost_reward,
        speedmatch_footheightvelflag_even_footorient_footdist_torquecost_smooth_reward,
        speedmatch_footheightvelflag_even_footorient_smooth_reward,
        speedmatch_footheightvelflag_even_capzvel_reward,
        speedmatch_footorient_reward,
        speedmatch_footorient_joint_smooth_reward,
        speedmatch_footorient_footheightvel_smooth_reward,
        speedmatch_heuristic_reward,
        side_speedmatch_reward,
        side_speedmatch_torquesmooth_reward,
        side_speedmatch_foottraj_reward,
        side_speedmatch_heightvel_reward,
        side_speedmatch_heuristic_reward,
        stand_reward,
        step_even_reward,
        step_even_pelheight_reward,
        step_smooth_pelheight_reward,
):
    SPEEDMATCH_FUNCS[_fn.__name__] = _fn          # full reference name
    SPEEDMATCH_FUNCS[_norm_name(_fn.__name__)] = _fn  # short form

# launcher aliases (reference experiment.info reward names)
SPEEDMATCH_FUNCS["5k_speed_reward"] = old_speed_reward
SPEEDMATCH_FUNCS["5k_speed"] = old_speed_reward
