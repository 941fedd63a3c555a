"""Cassie simulation layer: PD drives, 2 kHz substep, state estimator.

Port of `apex_tpu/physics/cassie_sim.py` for the fleet: the PD scan runs
`length` substeps through one of two tiers, as `_fleet_pd_scan` does in the
JAX package: the whole-substep kernel K1 (`physics/fleet_kernel.py`, the
JAX package's path on its accelerator) or the batch-last fleet step
(`physics/fleet.py`, its path on the CPU and GPU backends). Every state
here is batch-last: qpos (35, B), PD command rows (10, B).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import const
from apex_tpu_torch.physics import fleet, fleet_kernel
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.physics.models.cassie_gen import make_model
from apex_tpu_torch.physics.spec import PhysModel

# ---------------------------------------------------------------------------
# index maps (reference cassie.py:100-104 and include/cassiemujoco.h qpos
# docs; the achilles ball and passive linkage dofs are interleaved)
# ---------------------------------------------------------------------------

MOTOR_QPOS_IDX = np.array([7, 8, 9, 14, 20, 21, 22, 23, 28, 34])
MOTOR_QVEL_IDX = np.array([6, 7, 8, 12, 18, 19, 20, 21, 25, 31])
JOINT_QPOS_IDX = np.array([15, 16, 20, 29, 30, 34])   # shin, tarsus, foot x2
JOINT_QVEL_IDX = np.array([13, 14, 18, 26, 27, 31])

# default PD gains (reference cassie.py:57-58)
DEFAULT_P_GAIN = np.array([100.0, 100.0, 88.0, 96.0, 50.0] * 2)
DEFAULT_D_GAIN = np.array([10.0, 10.0, 8.0, 9.6, 5.0] * 2)

# neutral motor offsets = standing pose motor angles (cassie.py:107)
NEUTRAL_OFFSET = np.array([0.0045, 0.0, 0.4973, -1.1997, -1.5968,
                           0.0045, 0.0, 0.4973, -1.1997, -1.5968])

# Standing configuration with closed loops (the pose cassie_sim_set_const
# resets to; motor/joint values match reference reset_cassie_state,
# cassie.py:737-746).
CASSIE_QPOS_INIT = np.array([
    0.0, 0.0, 1.01,               # pelvis pos
    1.0, 0.0, 0.0, 0.0,           # pelvis quat
    0.0045, 0.0, 0.4973,          # left hip roll/yaw/pitch
    0.9785, -0.0164, 0.01787, -0.2049,   # left achilles rod quat
    -1.1997,                      # left knee
    0.0, 1.4267,                  # left shin (spring), tarsus
    -0.0, -1.5244, 1.5244,        # left heel spring, foot crank, plantar rod
    -1.5968,                      # left foot
    -0.0045, 0.0, 0.4973,         # right hip roll/yaw/pitch
    0.9786, 0.00386, -0.01524, -0.2051,  # right achilles rod quat
    -1.1997,
    0.0, 1.4267,
    -0.0, -1.5244, 1.5244,
    -1.5968,
])

_MODELS = {}


def cassie_model(enable_hfield: bool = False) -> PhysModel:
    """Canonical Cassie PhysModel, flat-ground or with the heightfield
    terrain branch (cached per variant, so the structure and kernel-table
    caches hung off the instance are shared by every env)."""
    m = _MODELS.get(enable_hfield)
    if m is None:
        m = make_model()
        if enable_hfield:
            m = dataclasses.replace(m, enable_hfield=True)
        _MODELS[enable_hfield] = m
    return m


@dataclasses.dataclass
class CassiePhysState:
    qpos: torch.Tensor   # (35, B)
    qvel: torch.Tensor   # (32, B)
    qacc: torch.Tensor   # (32, B) last-substep acceleration (IMU output)

    @staticmethod
    def standing(batch: int, device: torch.device) -> "CassiePhysState":
        qpos = const(CASSIE_QPOS_INIT, device)
        return CassiePhysState(
            qpos=qpos[:, None].expand(35, batch).contiguous(),
            qvel=torch.zeros((32, batch), device=device),
            qacc=torch.zeros((32, batch), device=device))


@dataclasses.dataclass
class PDCommand:
    """pd_in_t equivalent (include/pd_in_t.h:24-49), both legs flattened to
    rows ordered [left(5), right(5)], batch-last (10, B)."""
    p_target: torch.Tensor
    d_target: torch.Tensor
    p_gain: torch.Tensor
    d_gain: torch.Tensor
    ff_torque: torch.Tensor

    @staticmethod
    def from_targets(p_target: torch.Tensor, p_gain: torch.Tensor = None,
                     d_gain: torch.Tensor = None) -> "PDCommand":
        """PD targets (10, B) with per-env gains (10, B), or the default
        gains where none are given (cassie_sim.py:115-123)."""
        f32 = lambda x: const(x, p_target.device, p_target.dtype)
        default = lambda g: f32(g)[:, None].expand_as(p_target)
        return PDCommand(
            p_target=p_target,
            d_target=torch.zeros_like(p_target),
            p_gain=default(DEFAULT_P_GAIN) if p_gain is None else p_gain,
            d_gain=default(DEFAULT_D_GAIN) if d_gain is None else d_gain,
            ff_torque=torch.zeros_like(p_target))


class SubstepDiag(NamedTuple):
    """Per-substep diagnostics the env layer accumulates (reference
    step_simulation/step, cassie.py:293-443), batch-last."""
    foot_frc_z: torch.Tensor      # (2, B) left/right vertical contact force
    foot_pos: torch.Tensor        # (2, 3, B) world foot body positions
    foot_vel: torch.Tensor        # (2, 3, B) world foot linear velocities
    foot_quat: torch.Tensor       # (2, 4, B) foot body orientations
    toe_heel_force: torch.Tensor  # (2, 2, 3, B) [foot][toe/heel] forces
    motor_torque: torch.Tensor    # (10, B) applied joint torques


def _feet(model: PhysModel):
    """(left foot body, right foot body, left contacts, right contacts)."""
    left = [i for i, c in enumerate(model.contacts) if c.group == 0]
    right = [i for i, c in enumerate(model.contacts) if c.group == 1]
    return model.body_id("left-foot"), model.body_id("right-foot"), left, right


PD_TIERS = ("megakernel", "fleet")


def pd_scan(model: PhysModel, params: PhysParams, phys: CassiePhysState,
            cmd: PDCommand, length: int, tier: str | None = None):
    """`length` PD substeps (the 2 kHz control-step loop) of the fleet.

    Returns (phys_final, diag_seq, qvel_seq, qacc_seq): diag_seq leaves
    carry a leading (length,) substep axis, qvel/qacc_seq are
    (length, nv, B) -- the post-substep streams the env tracking layer
    reduces. `tier` is "megakernel" (one K1 launch per substep,
    `_megakernel_pd_scan`) or "fleet" (the batch-last fleet step); None
    takes the megakernel for CUDA tensors and the fleet on the CPU, the
    split `_fleet_pd_scan` makes by backend (cassie_sim.py:292-300).

    Reference parity anchor: the simrate x cassie_sim_step_pd loop
    (cassie.py:410-433, include/cassiemujoco.h:80)."""
    if tier is None:
        tier = "megakernel" if phys.qpos.device.type == "cuda" else "fleet"
    if tier == "megakernel":
        return _megakernel_pd_scan(model, params, phys, cmd, length)
    if tier != "fleet":
        raise ValueError(f"pd_scan: tier must be one of {PD_TIERS}, got "
                         f"{tier!r}")
    return _fleet_pd_scan(model, params, phys, cmd, length)


def _megakernel_pd_scan(model: PhysModel, params: PhysParams,
                        phys: CassiePhysState, cmd: PDCommand, length: int):
    """Port of `_megakernel_pd_scan` (cassie_sim.py:376-447): the command
    and parameter rows stacked once, then `length` K1 substeps, each giving
    the new state and the 44 diagnostic rows that rebuild `SubstepDiag`."""
    cmd_rows = torch.cat([cmd.p_target, cmd.d_target, cmd.p_gain,
                          cmd.d_gain, cmd.ff_torque], dim=0)   # (5 nu, B)
    static = fleet_kernel.static_rows(model, params)
    qpos, qvel = phys.qpos, phys.qvel
    diags, qvels, qaccs = [], [], []
    for _ in range(length):
        qpos, qvel, qacc, diag_rows = fleet_kernel.pd_substep(
            model, params, qpos, qvel, cmd_rows, static)
        diags.append(diag_rows)
        qvels.append(qvel)
        qaccs.append(qacc)
    d = torch.stack(diags)                                     # (L, 44, B)
    L, B = length, qpos.shape[-1]
    diag_seq = SubstepDiag(
        foot_frc_z=d[:, 0:2],
        foot_pos=d[:, 2:8].reshape(L, 2, 3, B),
        foot_vel=d[:, 8:14].reshape(L, 2, 3, B),
        foot_quat=d[:, 14:22].reshape(L, 2, 4, B),
        toe_heel_force=d[:, 22:34].reshape(L, 2, 2, 3, B),
        motor_torque=d[:, 34:34 + model.nu])
    qacc_seq = torch.stack(qaccs)
    return (CassiePhysState(qpos=qpos, qvel=qvel, qacc=qacc_seq[-1]),
            diag_seq, torch.stack(qvels), qacc_seq)


def _fleet_pd_scan(model: PhysModel, params: PhysParams,
                   phys: CassiePhysState, cmd: PDCommand, length: int):
    """Port of `_fleet_pd_scan`'s fleet branch (cassie_sim.py:302-347): PD
    law, fleet_step, diagnostics, per substep."""
    dev = phys.qpos.device
    gear = const([a.gear for a in model.actuators], dev)[:, None]
    lf, rf, lcon, rcon = _feet(model)
    mq = const(MOTOR_QPOS_IDX, dev, torch.int64)
    mv = const(MOTOR_QVEL_IDX, dev, torch.int64)
    feet = const([lf, rf], dev, torch.int64)
    cons = const([lcon[0], lcon[1], rcon[0], rcon[1]], dev, torch.int64)

    qpos, qvel = phys.qpos, phys.qvel
    diags, qvels, qaccs = [], [], []
    for _ in range(length):
        tau = (cmd.p_gain * (cmd.p_target - qpos[mq])
               + cmd.d_gain * (cmd.d_target - qvel[mv]) + cmd.ff_torque)
        dyn, contact, qpos, qvel, qacc, act_torque = fleet.fleet_step(
            model, params, qpos, qvel, tau / gear)
        kin = dyn.kin
        force = contact.force[cons].reshape(2, 2, 3, -1)  # [foot][toe/heel]
        diags.append(SubstepDiag(
            foot_frc_z=force[:, 0, 2] + force[:, 1, 2],
            foot_pos=kin.xpos[feet] + kin.origin,
            foot_vel=contact.vel[cons].reshape(2, 2, 3, -1).sum(1) / 2.0,
            foot_quat=fleet._mat2quat_bt(kin.ximat[feet]),
            toe_heel_force=force,
            motor_torque=act_torque))
        qvels.append(qvel)
        qaccs.append(qacc)

    diag_seq = SubstepDiag(*(torch.stack(x) for x in zip(*diags)))
    qacc_seq = torch.stack(qaccs)
    return (CassiePhysState(qpos=qpos, qvel=qvel, qacc=qacc_seq[-1]),
            diag_seq, torch.stack(qvels), qacc_seq)


@dataclasses.dataclass
class CassieStateOut:
    """state_out_t equivalent (include/state_out_t.h:24-78), restricted to
    the fields the env layer consumes (cassie.py:818-850), batch-last."""
    pelvis_position: torch.Tensor            # (3, B)
    pelvis_orientation: torch.Tensor         # (4, B)
    pelvis_rot_vel: torch.Tensor             # (3, B) body frame (gyro)
    pelvis_trans_vel: torch.Tensor           # (3, B) world frame
    pelvis_trans_accel: torch.Tensor         # (3, B)
    motor_position: torch.Tensor             # (10, B)
    motor_velocity: torch.Tensor             # (10, B)
    motor_torque: torch.Tensor               # (10, B)
    joint_position: torch.Tensor             # (6, B)
    joint_velocity: torch.Tensor             # (6, B)
    left_foot_position: torch.Tensor         # (3, B) relative to pelvis
    right_foot_position: torch.Tensor        # (3, B)
    left_foot_orientation: torch.Tensor      # (4, B)
    right_foot_orientation: torch.Tensor     # (4, B)
    terrain_height: torch.Tensor             # (B,)


def estimate_state(model: PhysModel, state: CassiePhysState,
                   diag: SubstepDiag) -> CassieStateOut:
    """The firmware state-estimator outputs from sim state (true values,
    as in the JAX package: no estimator transients here; the env adds the
    firmware filter lag)."""
    qpos, qvel = state.qpos, state.qvel
    dev = qpos.device
    pelvis_pos = qpos[0:3]
    return CassieStateOut(
        pelvis_position=pelvis_pos,
        pelvis_orientation=qpos[3:7],
        pelvis_rot_vel=qvel[3:6],
        pelvis_trans_vel=qvel[0:3],
        pelvis_trans_accel=state.qacc[0:3],
        motor_position=qpos[const(MOTOR_QPOS_IDX, dev, torch.int64)],
        motor_velocity=qvel[const(MOTOR_QVEL_IDX, dev, torch.int64)],
        motor_torque=diag.motor_torque,
        joint_position=qpos[const(JOINT_QPOS_IDX, dev, torch.int64)],
        joint_velocity=qvel[const(JOINT_QVEL_IDX, dev, torch.int64)],
        left_foot_position=diag.foot_pos[0] - pelvis_pos,
        right_foot_position=diag.foot_pos[1] - pelvis_pos,
        left_foot_orientation=diag.foot_quat[0],
        right_foot_orientation=diag.foot_quat[1],
        terrain_height=torch.zeros_like(qpos[0]),
    )


def static_diag(model: PhysModel, params: PhysParams,
                state: CassiePhysState) -> SubstepDiag:
    """FK-only diagnostics (no step): foot poses from kinematics (one K2
    launch on the GPU), zero forces and velocities."""
    kin = fleet.fleet_fk(model, params.body_ipos, state.qpos)
    lf, rf, _, _ = _feet(model)
    feet = const([lf, rf], state.qpos.device, torch.int64)
    z = state.qpos.new_zeros
    B = state.qpos.shape[-1]
    return SubstepDiag(
        foot_frc_z=z((2, B)),
        foot_pos=kin.xpos[feet] + kin.origin,
        foot_vel=z((2, 3, B)),
        foot_quat=fleet._mat2quat_bt(kin.ximat[feet]),
        toe_heel_force=z((2, 2, 3, B)),
        motor_torque=z((10, B)),
    )
