"""Cassie simulation layer: PD drives, 2 kHz substep, state estimator.

Port of `apex_tpu/physics/cassie_sim.py` for the fleet: the PD scan runs
`length` substeps through one of three tiers, as the JAX package does: the
whole-substep kernel K1 (`physics/fleet_kernel.py`, the JAX package's path
on its accelerator), the batch-last fleet step (`physics/fleet.py`, its
path on the CPU and GPU backends), or the per-env engine
(`physics/engine.py`, its reference path under APEX_TPU_NO_FLEET=1, the
`_pd_scan_single` loop under vmap). Every state here is batch-last: qpos
(35, B), PD command rows (10, B); the per-env tier converts to its
batch-first layout once per scan.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import const
from apex_tpu_torch.physics import engine, fleet, fleet_kernel
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


PD_TIERS = ("megakernel", "fleet", "per_env")


def pd_scan(model: PhysModel, params: PhysParams, phys: CassiePhysState,
            cmd: PDCommand, length: int, tier: str | None = None):
    """`length` PD substeps (the 2 kHz control-step loop) of the fleet.

    Returns (phys_final, diag_seq, qvel_seq, qacc_seq): diag_seq leaves
    carry a leading (length,) substep axis, qvel/qacc_seq are
    (length, nv, B) -- the post-substep streams the env tracking layer
    reduces. `tier` is "megakernel" (one K1 launch per substep,
    `_megakernel_pd_scan`), "fleet" (the batch-last fleet step) or
    "per_env" (the per-env engine, `_pd_scan_single` under vmap); None
    takes the megakernel for CUDA tensors and the fleet on the CPU, the
    split `_fleet_pd_scan` makes by backend (cassie_sim.py:292-300).

    Reference parity anchor: the simrate x cassie_sim_step_pd loop
    (cassie.py:410-433, include/cassiemujoco.h:80)."""
    if tier is None:
        tier = "megakernel" if phys.qpos.device.type == "cuda" else "fleet"
    if tier == "megakernel":
        return _megakernel_pd_scan(model, params, phys, cmd, length)
    if tier == "per_env":
        return _per_env_pd_scan(model, params, phys, cmd, length)
    if tier != "fleet":
        raise ValueError(f"pd_scan: tier must be one of {PD_TIERS}, got "
                         f"{tier!r}")
    return _fleet_pd_scan(model, params, phys, cmd, length)


def _megakernel_pd_scan(model: PhysModel, params: PhysParams,
                        phys: CassiePhysState, cmd: PDCommand, length: int):
    """Port of `_megakernel_pd_scan` (cassie_sim.py:376-447): the command
    and parameter rows stacked once, then `length` K1 substeps, each giving
    the new state and the 44 diagnostic rows that rebuild `SubstepDiag`.
    Inside `fleet_kernel.partitioned` the fleet is this rank's shard and
    every substep is a K1-part launch on it (the JAX package's
    `_partitioned_invoke` under a mesh); the scan itself splits nothing."""
    cmd_rows = torch.cat([cmd.p_target, cmd.d_target, cmd.p_gain,
                          cmd.d_gain, cmd.ff_torque], dim=0)   # (5 nu, B)
    static = fleet_kernel.static_rows(model, params)
    substep = (fleet_kernel.pd_substep
               if fleet_kernel.active_partition() is None
               else fleet_kernel.partitioned_pd_substep)
    qpos, qvel = phys.qpos, phys.qvel
    diags, qvels, qaccs = [], [], []
    for _ in range(length):
        qpos, qvel, qacc, diag_rows = substep(
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


def pd_control(model: PhysModel, qpos: torch.Tensor, qvel: torch.Tensor,
               cmd: PDCommand) -> torch.Tensor:
    """The PD torque law tau = P (pT - q) + D (dT - qd) + ff per env
    (cassie_sim.py:137-153), batch-first: qpos (B, nq), qvel (B, nv), the
    command's fields (B, 10). Returns the actuator controls tau / gear
    (B, nu); the engine clips them to the control range."""
    dev = qpos.device
    q = qpos[:, const(MOTOR_QPOS_IDX, dev, torch.int64)]
    qd = qvel[:, const(MOTOR_QVEL_IDX, dev, torch.int64)]
    tau = (cmd.p_gain * (cmd.p_target - q) + cmd.d_gain * (cmd.d_target - qd)
           + cmd.ff_torque)
    return tau / const([a.gear for a in model.actuators], dev)


def pd_substep(model: PhysModel, params_bf: PhysParams, qpos: torch.Tensor,
               qvel: torch.Tensor, cmd: PDCommand):
    """One 0.5 ms substep under PD control on the per-env engine
    (cassie_sim.py:171-207), batch-first (`pd_control`'s layout, params
    from `engine.params_batch_first`). Returns (engine.StepOut, the
    substep's diagnostics as a batch-first `SubstepDiag`)."""
    ctrl = pd_control(model, qpos, qvel, cmd)
    out = engine.step(model, params_bf, qpos, qvel, ctrl)
    lf, rf, lcon, rcon = _feet(model)
    force, vel, kin = out.contact.force, out.contact.vel, out.kin
    origin = kin.origin
    diag = SubstepDiag(
        foot_frc_z=torch.stack([sum(force[:, i, 2] for i in lcon),
                                sum(force[:, i, 2] for i in rcon)], dim=1),
        foot_pos=torch.stack([kin.xpos[:, lf] + origin,
                              kin.xpos[:, rf] + origin], dim=1),
        foot_vel=torch.stack([(vel[:, lcon[0]] + vel[:, lcon[1]]) / 2.0,
                              (vel[:, rcon[0]] + vel[:, rcon[1]]) / 2.0],
                             dim=1),
        foot_quat=torch.stack([kin.xquat[:, lf], kin.xquat[:, rf]], dim=1),
        toe_heel_force=torch.stack([
            torch.stack([force[:, lcon[0]], force[:, lcon[1]]], dim=1),
            torch.stack([force[:, rcon[0]], force[:, rcon[1]]], dim=1)],
            dim=1),
        motor_torque=out.actuator_torque)
    return out, diag


def _per_env_pd_scan(model: PhysModel, params: PhysParams,
                     phys: CassiePhysState, cmd: PDCommand, length: int):
    """`_pd_scan_single` (cassie_sim.py:236-245) under vmap: `length`
    `pd_substep`s of the per-env engine, with the layout converted once
    each way: the batch-last params, state and command to batch-first
    before the loop, the streams back to batch-last after it."""
    params_bf = engine.params_batch_first(params)
    cmd_bf = PDCommand(*(x.T for x in dataclasses.astuple(cmd)))
    qpos, qvel = phys.qpos.T, phys.qvel.T
    diags, qvels, qaccs = [], [], []
    for _ in range(length):
        out, diag = pd_substep(model, params_bf, qpos, qvel, cmd_bf)
        qpos, qvel = out.qpos, out.qvel
        diags.append(diag)
        qvels.append(qvel)
        qaccs.append(out.qacc)
    # (L, B, ...) -> (L, ..., B)
    bl = lambda xs: torch.movedim(torch.stack(xs), 1, -1).contiguous()
    diag_seq = SubstepDiag(*(bl(x) for x in zip(*diags)))
    qacc_seq = bl(qaccs)
    return (CassiePhysState(qpos=qpos.T.contiguous(),
                            qvel=qvel.T.contiguous(), qacc=qacc_seq[-1]),
            diag_seq, bl(qvels), qacc_seq)


def settle(model: PhysModel, params: PhysParams, state: CassiePhysState,
           n_substeps: int = 400, tier: str | None = None
           ) -> CassiePhysState:
    """Hold the neutral PD targets for n substeps so the soft loop closures
    and contacts converge to a consistent standing state
    (cassie_sim.py:518-529), on `pd_scan`'s tier."""
    B = state.qpos.shape[-1]
    target = const(NEUTRAL_OFFSET, state.qpos.device)[:, None].expand(10, B)
    return pd_scan(model, params, state, PDCommand.from_targets(target),
                   n_substeps, tier)[0]


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
                state: CassiePhysState, tier: str | None = None
                ) -> SubstepDiag:
    """FK-only diagnostics (no step): foot poses from kinematics, zero
    forces and velocities. The FK is the fleet's (one K2 launch on the GPU)
    on the megakernel and fleet tiers, and the per-env engine's, with no
    kernel, on the per-env tier, as JAX computes it under
    APEX_TPU_NO_FLEET (cassie_sim.py:499-515)."""
    lf, rf, _, _ = _feet(model)
    z = state.qpos.new_zeros
    B = state.qpos.shape[-1]
    if tier == "per_env":
        kin = engine.forward_kinematics(
            model, engine.params_batch_first(params), state.qpos.T)
        origin = kin.origin[:, None]
        foot_pos = torch.stack([kin.xpos[:, lf], kin.xpos[:, rf]], dim=1) \
            + origin
        foot_quat = torch.stack([kin.xquat[:, lf], kin.xquat[:, rf]], dim=1)
        foot_pos, foot_quat = (torch.movedim(x, 0, -1).contiguous()
                               for x in (foot_pos, foot_quat))
    else:
        kin = fleet.fleet_fk(model, params.body_ipos, state.qpos)
        feet = const([lf, rf], state.qpos.device, torch.int64)
        foot_pos = kin.xpos[feet] + kin.origin
        foot_quat = fleet._mat2quat_bt(kin.ximat[feet])
    return SubstepDiag(
        foot_frc_z=z((2, B)),
        foot_pos=foot_pos,
        foot_vel=z((2, 3, B)),
        foot_quat=foot_quat,
        toe_heel_force=z((2, 2, 3, B)),
        motor_torque=z((10, B)),
    )
