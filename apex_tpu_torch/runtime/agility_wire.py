"""Agility-compatible wire codec: pd_in_t / state_out_t packing.

The reference robot link packs `pd_in_t` to exactly 476 bytes and unpacks
`state_out_t` from exactly 493 bytes (reference include/pd_in_t.h:20
PD_IN_T_PACKED_LEN, include/state_out_t.h:20 STATE_OUT_T_PACKED_LEN,
cassiemujoco.py:414-415 recvlen_pd/sendlen_pd). The packing rule is the
struct's field declaration order with every double transmitted as a
little-endian float32 and every bool as one byte:

  pd_in_t    = leftLeg{taskPd{torque[6] pTarget[6] dTarget[6] pGain[6]
               dGain[6]} motorPd{torque[5] pTarget[5] dTarget[5] pGain[5]
               dGain[5]}} rightLeg{...} telemetry[9]
             = 119 floats = 476 B                    (include/pd_in_t.h:24-49)
  state_out_t= pelvis{position[3] orientation[4] rotationalVelocity[3]
               translationalVelocity[3] translationalAcceleration[3]
               externalMoment[3] externalForce[3]}
               leftFoot{position[3] orientation[4] footRotationalVelocity[3]
               footTranslationalVelocity[3] toeForce[3] heelForce[3]}
               rightFoot{...} terrain{height slope[2]}
               motor{position[10] velocity[10] torque[10]}
               joint{position[6] velocity[6]}
               radio{channel[16] signalGood:u8} battery{stateOfCharge current}
             = 121 floats + 1 byte + 2 floats = 493 B
                                                 (include/state_out_t.h:24-78)

This codec + the native raw framing (native/cassie_udp.cpp apex_send_raw)
make the link byte-compatible with the reference stack / real hardware.

A copy of `apex_tpu/runtime/agility_wire.py` (numpy only), with two
changes: the default PD gains come from the port's
`physics/cassie_sim.py`, and `state_out_from_estimator` reads one env's
column of the port's batch-last estimator output, which may sit on the
GPU, on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np

PD_IN_PACKED_LEN = 476
STATE_OUT_PACKED_LEN = 493


@dataclasses.dataclass
class PdLegIn:
    """pd_leg_in_t: taskPd (6-wide) + motorPd (5-wide)."""
    task_torque: np.ndarray = None
    task_p_target: np.ndarray = None
    task_d_target: np.ndarray = None
    task_p_gain: np.ndarray = None
    task_d_gain: np.ndarray = None
    torque: np.ndarray = None
    p_target: np.ndarray = None
    d_target: np.ndarray = None
    p_gain: np.ndarray = None
    d_gain: np.ndarray = None

    def __post_init__(self):
        for f in ("task_torque", "task_p_target", "task_d_target",
                  "task_p_gain", "task_d_gain"):
            if getattr(self, f) is None:
                setattr(self, f, np.zeros(6, np.float32))
        for f in ("torque", "p_target", "d_target", "p_gain", "d_gain"):
            if getattr(self, f) is None:
                setattr(self, f, np.zeros(5, np.float32))


@dataclasses.dataclass
class PdIn:
    """pd_in_t (include/pd_in_t.h:45-49)."""
    left: PdLegIn = dataclasses.field(default_factory=PdLegIn)
    right: PdLegIn = dataclasses.field(default_factory=PdLegIn)
    telemetry: np.ndarray = None

    def __post_init__(self):
        if self.telemetry is None:
            self.telemetry = np.zeros(9, np.float32)

    @staticmethod
    def from_targets(p_target10, p_gain10=None, d_gain10=None,
                     ff_torque10=None, d_target10=None) -> "PdIn":
        """Build from flat 10-vectors ordered [left(5), right(5)] -- the
        layout the env layer uses (physics/cassie_sim.py PDCommand)."""
        from apex_tpu_torch.physics.cassie_sim import (DEFAULT_D_GAIN,
                                                       DEFAULT_P_GAIN)

        p_target10 = np.asarray(p_target10, np.float32)
        p_gain10 = np.asarray(DEFAULT_P_GAIN if p_gain10 is None
                              else p_gain10, np.float32)
        d_gain10 = np.asarray(DEFAULT_D_GAIN if d_gain10 is None
                              else d_gain10, np.float32)
        ff = np.zeros(10, np.float32) if ff_torque10 is None else \
            np.asarray(ff_torque10, np.float32)
        dt = np.zeros(10, np.float32) if d_target10 is None else \
            np.asarray(d_target10, np.float32)
        pd = PdIn()
        for leg, sl in ((pd.left, slice(0, 5)), (pd.right, slice(5, 10))):
            leg.torque = ff[sl].copy()
            leg.p_target = p_target10[sl].copy()
            leg.d_target = dt[sl].copy()
            leg.p_gain = p_gain10[sl].copy()
            leg.d_gain = d_gain10[sl].copy()
        return pd


def _leg_floats(leg: PdLegIn) -> np.ndarray:
    return np.concatenate([
        leg.task_torque, leg.task_p_target, leg.task_d_target,
        leg.task_p_gain, leg.task_d_gain,
        leg.torque, leg.p_target, leg.d_target, leg.p_gain, leg.d_gain,
    ]).astype(np.float32)


def pack_pd_in(pd: PdIn) -> bytes:
    """pd_in_t -> 476 bytes (pack_pd_in_t equivalent)."""
    flat = np.concatenate([_leg_floats(pd.left), _leg_floats(pd.right),
                           np.asarray(pd.telemetry, np.float32)])
    assert flat.size == 119
    out = flat.astype("<f4").tobytes()
    assert len(out) == PD_IN_PACKED_LEN
    return out


def unpack_pd_in(data: bytes) -> PdIn:
    """476 bytes -> pd_in_t (unpack_pd_in_t equivalent; the robot/sim side)."""
    assert len(data) == PD_IN_PACKED_LEN, len(data)
    flat = np.frombuffer(data, dtype="<f4")

    def leg(o):
        return PdLegIn(
            task_torque=flat[o:o + 6].copy(),
            task_p_target=flat[o + 6:o + 12].copy(),
            task_d_target=flat[o + 12:o + 18].copy(),
            task_p_gain=flat[o + 18:o + 24].copy(),
            task_d_gain=flat[o + 24:o + 30].copy(),
            torque=flat[o + 30:o + 35].copy(),
            p_target=flat[o + 35:o + 40].copy(),
            d_target=flat[o + 40:o + 45].copy(),
            p_gain=flat[o + 45:o + 50].copy(),
            d_gain=flat[o + 50:o + 55].copy(),
        )

    return PdIn(left=leg(0), right=leg(55),
                telemetry=flat[110:119].copy())


@dataclasses.dataclass
class StateFoot:
    position: np.ndarray
    orientation: np.ndarray
    rotational_velocity: np.ndarray
    translational_velocity: np.ndarray
    toe_force: np.ndarray
    heel_force: np.ndarray


@dataclasses.dataclass
class StateOut:
    """state_out_t (include/state_out_t.h:69-78)."""
    pelvis_position: np.ndarray
    pelvis_orientation: np.ndarray
    pelvis_rotational_velocity: np.ndarray
    pelvis_translational_velocity: np.ndarray
    pelvis_translational_acceleration: np.ndarray
    pelvis_external_moment: np.ndarray
    pelvis_external_force: np.ndarray
    left_foot: StateFoot = None
    right_foot: StateFoot = None
    terrain_height: float = 0.0
    terrain_slope: np.ndarray = None
    motor_position: np.ndarray = None
    motor_velocity: np.ndarray = None
    motor_torque: np.ndarray = None
    joint_position: np.ndarray = None
    joint_velocity: np.ndarray = None
    radio_channel: np.ndarray = None
    radio_signal_good: bool = True
    battery_state_of_charge: float = 1.0
    battery_current: float = 0.0


def _foot_floats(f: StateFoot) -> np.ndarray:
    return np.concatenate([f.position, f.orientation, f.rotational_velocity,
                           f.translational_velocity, f.toe_force,
                           f.heel_force]).astype(np.float32)


def pack_state_out(s: StateOut) -> bytes:
    """state_out_t -> 493 bytes (pack_state_out_t equivalent; sim side)."""
    z3 = np.zeros(3, np.float32)
    floats_head = np.concatenate([
        s.pelvis_position, s.pelvis_orientation,
        s.pelvis_rotational_velocity, s.pelvis_translational_velocity,
        s.pelvis_translational_acceleration,
        s.pelvis_external_moment if s.pelvis_external_moment is not None
        else z3,
        s.pelvis_external_force if s.pelvis_external_force is not None
        else z3,
        _foot_floats(s.left_foot), _foot_floats(s.right_foot),
        np.asarray([s.terrain_height], np.float32),
        np.zeros(2, np.float32) if s.terrain_slope is None
        else np.asarray(s.terrain_slope, np.float32),
        s.motor_position, s.motor_velocity, s.motor_torque,
        s.joint_position, s.joint_velocity,
        np.zeros(16, np.float32) if s.radio_channel is None
        else np.asarray(s.radio_channel, np.float32),
    ]).astype("<f4")
    assert floats_head.size == 121, floats_head.size
    tail = np.asarray([s.battery_state_of_charge, s.battery_current],
                      "<f4").tobytes()
    out = (floats_head.tobytes()
           + bytes([1 if s.radio_signal_good else 0]) + tail)
    assert len(out) == STATE_OUT_PACKED_LEN
    return out


def unpack_state_out(data: bytes) -> StateOut:
    """493 bytes -> state_out_t (unpack_state_out_t equivalent)."""
    assert len(data) == STATE_OUT_PACKED_LEN, len(data)
    head = np.frombuffer(data[:484], dtype="<f4")
    signal_good = bool(data[484])
    battery = np.frombuffer(data[485:493], dtype="<f4")

    def foot(o):
        return StateFoot(
            position=head[o:o + 3].copy(),
            orientation=head[o + 3:o + 7].copy(),
            rotational_velocity=head[o + 7:o + 10].copy(),
            translational_velocity=head[o + 10:o + 13].copy(),
            toe_force=head[o + 13:o + 16].copy(),
            heel_force=head[o + 16:o + 19].copy(),
        )

    return StateOut(
        pelvis_position=head[0:3].copy(),
        pelvis_orientation=head[3:7].copy(),
        pelvis_rotational_velocity=head[7:10].copy(),
        pelvis_translational_velocity=head[10:13].copy(),
        pelvis_translational_acceleration=head[13:16].copy(),
        pelvis_external_moment=head[16:19].copy(),
        pelvis_external_force=head[19:22].copy(),
        left_foot=foot(22),
        right_foot=foot(41),
        terrain_height=float(head[60]),
        terrain_slope=head[61:63].copy(),
        motor_position=head[63:73].copy(),
        motor_velocity=head[73:83].copy(),
        motor_torque=head[83:93].copy(),
        joint_position=head[93:99].copy(),
        joint_velocity=head[99:105].copy(),
        radio_channel=head[105:121].copy(),
        radio_signal_good=signal_good,
        battery_state_of_charge=float(battery[0]),
        battery_current=float(battery[1]),
    )


def state_out_from_estimator(est, motor_torque=None, toe_heel=None,
                             ext_force=None, env: int = 0) -> StateOut:
    """Build a wire StateOut from env `env` of the sim estimator output
    (physics/cassie_sim.py CassieStateOut, batch-last tensors on any
    device) -- the role CassieCoreSim plays when serving a simulated robot
    over UDP. `motor_torque`, `toe_heel` and `ext_force` are that env's
    host arrays, where given."""

    def a(x):
        return np.asarray(x.detach()[..., env].cpu().numpy(), np.float32)

    z3 = np.zeros(3, np.float32)
    th = (np.zeros((2, 2, 3), np.float32) if toe_heel is None
          else np.asarray(toe_heel, np.float32))
    ext = None if ext_force is None else np.asarray(ext_force, np.float32)
    feet = []
    for i, (pos, quat) in enumerate((
            (est.left_foot_position, est.left_foot_orientation),
            (est.right_foot_position, est.right_foot_orientation))):
        feet.append(StateFoot(
            position=a(pos), orientation=a(quat),
            rotational_velocity=z3.copy(),
            translational_velocity=z3.copy(),
            toe_force=th[i, 0].copy(), heel_force=th[i, 1].copy()))
    return StateOut(
        pelvis_position=a(est.pelvis_position),
        pelvis_orientation=a(est.pelvis_orientation),
        pelvis_rotational_velocity=a(est.pelvis_rot_vel),
        pelvis_translational_velocity=a(est.pelvis_trans_vel),
        pelvis_translational_acceleration=a(est.pelvis_trans_accel),
        pelvis_external_moment=z3 if ext is None else ext[:3],
        pelvis_external_force=z3 if ext is None else ext[3:],
        left_foot=feet[0], right_foot=feet[1],
        terrain_height=float(a(est.terrain_height)),
        motor_position=a(est.motor_position),
        motor_velocity=a(est.motor_velocity),
        motor_torque=(a(est.motor_torque) if motor_torque is None
                      else np.asarray(motor_torque, np.float32)),
        joint_position=a(est.joint_position),
        joint_velocity=a(est.joint_velocity),
    )
