"""The port's hardware link (`runtime/agility_wire.py`, `runtime/
udp_link.py`) against the JAX package's: the Agility codecs exchange
packets byte for byte both ways, `state_out_from_estimator` agrees on the
standing state, and the loopback round trips of tests/test_udp_link.py run
through the port (on ports of their own: xdist runs the two files at
once)."""
import shutil

import numpy as np
import pytest
import torch

from apex_tpu.physics.cassie_sim import CassiePhysState as JaxPhysState
from apex_tpu.physics.cassie_sim import cassie_model as jax_cassie_model
from apex_tpu.physics.cassie_sim import estimate_state as jax_estimate
from apex_tpu.physics.cassie_sim import static_diag as jax_static_diag
from apex_tpu.physics.engine import PhysParams as JaxPhysParams
from apex_tpu.runtime import agility_wire as jax_aw
from apex_tpu_torch.physics.cassie_sim import (CassiePhysState, cassie_model,
                                               estimate_state, static_diag)
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.runtime import agility_wire as aw

g_pp = shutil.which("g++")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per process, as the port's other test files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pd(mod, rng):
    pd = mod.PdIn.from_targets(
        rng.standard_normal(10).astype(np.float32),
        p_gain10=rng.uniform(10, 100, 10).astype(np.float32),
        ff_torque10=rng.standard_normal(10).astype(np.float32),
        d_target10=rng.standard_normal(10).astype(np.float32))
    pd.telemetry = rng.standard_normal(9).astype(np.float32)
    pd.left.task_p_gain = rng.standard_normal(6).astype(np.float32)
    return pd


def _state_out(mod, rng):
    f = lambda n: rng.standard_normal(n).astype(np.float32)
    foot = lambda: mod.StateFoot(
        position=f(3), orientation=f(4), rotational_velocity=f(3),
        translational_velocity=f(3), toe_force=f(3), heel_force=f(3))
    return mod.StateOut(
        pelvis_position=f(3), pelvis_orientation=f(4),
        pelvis_rotational_velocity=f(3), pelvis_translational_velocity=f(3),
        pelvis_translational_acceleration=f(3), pelvis_external_moment=f(3),
        pelvis_external_force=f(3), left_foot=foot(), right_foot=foot(),
        terrain_height=0.125, terrain_slope=f(2), motor_position=f(10),
        motor_velocity=f(10), motor_torque=f(10), joint_position=f(6),
        joint_velocity=f(6), radio_channel=f(16), radio_signal_good=False,
        battery_state_of_charge=0.875, battery_current=3.5)


@pytest.mark.parametrize("what", ["pd_in", "state_out"])
def test_codecs_exchange_packets_with_jax_byte_for_byte(what):
    """The same pd_in_t / state_out_t built in both stacks packs to the
    same 476 / 493 bytes; each stack unpacks the other's packet into
    fields that pack back to those bytes."""
    pack, unpack, make = {
        "pd_in": ("pack_pd_in", "unpack_pd_in", _pd),
        "state_out": ("pack_state_out", "unpack_state_out", _state_out),
    }[what]
    ours = getattr(aw, pack)(make(aw, np.random.default_rng(7)))
    theirs = getattr(jax_aw, pack)(make(jax_aw, np.random.default_rng(7)))
    assert len(ours) == {"pd_in": 476, "state_out": 493}[what]
    assert ours == theirs
    assert getattr(aw, pack)(getattr(aw, unpack)(theirs)) == theirs
    assert getattr(jax_aw, pack)(getattr(jax_aw, unpack)(ours)) == ours


def test_pd_from_targets_takes_the_ports_default_gains():
    t = np.linspace(-1, 1, 10).astype(np.float32)
    assert aw.pack_pd_in(aw.PdIn.from_targets(t)) == jax_aw.pack_pd_in(
        jax_aw.PdIn.from_targets(t))


def test_state_out_from_estimator_matches_jax_on_the_standing_state():
    """The standing pose through each stack's estimator and static
    diagnostics (the port's batch-last, one env): every field of the wire
    state within 1e-6 (the two FKs round differently), the packed
    lengths equal."""
    m = cassie_model()
    phys = CassiePhysState.standing(1, torch.device("cpu"))
    est = estimate_state(m, phys, static_diag(
        m, PhysParams.from_model(m, 1, torch.device("cpu")), phys))
    jm = jax_cassie_model()
    jphys = JaxPhysState.standing()
    jest = jax_estimate(jm, jphys, jax_static_diag(
        jm, JaxPhysParams.from_model(jm), jphys))
    ours = aw.unpack_state_out(aw.pack_state_out(
        aw.state_out_from_estimator(est)))
    theirs = jax_aw.unpack_state_out(jax_aw.pack_state_out(
        jax_aw.state_out_from_estimator(jest)))
    flat = lambda s: np.frombuffer(aw.pack_state_out(s)[:484], "<f4")
    np.testing.assert_allclose(flat(ours), flat(theirs), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(ours.motor_position,
                                  est.motor_position[:, 0].numpy())


@pytest.mark.skipif(g_pp is None, reason="no C++ toolchain")
def test_udp_loopback_roundtrip():
    """Raw PD and state packets over loopback, sequence numbers moving."""
    from apex_tpu_torch.runtime.udp_link import (CassieUdp, PD_FLOATS,
                                                 RobotSideLink, STATE_FLOATS)

    operator = CassieUdp(remote_addr="127.0.0.1", remote_port=35100,
                         local_addr="127.0.0.1", local_port=35101)
    robot = RobotSideLink(local_addr="127.0.0.1", local_port=35100,
                          remote_addr="127.0.0.1", remote_port=35101)
    try:
        pd = np.arange(PD_FLOATS, dtype=np.float32)
        operator.send_pd(pd)
        assert robot.wait(2000)
        np.testing.assert_array_equal(robot.recv_newest_pd(), pd)
        state = np.linspace(0, 1, STATE_FLOATS).astype(np.float32)
        robot.send_state(state)
        assert operator.wait(2000)
        np.testing.assert_array_equal(operator.recv_newest(), state)
        operator.send_pd(pd)
        operator.send_pd(pd)
        assert operator.info.seq_num_out >= 3
    finally:
        operator.close()
        robot.close()


@pytest.mark.skipif(g_pp is None, reason="no C++ toolchain")
def test_agility_framing_over_udp_with_a_simulated_robot():
    """The operator sends pd_in_t packets, the robot side answers with the
    port's standing state as state_out_t (test_agility_wire_over_udp)."""
    from apex_tpu_torch.runtime.udp_link import CassieUdp, RobotSideLink

    op = CassieUdp(remote_addr="127.0.0.1", remote_port=25203,
                   local_addr="127.0.0.1", local_port=25204)
    robot = RobotSideLink(local_addr="127.0.0.1", local_port=25203,
                          remote_addr="127.0.0.1", remote_port=25204)
    try:
        targets = np.linspace(-1, 1, 10).astype(np.float32)
        op.send_pd_t(targets)
        assert robot.wait(timeout_ms=2000)
        pd = robot.recv_newest_pd_agility()
        np.testing.assert_array_equal(
            np.concatenate([pd.left.p_target, pd.right.p_target]), targets)

        m = cassie_model()
        phys = CassiePhysState.standing(1, torch.device("cpu"))
        est = estimate_state(m, phys, static_diag(
            m, PhysParams.from_model(m, 1, torch.device("cpu")), phys))
        robot.send_state_t(aw.state_out_from_estimator(est))
        assert op.wait(timeout_ms=2000)
        got = op.recv_newest_pd_t()
        np.testing.assert_array_equal(got.motor_position,
                                      est.motor_position[:, 0].numpy())
        assert got.radio_signal_good
    finally:
        op.close()
        robot.close()
