"""The port's batch-last fleet physics against the JAX fleet path on the
CPU: one substep (`fleet.fleet_step`) and a 50-substep PD scan (one
40 Hz policy step, `cassie_sim._fleet_pd_scan`'s fleet branch), on
dyn-rand Cassie fleets drawn with numpy and handed to both sides.

Tolerances are those the JAX package holds between its own physics tiers
(tests/test_fleet_parity.py): kinematics to f32 rounding, velocity-level
outputs loosely, because they pass through (M + hD)^-1, whose condition
number (~1e5) amplifies the summation-order noise of two layouts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.physics import cassie_sim as jax_sim
from apex_tpu.physics import fleet as jax_fleet
from apex_tpu.physics.engine import PhysParams as JaxPhysParams
from apex_tpu_torch.physics import cassie_sim, fleet
from apex_tpu_torch.physics.engine import PhysParams

CPU = torch.device("cpu")
B = 4


def _fleet(seed, q_noise=0.01, drop=0.0):
    """Numpy draws for a dyn-rand Cassie fleet, batch-last: qpos, qvel,
    ctrl and the randomized params (masses, damping, COM offsets,
    friction, floor slope, external wrench). `drop` lowers the pelvis so
    the feet start in contact."""
    m = cassie_sim.cassie_model()
    rng = np.random.default_rng(seed)
    qpos = cassie_sim.CASSIE_QPOS_INIT[:, None] \
        + q_noise * rng.normal(size=(m.nq, B))
    qpos[2] -= drop
    for j in m.joints:
        if j.jtype.name == "BALL":
            q = qpos[j.qposadr:j.qposadr + 4]
            qpos[j.qposadr:j.qposadr + 4] = q / np.linalg.norm(q, axis=0)
    roll, pitch = rng.uniform(-0.03, 0.03, size=(2, B)) / 2.0
    floor_quat = np.stack([np.cos(roll) * np.cos(pitch),
                           np.sin(roll) * np.cos(pitch),
                           np.cos(roll) * np.sin(pitch),
                           -np.sin(roll) * np.sin(pitch)])
    draws = dict(
        qpos=qpos, qvel=0.1 * rng.normal(size=(m.nv, B)),
        ctrl=0.3 * rng.normal(size=(m.nu, B)),
        body_mass=m.body_mass[:, None] * rng.uniform(0.5, 1.5, (m.nbody, B)),
        dof_damping=m.dof_damping[:, None] * rng.uniform(0.3, 5.0, (m.nv, B)),
        body_ipos=m.body_ipos[:, :, None]
        + 0.005 * rng.normal(size=(m.nbody, 3, B)),
        friction=rng.uniform(0.4, 1.1, B),
        floor_quat=floor_quat,
        ext_force=5.0 * rng.normal(size=(6, B)))
    return {k: np.asarray(v, np.float32) for k, v in draws.items()}


PARAM_KEYS = ("body_mass", "dof_damping", "body_ipos", "friction",
              "floor_quat", "ext_force")


def _torch_params(d):
    p = PhysParams.from_model(cassie_sim.cassie_model(), B, CPU)
    for k in PARAM_KEYS:
        setattr(p, k, torch.tensor(d[k]))
    return p


def _jax_params_bt(d):
    p = JaxPhysParams.from_model(jax_sim.cassie_model())
    p = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[..., None],
                                   jnp.shape(x) + (B,)), p)
    return p.replace(**{k: jnp.asarray(d[k]) for k in PARAM_KEYS})


_jax_fleet_step = jax.jit(
    lambda p, q, v, u: jax_fleet.fleet_step(jax_sim.cassie_model(), p, q, v, u))


@pytest.mark.parametrize("seed,drop", [(0, 0.0), (1, 0.06)])
def test_fleet_step_matches_jax(seed, drop):
    """One substep of a dyn-rand fleet, free (drop 0) and with the feet
    pressed 6 cm into the floor (contacts, friction cones)."""
    d = _fleet(seed, drop=drop)
    dyn_j, con_j, qpos_j, qvel_j, qacc_j, tau_j = _jax_fleet_step(
        _jax_params_bt(d), d["qpos"], d["qvel"], d["ctrl"])
    dyn, con, qpos, qvel, qacc, tau = fleet.fleet_step(
        cassie_sim.cassie_model(), _torch_params(d), torch.tensor(d["qpos"]),
        torch.tensor(d["qvel"]), torch.tensor(d["ctrl"]))
    if drop:
        assert float(np.max(np.asarray(con_j.depth))) > 0.0

    close = lambda a, b, **tol: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), **tol)
    close(dyn.kin.xpos, dyn_j.kin.xpos, rtol=1e-4, atol=1e-5)
    close(dyn.kin.cdof, dyn_j.kin.cdof, rtol=1e-4, atol=1e-5)
    close(dyn.M, dyn_j.M, rtol=1e-4, atol=1e-4)
    close(dyn.qfrc_bias, dyn_j.qfrc_bias, rtol=1e-4, atol=1e-3)
    close(qpos, qpos_j, rtol=1e-4, atol=2e-5)
    close(qvel, qvel_j, rtol=5e-2, atol=2e-2)
    close(qacc, qacc_j, rtol=1e-1, atol=50.0)
    close(con.force, con_j.force, rtol=5e-2, atol=1.0)
    close(con.depth, con_j.depth, rtol=1e-4, atol=1e-6)
    close(con.pos, con_j.pos, rtol=1e-4, atol=1e-5)
    close(tau, tau_j, rtol=1e-5, atol=1e-6)


def test_pd_scan_matches_jax():
    """50 PD substeps (one policy step) of a dyn-rand fleet dropped onto
    its feet: final state, diagnostics and the qvel/qacc streams.

    Contact onsets amplify f32 noise chaotically (the achilles-rod ball
    joints, rod inertia ~1e-5 kg m^2, spin at up to ~230 rad/s), so the
    port is held to twice the JAX fleet's own divergence on this very
    input under perturbations the size of one substep's disagreement
    between two f32 implementations (test_fleet_step_matches_jax: qvel
    ~1e-4 relative, through (M + hD)^-1): joint positions and velocities
    scaled by random factors 1 +- 1e-6 and 1 +- 1e-4 (twelve draws). Per
    field, and per dof for the qvel/qacc streams, plus f32 rounding."""
    m = cassie_sim.cassie_model()
    d = _fleet(2, drop=0.03)
    rng = np.random.default_rng(3)
    target = (cassie_sim.NEUTRAL_OFFSET[:, None]
              + 0.1 * rng.normal(size=(10, B))).astype(np.float32)
    L = 50

    jm = jax_sim.cassie_model()
    to_bf = lambda x: jnp.moveaxis(jnp.asarray(x), -1, 0)
    params_b = jax.tree_util.tree_map(to_bf, _jax_params_bt(d))
    cmd_b = jax_sim.PDCommand.from_targets(to_bf(target))
    cmd_b = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (B, 10)), cmd_b)
    scan = jax.jit(lambda p, s, c: jax_sim._fleet_pd_scan(jm, p, s, c, L))

    def jax_run(qpos, qvel):
        """Batch-last numpy outputs of the JAX scan, by field."""
        phys, diag, qvel_seq, qacc_seq = scan(
            params_b, jax_sim.CassiePhysState(
                qpos=to_bf(qpos), qvel=to_bf(qvel),
                qacc=jnp.zeros((B, m.nv))), cmd_b)
        bt = lambda x: np.moveaxis(np.asarray(x), 0, -1)
        return dict(qpos=bt(phys.qpos), qvel=bt(phys.qvel),
                    foot_pos=bt(diag.foot_pos), foot_quat=bt(diag.foot_quat),
                    foot_frc_z=bt(diag.foot_frc_z),
                    motor_torque=bt(diag.motor_torque),
                    qvel_seq=bt(qvel_seq), qacc_seq=bt(qacc_seq))

    ref = jax_run(d["qpos"], d["qvel"])
    assert ref["foot_frc_z"].max() > 0.0
    envelope = {k: np.zeros_like(v) for k, v in ref.items()}
    draws = np.random.default_rng(4)
    sign = lambda x: draws.choice([-1.0, 1.0], size=x.shape)
    for _ in range(12):
        qpos, qvel = d["qpos"].copy(), d["qvel"].copy()
        qpos[7:] *= (1.0 + 1e-6 * sign(qpos[7:])).astype(np.float32)
        qvel *= (1.0 + 1e-4 * sign(qvel)).astype(np.float32)
        for k, v in jax_run(qpos, qvel).items():
            envelope[k] = np.maximum(envelope[k], np.abs(v - ref[k]))

    phys0 = cassie_sim.CassiePhysState(
        qpos=torch.tensor(d["qpos"]), qvel=torch.tensor(d["qvel"]),
        qacc=torch.zeros((m.nv, B)))
    phys, diag, qvel_seq, qacc_seq = cassie_sim.pd_scan(
        m, _torch_params(d), phys0,
        cassie_sim.PDCommand.from_targets(torch.tensor(target)), L)
    got = dict(qpos=phys.qpos, qvel=phys.qvel, foot_pos=diag.foot_pos,
               foot_quat=diag.foot_quat, foot_frc_z=diag.foot_frc_z,
               motor_torque=diag.motor_torque, qvel_seq=qvel_seq,
               qacc_seq=qacc_seq)
    for k, v in got.items():
        err = np.abs(v.numpy() - ref[k])
        rounding = 1e-5 * np.abs(ref[k]).max() + 1e-6
        if k in ("qvel_seq", "qacc_seq"):                # (L, nv, B): per dof
            bound = 2 * envelope[k].max(axis=(0, 2), keepdims=True)
        else:
            bound = 2 * envelope[k].max()
        assert np.all(err <= bound + rounding), (k, float(err.max()))
