"""The port's per-env engine tier against the JAX package's on the CPU.

The per-env engine (`apex_tpu_torch.physics.engine`) is the JAX package's
reference pipeline, `jax.vmap(engine._step_single)` (the route JAX takes
with APEX_TPU_NO_FLEET=1), written batch-first. Held here to JAX on the
same numpy-drawn inputs: forward kinematics, `compute_dynamics` (M, Minv,
bias), `constraint_forces`, one step, 50 substeps and `total_energy`, on
Cassie (a perturbed batch, randomized params, the heightfield model),
Walker2d and the XML models of tests/test_physics.py; the batched SPD
routes against JAX's and against `pallas_spd_inverse` in interpret mode;
the PD scan's per-env tier against `jax.vmap(_pd_scan_single)`; and the
envs on the per-env tier against the JAX envs built under
APEX_TPU_NO_FLEET=1. The port's per-env step is also held to the port's
own fleet step.

Tolerances are those JAX holds between its own tiers
(tests/test_fleet_parity.py:39-68, `_assert_stepout_close`): kinematics to
f32 rounding, velocity-level outputs loosely, because they pass through
(M + hD)^-1, whose condition number (~1e5 on Cassie) amplifies the
summation-order noise of two implementations.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs.walker2d import Walker2dEnv as JaxWalker2dEnv
from apex_tpu.envs.walker2d import WalkerState as JaxWalkerState
from apex_tpu.ops import linalg as jax_linalg
from apex_tpu.ops.pallas_linalg import pallas_spd_inverse
from apex_tpu.physics import cassie_sim as jax_sim
from apex_tpu.physics import engine as je
from apex_tpu.physics.mjcf import parse_mjcf_string as jax_parse
from apex_tpu_torch.envs.cassie import CassieEnv
from apex_tpu_torch.envs.walker2d import Walker2dEnv, WalkerState
from apex_tpu_torch.ops import linalg, pallas_linalg
from apex_tpu_torch.physics import cassie_sim, engine, fleet
from apex_tpu_torch.physics.mjcf import parse_mjcf_string
from test_physics import (BALL_DROP_XML, DOUBLE_PENDULUM_XML, PENDULUM_XML,
                          SPRING_XML)
from test_torch_switches import check_reset, check_steps, jax_group

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run side by side in several worker processes: one
    torch thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(a, b, rtol, atol, name=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=name)


def assert_stepout_close(a, b):
    """tests/test_fleet_parity.py:39-68's per-field tolerances, for two
    batch-first StepOuts (numpy-convertible fields)."""
    np_ = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x
    c = lambda f, g, rtol, atol, name: _close(np_(f), np_(g), rtol, atol,
                                              name)
    c(a.qpos, b.qpos, 1e-4, 2e-5, "qpos")
    c(a.qvel, b.qvel, 5e-2, 2e-2, "qvel")
    c(a.qacc, b.qacc, 1e-1, 50.0, "qacc")
    c(a.contact.force, b.contact.force, 5e-2, 1.0, "contact.force")
    c(a.contact.depth, b.contact.depth, 1e-4, 1e-6, "contact.depth")
    c(a.contact.pos, b.contact.pos, 1e-4, 1e-5, "contact.pos")
    c(a.kin.xpos, b.kin.xpos, 1e-4, 1e-5, "kin.xpos")
    c(a.kin.xquat, b.kin.xquat, 1e-4, 1e-5, "kin.xquat")
    c(a.actuator_torque, b.actuator_torque, 1e-5, 1e-6, "actuator_torque")


# ---------------------------------------------------------------------------
# models and inputs: numpy draws handed to both stacks, batch-first
# ---------------------------------------------------------------------------

def _xml_models():
    return {name: xml for name, xml in (
        ("pendulum", PENDULUM_XML), ("spring", SPRING_XML),
        ("double_pendulum", DOUBLE_PENDULUM_XML),
        ("ball_drop", BALL_DROP_XML))}


def _models(name):
    """(JAX model, port model) by case name."""
    if name.startswith("cassie"):
        jm, tm = jax_sim.cassie_model(), cassie_sim.cassie_model()
        if name == "cassie_hfield":
            jm = dataclasses.replace(jm, enable_hfield=True)
            tm = cassie_sim.cassie_model(enable_hfield=True)
        return jm, tm
    if name == "walker2d":
        from apex_tpu_torch.envs.walker2d import walker_model

        return JaxWalker2dEnv().model, walker_model()
    xml = _xml_models()[name]
    return jax_parse(xml), parse_mjcf_string(xml)


def _inputs(name, B, seed):
    """qpos, qvel, ctrl (B, ...) float32 and the params' numpy overrides:
    Cassie near the standing pose as tests/test_fleet_parity.py:18-31
    draws it (ball quaternions renormalized), Walker2d and the XML models
    near qpos0; randomized masses, damping, friction and an external
    wrench for "cassie_random", a terrain table on every env for
    "cassie_hfield"."""
    jm, _ = _models(name)
    rng = np.random.default_rng(seed)
    base = (jax_sim.CASSIE_QPOS_INIT if name.startswith("cassie")
            else jm.qpos0)
    scale = 0.01 if name.startswith("cassie") else 0.05
    qpos = np.tile(base, (B, 1)) + scale * rng.normal(size=(B, jm.nq))
    for j in jm.joints:
        if j.jtype.name == "BALL":
            q = qpos[:, j.qposadr:j.qposadr + 4]
            qpos[:, j.qposadr:j.qposadr + 4] = q / np.linalg.norm(
                q, axis=1, keepdims=True)
    qvel = 0.1 * rng.normal(size=(B, jm.nv))
    ctrl = 0.3 * rng.normal(size=(B, jm.nu))
    over = {}
    if name == "cassie_random":
        over = dict(
            body_mass=jm.body_mass * rng.uniform(0.5, 1.5, (B, jm.nbody)),
            dof_damping=jm.dof_damping * rng.uniform(0.5, 2.0, (B, jm.nv)),
            friction=rng.uniform(0.4, 1.1, B),
            ext_force=5.0 * rng.normal(size=(B, 6)))
    elif name == "cassie_hfield":
        over = dict(hfield=0.02 * rng.normal(size=(B, je.HFIELD_RES,
                                                   je.HFIELD_RES)),
                    hfield_active=np.ones(B))
    f32 = lambda x: np.asarray(x, np.float32)
    return f32(qpos), f32(qvel), f32(ctrl), {k: f32(v)
                                             for k, v in over.items()}


def _params(name, B, over):
    """(JAX batch-first params, port batch-first params) with `over`."""
    jm, tm = _models(name)
    jp = jax.tree_util.tree_map(
        lambda x: jnp.tile(x, (B,) + (1,) * jnp.ndim(x)),
        je.PhysParams.from_model(jm))
    jp = jp.replace(**{k: jnp.asarray(v) for k, v in over.items()})
    # one abstract signature for every case of a model (no weak types)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), jp)
    tp = engine.params_batch_first(engine.PhysParams.from_model(tm, B, CPU))
    tp = dataclasses.replace(tp, **{k: torch.tensor(v)
                                    for k, v in over.items()})
    return jp, tp


def _case(name, B=4, seed=0):
    jm, tm = _models(name)
    qpos, qvel, ctrl, over = _inputs(name, B, seed)
    jp, tp = _params(name, B, over)
    return jm, tm, jp, tp, qpos, qvel, ctrl


t_ = torch.tensor
CASSIE_CASES = ["cassie", "cassie_random", "cassie_hfield"]
ALL_CASES = CASSIE_CASES + ["walker2d", *_xml_models()]
B_CASE = 4


_PIPELINES = {}


def _jax_pipeline(jm, name):
    """The jitted JAX pipeline of a model, one per model (the plain and
    the randomized Cassie cases share it)."""
    key = "cassie" if name == "cassie_random" else name
    if key not in _PIPELINES:
        def one(p, q, v, u):
            dyn = je.compute_dynamics(jm, p, q, v)
            qfrc, con = je.constraint_forces(jm, p, dyn, v)
            return (je.forward_kinematics(jm, p, q), dyn, qfrc, con,
                    je.total_energy(jm, p, q, v),
                    je._step_single(jm, p, q, v, u))

        _PIPELINES[key] = jax.jit(jax.vmap(one))
    return _PIPELINES[key]


@functools.lru_cache(maxsize=None)
def _jax_pd_scan(length):
    """jax.vmap(cassie_sim._pd_scan_single) of `length` substeps on Cassie,
    jitted once for the tests that share it."""
    jm = jax_sim.cassie_model()
    return jax.jit(jax.vmap(lambda p, s, c: jax_sim._pd_scan_single(
        jm, p, s, c, length)))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """A case's models, params and inputs (bodies pressed into the floor,
    so that contacts push), and JAX's per-env pipeline on them, compiled
    once per case: f(params, qpos, qvel, ctrl) -> (kinematics, dynamics,
    constraint forces, contact info, total energy, the step's StepOut),
    each jax.vmap of the per-env function."""
    jm, tm, jp, tp, qpos, qvel, ctrl = _case(name, B=B_CASE, seed=1)
    if name.startswith("cassie"):
        qpos[:, 2] -= 0.03
    elif name == "walker2d":
        qpos[:, 1] -= 0.04
    elif name == "ball_drop":
        qpos[:, 2] -= 0.92

    f = _jax_pipeline(jm, name)
    return dict(tm=tm, jp=jp, tp=tp, qpos=qpos, qvel=qvel, ctrl=ctrl, f=f,
                out=f(jp, qpos, qvel, ctrl))


@pytest.mark.parametrize("name", ALL_CASES)
def test_kinematics_and_dynamics_match_jax(name):
    """forward_kinematics and compute_dynamics (M, Minv, the bias) against
    the JAX per-env functions under vmap, and constraint_forces and
    total_energy on the same dynamics."""
    c = _jax_case(name)
    tm, tp, qpos, qvel = c["tm"], c["tp"], t_(c["qpos"]), t_(c["qvel"])
    kin_j, dyn_j, qfrc_j, con_j, e_j, _ = c["out"]
    kin = engine.forward_kinematics(tm, tp, qpos)
    for f in ("xpos", "xquat", "ximat", "xipos", "cdof", "origin"):
        _close(getattr(kin, f), getattr(kin_j, f), 1e-4, 1e-5, f)

    dyn = engine.compute_dynamics(tm, tp, qpos, qvel)
    _close(dyn.M, dyn_j.M, 1e-4, 1e-4, "M")
    _close(dyn.body_vel, dyn_j.body_vel, 1e-4, 1e-5, "body_vel")
    _close(dyn.qfrc_bias, dyn_j.qfrc_bias, 1e-4, 1e-3, "qfrc_bias")
    # Minv: the conditioning of M + hD (~1e5 on Cassie) against f32
    # rounding of M, per row of the inverse (~2e-2 relative, as
    # _assert_stepout_close's docstring measures)
    Mi, Mi_j = dyn.Minv.numpy(), np.asarray(dyn_j.Minv)
    row = np.abs(Mi_j).max(axis=-1, keepdims=True)
    assert (np.abs(Mi - Mi_j) <= 2e-2 * row + 1e-6).all()

    qfrc, con = engine.constraint_forces(tm, tp, dyn, qvel)
    _close(con.depth, con_j.depth, 1e-4, 1e-6, "depth")
    _close(con.pos, con_j.pos, 1e-4, 1e-5, "pos")
    _close(con.vel, con_j.vel, 1e-4, 1e-5, "vel")
    _close(con.force, con_j.force, 5e-2, 1.0, "force")
    _close(qfrc, qfrc_j, 5e-2, 1.0, "qfrc")
    _close(engine.total_energy(tm, tp, qpos, qvel), e_j, 1e-5, 1e-4,
           "energy")


@pytest.mark.parametrize("name", ALL_CASES)
def test_step_matches_jax(name):
    """One substep against `jax.vmap(engine._step_single)`, with the
    bodies pressed into the floor where the model has contacts."""
    c = _jax_case(name)
    out_j = c["out"][-1]
    out = engine.step(c["tm"], c["tp"], t_(c["qpos"]), t_(c["qvel"]),
                      t_(c["ctrl"]))
    assert_stepout_close(out, out_j)
    if name.startswith("cassie") or name in ("walker2d", "ball_drop"):
        assert float(np.asarray(out_j.contact.depth).max()) > 0


@pytest.mark.parametrize("name", ["cassie", "walker2d", "double_pendulum",
                                  "ball_drop"])
def test_50_substeps_match_jax(name):
    """50-substep trajectories stay together, at
    tests/test_fleet_parity.py:71-95's bounds (per-substep conditioning
    noise accumulates through stiff contact)."""
    c = _jax_case(name)
    qj, vj = c["qpos"], c["qvel"]
    q, v = t_(qj), t_(vj)
    for _ in range(50):
        o = c["f"](c["jp"], qj, vj, c["ctrl"])[-1]
        qj, vj = o.qpos, o.qvel
        out = engine.step(c["tm"], c["tp"], q, v, t_(c["ctrl"]))
        q, v = out.qpos, out.qvel
    _close(q, qj, 5e-2, 5e-3, "qpos")
    _close(v, vj, 2e-1, 2e-1, "qvel")


@pytest.mark.parametrize("name", ["cassie_random", "cassie_hfield",
                                  "walker2d"])
def test_per_env_step_matches_the_fleet_step(name):
    """The port's per-env step against the port's batch-last fleet step on
    the same inputs, at the same tolerances (the port's counterpart of
    test_fleet_matches_per_env_*)."""
    _, tm, _, tp, qpos, qvel, ctrl = _case(name, B=5, seed=3)
    out = engine.step(tm, tp, t_(qpos), t_(qvel), t_(ctrl))
    bl = lambda x: torch.movedim(x, 0, -1).contiguous()
    params_bt = engine.PhysParams(**{
        f.name: bl(getattr(tp, f.name))
        for f in dataclasses.fields(engine.PhysParams)})
    dyn, con, q, v, a, tau = fleet.fleet_step(
        tm, params_bt, bl(t_(qpos)), bl(t_(qvel)), bl(t_(ctrl)))
    bf = lambda x: torch.movedim(x, -1, 0)
    xquat = fleet._mat2quat_bt(dyn.kin.ximat)
    fleet_out = engine.StepOut(
        qpos=bf(q), qvel=bf(v), qacc=bf(a),
        contact=engine.ContactInfo(force=bf(con.force), depth=bf(con.depth),
                                   pos=bf(con.pos), vel=bf(con.vel)),
        kin=engine.Kinematics(xpos=bf(dyn.kin.xpos), xquat=bf(xquat),
                              ximat=bf(dyn.kin.ximat),
                              xipos=bf(dyn.kin.xipos), cdof=bf(dyn.kin.cdof),
                              origin=bf(dyn.kin.origin)),
        actuator_torque=bf(tau))
    assert_stepout_close(out, fleet_out)


# ---------------------------------------------------------------------------
# the batched SPD routes
# ---------------------------------------------------------------------------

def _mhd(B, seed):
    """Cassie's M + hD on a perturbed batch, (B, 32, 32) float32."""
    _, tm, _, tp, qpos, qvel, _ = _case("cassie_random", B=B, seed=seed)
    dyn = engine.compute_dynamics(tm, tp, t_(qpos), t_(qvel))
    return (dyn.M + torch.diag_embed(tm.timestep * tp.dof_damping)).numpy()


def _random_spd(B, n, seed):
    X = np.random.default_rng(seed).normal(size=(B, n, n))
    A = X @ X.transpose(0, 2, 1) / n + 0.1 * np.eye(n)
    return A.astype(np.float32)


@pytest.mark.parametrize("n", [32, 9])
def test_batched_spd_routes_match_jax(n):
    """batched_spd_inverse and batched_spd_solve on (B, n, n) against JAX's
    custom-vmap routes under jax.vmap on the CPU (the unrolled forms), and
    the inverse against `pallas_spd_inverse` in interpret mode (K3's
    batch-first route). Relative to the inverse's largest entry per row:
    1e-5 on random SPD, 2e-3 on Cassie's M + hD (chip_smoke's K3 bounds,
    against the conditioning of M + hD)."""
    A = _random_spd(6, n, 5)
    rel = np.full((6, 1, 1), 1e-5, np.float32)
    if n == 32:    # and six of Cassie's M + hD
        A = np.concatenate([_mhd(6, 4), A])
        rel = np.concatenate([np.full_like(rel, 2e-3), rel])
    B = A.shape[0]
    b = np.random.default_rng(6).normal(size=(B, n)).astype(np.float32)

    got = linalg.batched_spd_inverse(t_(A)).numpy()
    ref = np.asarray(jax.jit(jax.vmap(jax_linalg.batched_spd_inverse))(A))
    pal = np.asarray(pallas_spd_inverse(jnp.asarray(A), block_b=B,
                                        interpret=True))
    row = np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(got - ref) <= rel * row).all()
    assert (np.abs(got - pal) <= rel * row).all()
    np.testing.assert_array_equal(
        got, pallas_linalg.spd_inverse_bf(t_(A)).numpy())

    x = linalg.batched_spd_solve(t_(A), t_(b)).numpy()
    x_ref = np.asarray(jax.jit(jax.vmap(jax_linalg.batched_spd_solve))(A, b))
    scale = np.abs(x_ref).max(axis=-1, keepdims=True)
    assert (np.abs(x - x_ref) <= rel[..., 0] * scale).all()
    # the route on the card is x = A^-1 b from K3-bf (linalg.py:148-153)
    assert (np.abs(x - np.einsum("bij,bj->bi", got, b))
            <= rel[..., 0] * scale).all()


def test_spd_inverse_bf_refuses_what_it_cannot_run():
    """The batch-first wrapper takes the plain version on the CPU only:
    any other device raises, as does a bad tensor on CUDA (the card test
    checks those)."""
    A = t_(_random_spd(3, 4, 0))
    torch.testing.assert_close(pallas_linalg.spd_inverse_bf(A),
                               linalg.spd_inverse(A))
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_linalg.spd_inverse_bf(A.to("meta"))


# ---------------------------------------------------------------------------
# the PD scan's per-env tier and the envs on it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("command", ["random", "settle"])
def test_pd_scan_per_env_matches_jax(command):
    """pd_scan(tier="per_env") against jax.vmap(cassie_sim._pd_scan_single)
    over 10 substeps of a dyn-rand batch pressed onto its feet: final
    state, the per-substep diagnostics and the qvel/qacc streams (the
    per-env tier returns them batch-last like the other tiers); for
    "settle", `settle` against the same scan with the neutral targets,
    which is JAX's settle (cassie_sim.py:518-529, a scan of pd_substep).

    Bounds: the per-substep tolerances of tests/test_fleet_parity.py:39-68
    plus twice JAX's own spread over the scan when the joint positions of
    its input change by random factors 1 +- 1e-6 (four draws), per
    element: contact onsets amplify f32 noise over the substeps."""
    B, L = 4, 10
    _, tm, jp, tp, qpos, qvel, _ = _case("cassie_random", B=B, seed=7)
    qpos[:, 2] -= 0.02
    rng = np.random.default_rng(8)
    target = (jax_sim.NEUTRAL_OFFSET
              + 0.1 * rng.normal(size=(B, 10))).astype(np.float32)
    if command == "settle":
        target = np.tile(jax_sim.NEUTRAL_OFFSET, (B, 1)).astype(np.float32)
    jm = jax_sim.cassie_model()
    cmd_j = jax_sim.PDCommand.from_targets(jnp.asarray(target))
    cmd_j = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B, 10)),
                                   cmd_j)
    scan = _jax_pd_scan(L)

    def jax_run(q):
        phys_j = jax_sim.CassiePhysState(qpos=jnp.asarray(q),
                                         qvel=jnp.asarray(qvel),
                                         qacc=jnp.zeros((B, jm.nv)))
        fj, dj, vj, aj = scan(jp, phys_j, cmd_j)
        out = dict(qpos=fj.qpos, qvel=fj.qvel, qvel_seq=vj, qacc_seq=aj,
                   **dj._asdict())
        return {k: np.asarray(x) for k, x in out.items()}

    ref = jax_run(qpos)
    spread = {k: np.zeros_like(x) for k, x in ref.items()}
    for _ in range(4):
        q = qpos.copy()
        q[:, 7:] *= (1.0 + 1e-6 * rng.choice([-1.0, 1.0], size=q[:, 7:].shape)
                     ).astype(np.float32)
        for k, x in jax_run(q).items():
            spread[k] = np.maximum(spread[k], np.abs(x - ref[k]))

    bl = lambda x: torch.movedim(t_(np.asarray(x)), 0, -1).contiguous()
    params_bt = engine.PhysParams(**{
        f.name: torch.movedim(getattr(tp, f.name), 0, -1).contiguous()
        for f in dataclasses.fields(engine.PhysParams)})
    phys = cassie_sim.CassiePhysState(qpos=bl(qpos), qvel=bl(qvel),
                                      qacc=torch.zeros(32, B))
    tol = dict(qpos=(1e-4, 2e-5), qvel=(5e-2, 2e-2), qvel_seq=(5e-2, 2e-2),
               qacc_seq=(1e-1, 50.0), foot_frc_z=(5e-2, 1.0),
               foot_pos=(1e-4, 1e-5), foot_vel=(5e-2, 2e-2),
               foot_quat=(1e-4, 1e-5), toe_heel_force=(5e-2, 1.0),
               motor_torque=(5e-2, 2e-2))
    if command == "settle":
        f = cassie_sim.settle(tm, params_bt, phys, L, tier="per_env")
        got = dict(qpos=f.qpos, qvel=f.qvel)
    else:
        cmd = cassie_sim.PDCommand.from_targets(bl(target))
        f, d, v, a = cassie_sim.pd_scan(tm, params_bt, phys, cmd, L,
                                        tier="per_env")
        # JAX's streams are (B, L, ...); the port's (L, ..., B)
        got = dict(qpos=f.qpos, qvel=f.qvel, qvel_seq=v, qacc_seq=a,
                   **d._asdict())
    for k, x in got.items():
        rtol, atol = tol[k]
        x = np.moveaxis(x.numpy(), -1, 0)
        err = np.abs(x - ref[k])
        bound = atol + rtol * np.abs(ref[k]) + 2 * spread[k]
        worst = np.unravel_index(np.argmax(err - bound), err.shape)
        assert (err <= bound).all(), (k, worst, err[worst], bound[worst])
    assert ref["foot_frc_z"].max() > 0

    # static_diag's per-env route: the per-env FK, the fleet's foot poses
    sd = cassie_sim.static_diag(tm, params_bt, phys, "per_env")
    sd_fleet = cassie_sim.static_diag(tm, params_bt, phys)
    for field in ("foot_pos", "foot_quat"):
        _close(getattr(sd, field), getattr(sd_fleet, field), 1e-5, 1e-6,
               field)


def test_cassie_env_per_env_matches_jax_no_fleet(monkeypatch):
    """CassieEnv(pd_tier="per_env"): a reset and three steps of the default
    env (dyn-rand, firmware estimator) from JAX's draws against the JAX env
    built and traced under APEX_TPU_NO_FLEET=1 (its per-env engine), at
    limit (a)'s bounds: each observation entry within twice JAX's own
    spread under 1e-6 changes of its joint positions plus f32 rounding,
    the reward likewise, termination exactly (test_torch_switches'
    check_reset and check_steps, 8 envs at 3 substeps)."""
    monkeypatch.setenv("APEX_TPU_NO_FLEET", "1")
    run = jax_group({}, seed=11)
    env = CassieEnv(simrate=3, device="cpu", pd_tier="per_env")
    check_reset(run, env)
    check_steps(run, env)


def test_walker2d_per_env_matches_jax_no_fleet(monkeypatch):
    """Walker2d on the per-env tier: three env steps (12 substeps of
    engine.step) against the JAX env traced under APEX_TPU_NO_FLEET=1,
    half the fleet starting in the floor, at the per-substep tolerances as
    tests/test_torch_walker2d.py holds its fleet tier."""
    monkeypatch.setenv("APEX_TPU_NO_FLEET", "1")
    B = 8
    jenv, env = JaxWalker2dEnv(), Walker2dEnv(device="cpu", pd_tier="per_env")
    m = env.model
    rng = np.random.default_rng(12)
    qpos = m.qpos0[None] + 0.05 * rng.normal(size=(B, m.nq))
    qpos[1::2, 1] -= 0.04
    qpos = qpos.astype(np.float32)
    qvel = (0.5 * rng.normal(size=(B, m.nv))).astype(np.float32)
    acts = rng.normal(0.0, 0.7, size=(3, B, 6)).astype(np.float32)
    jstep = jax.jit(jax.vmap(jenv.step))
    jst = JaxWalkerState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
    st = WalkerState(t_(qpos.T.copy()), t_(qvel.T.copy()))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    for t in range(3):
        jst, jobs, jr, jterm, _ = jstep(jst, jnp.asarray(acts[t]), keys)
        st, obs, r, term = env.step(st, t_(acts[t]), None)
        _close(st.qpos.numpy().T, jst.qpos, 1e-4, 2e-5, "qpos")
        _close(st.qvel.numpy().T, jst.qvel, 5e-2, 2e-2, "qvel")
        _close(obs, jobs, 5e-2, 2e-2, "obs")
        _close(r, jr, 1e-4, 2 * 2e-5 / 0.008, "reward")
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
    with pytest.raises(ValueError, match="pd_tier"):
        Walker2dEnv(device="cpu", pd_tier="megakernel")
