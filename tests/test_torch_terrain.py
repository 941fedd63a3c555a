"""Heightfield terrain in the port against the JAX package on the CPU: the
terrain generators and the env's terrain bank, the fleet step's terrain
contacts, K1's heightfield branch (its plain version), the speedmatch
rewards, and the mk5c configuration (noise terrain, `5k_speed_reward`,
dyn-rand off, simrate 60) from reset through three policy steps and
`eval_checkpoint`.

Inputs are drawn with numpy (or, where the JAX package draws them itself,
taken from its own draws) and handed to both sides. The CUDA kernel's
heightfield branch is held against the plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.physics import cassie_sim as jax_sim
from apex_tpu.physics import fleet as jax_fleet
from apex_tpu.physics import fleet_kernel as jax_fk
from apex_tpu.physics.engine import PhysParams as JaxPhysParams
from apex_tpu.physics.mjcf import parse_mjcf_string as jax_parse_mjcf
from apex_tpu.rewards import speedmatch as jax_sm
from apex_tpu.runtime.evaluate import load_experiment as jax_load_experiment
from apex_tpu.utils import terrain as jax_terrain
from apex_tpu_torch.envs import cassie as port_cassie
from apex_tpu_torch.physics import cassie_sim, fleet, fleet_kernel
from apex_tpu_torch.physics.engine import (
    HFIELD_RES,
    PhysParams,
    hfield_bilinear,
)
from apex_tpu_torch.physics.mjcf import parse_mjcf_string
from apex_tpu_torch.rewards import speedmatch
from apex_tpu_torch.rewards.clock import GaitClock
from apex_tpu_torch.runtime import checkpoint
from apex_tpu_torch.runtime.evaluate import eval_checkpoint, load_experiment
from apex_tpu_torch.utils import terrain

from tests.test_physics import BALL_DROP_XML
from tests.test_torch_env import POS_OBS, VEL_OBS, _port_state
from tests.test_torch_megakernel import _fleet as _k1_fleet

CURVES = os.path.join(os.path.dirname(__file__), "..", "curves")
MK5C = os.path.join(CURVES, "cassie_mk5c_ckpt")
MK4_TERRAIN = os.path.join(CURVES, "cassie_mk4_terrain_ckpt")
CPU = torch.device("cpu")
bt = lambda x: torch.tensor(np.moveaxis(np.asarray(x), 0, -1).copy())


# ---------------------------------------------------------------------------
# terrain generators and the bank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["noise", "hill", "steps", "slope"])
def test_terrain_generators_match_jax(kind):
    """The torch generators on JAX's own uniform draws give JAX's terrain:
    the box smoothing is a convolution summed in another order (f32
    rounding of values ~0.3 before the amplitude scaling); the nearest
    resize and the slope are exact up to tan's rounding."""
    key = jax.random.PRNGKey(5)
    if kind in ("noise", "hill"):
        s = terrain.SMOOTHNESS[kind]
        u = jax.random.uniform(key, (HFIELD_RES, HFIELD_RES), minval=-1.0,
                               maxval=1.0)
        ref = jax_terrain.noise_hfield(key, amplitude=0.07, smoothness=s)
        got = terrain.scale_noise(
            terrain.smooth_noise(torch.tensor(np.asarray(u)), s), 0.07)
        tol = dict(rtol=1e-5, atol=1e-7)
    elif kind == "steps":
        coarse = jax.random.uniform(key, (4, 4), minval=-1.0, maxval=1.0)
        ref = jax_terrain.steps_hfield(key, step_height=0.06)
        got = 0.06 * terrain.nearest_resize(
            torch.tensor(np.asarray(coarse)), HFIELD_RES)
        tol = dict(rtol=0, atol=0)
    else:
        ref = jax_terrain.slope_hfield(pitch=0.03, roll=-0.02)
        got = terrain.slope_hfield(pitch=0.03, roll=-0.02)
        tol = dict(rtol=1e-6, atol=1e-7)
    assert tuple(got.shape) == (HFIELD_RES, HFIELD_RES)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    gen = torch.Generator()
    gen.manual_seed(0)
    for h in (terrain.noise_hfield(gen, 0.05),
              terrain.steps_hfield(gen, 0.05)):
        assert float(h.abs().max()) <= 0.05 + 1e-7


@pytest.mark.parametrize("kind", ["noise", "hill", "steps"])
def test_terrain_bank_matches_jax(kind):
    """The committed bank, scaled by the port, is the JAX env's 64-table
    bank at the default amplitude (rtol 2e-7: one rounding of the scaling;
    scripts/export_terrain_banks.py finds them bitwise equal)."""
    ref = np.asarray(JaxCassieEnv(terrain=kind)._terrain_bank)
    got = terrain.terrain_bank(kind, 0.05)
    assert tuple(got.shape) == (64, HFIELD_RES, HFIELD_RES)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-7, atol=0)


# ---------------------------------------------------------------------------
# the fleet tier's terrain contacts
# ---------------------------------------------------------------------------

def _terrain_params(B, rng, amplitude=0.04, active=None):
    """Bank tables of noise terrain at `amplitude` for B envs, numpy
    batch-last (32, 32, B), and hfield_active (B,)."""
    bank = terrain.terrain_bank("noise", amplitude).numpy()
    hf = np.moveaxis(bank[rng.integers(0, 64, B)], 0, -1)
    act = np.ones(B, np.float32) if active is None else np.asarray(
        active, np.float32)
    return np.ascontiguousarray(hf, np.float32), act


def test_hfield_lookup_matches_jax():
    """The port's lookup (`engine.hfield_bilinear`), over all contacts at
    once as the fleet tier calls it and one contact at a time as K1's plain
    version does, against the JAX fleet's, at points
    inside the table, on its cell boundaries and beyond its edges (the
    clip): height and gradient to 1e-6."""
    B, nc = 4, 9
    rng = np.random.default_rng(0)
    hf, _ = _terrain_params(B, rng, amplitude=0.08)
    radius = np.array([10.0, 10.0, 4.0, 2.5], np.float32)
    floor = np.zeros((3, B), np.float32)
    floor[:2] = rng.uniform(-1, 1, (2, B))
    xy = rng.uniform(-1.3, 1.3, (nc, 2, B)) * radius + floor[None, :2]
    xy[0] = floor[:2] + radius * np.array([[1.0], [-1.0]])   # the corners
    xy[1] = floor[:2] + radius * (2.0 * 7 / 31 - 1.0)          # a node
    xy = xy.astype(np.float32)
    jp = JaxPhysParams.from_model(jax_sim.cassie_model(True))
    jp = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[..., None],
                                   jnp.shape(x) + (B,)), jp)
    jp = jp.replace(hfield=jnp.asarray(hf), hfield_radius=jnp.asarray(radius),
                    floor_pos=jnp.asarray(floor))
    ref = jax_fleet._hfield_lookup_bt(jp, jnp.asarray(xy))
    p = PhysParams.from_model(cassie_sim.cassie_model(True), B, CPU)
    p.hfield, p.hfield_radius = torch.tensor(hf), torch.tensor(radius)
    p.floor_pos = torch.tensor(floor)
    cell = torch.tensor(2.0 * radius / (HFIELD_RES - 1))
    table = p.hfield.reshape(HFIELD_RES ** 2, B)
    got = hfield_bilinear(table, p.floor_pos, cell, torch.tensor(xy[:, 0]),
                          torch.tensor(xy[:, 1]))
    got_k1 = [torch.stack(x) for x in zip(*(
        hfield_bilinear(table, p.floor_pos, cell, torch.tensor(xy[c, 0]),
                        torch.tensor(xy[c, 1]))
        for c in range(nc)))]
    for a, b, r in zip(got, got_k1, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-6)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.01


def _cassie_terrain_fleet(seed, B=4):
    """A dyn-rand Cassie fleet on noise terrain (numpy, batch-last): the
    pelvis lowered 2 cm, env 1 beyond the table's edge (clipped lookup),
    env 2 near it, env 3 on the plane (hfield_active 0)."""
    from tests.test_torch_physics import _fleet

    d = _fleet(seed, drop=0.02)
    d["qpos"][0:2, 1] = [-10.6, 10.3]
    d["qpos"][0:2, 2] = [9.7, -9.6]
    rng = np.random.default_rng(seed + 100)
    d["hfield"], d["hfield_active"] = _terrain_params(
        B, rng, 0.03, [1.0, 1.0, 1.0, 0.0])
    return d


HF_KEYS = ("body_mass", "dof_damping", "body_ipos", "friction", "floor_quat",
           "ext_force", "hfield", "hfield_active")


@pytest.mark.parametrize("model_name", ["cassie", "ball"])
def test_fleet_step_hfield_matches_jax(model_name):
    """One fleet substep on terrain against the JAX fleet step: Cassie
    (the fleet above, in contact with the terrain) at the tolerances of
    tests/test_torch_physics.py, and the ball model of
    tests/test_fleet_kernel.py (parsed by the copied MJCF parser), every
    contact of which is on the table."""
    if model_name == "cassie":
        d = _cassie_terrain_fleet(3)
        B = d["qpos"].shape[-1]
        jm, m = jax_sim.cassie_model(True), cassie_sim.cassie_model(True)
    else:
        jm = dataclasses.replace(jax_parse_mjcf(BALL_DROP_XML),
                                 enable_hfield=True)
        m = dataclasses.replace(parse_mjcf_string(BALL_DROP_XML),
                                enable_hfield=True)
        for f in ("nq", "nv", "nbody", "body_parent", "body_pos",
                  "body_mass", "qpos0"):
            np.testing.assert_array_equal(np.asarray(getattr(m, f)),
                                          np.asarray(getattr(jm, f)))
        B = 4
        rng = np.random.default_rng(2)
        pos = np.array([[0.0, 0.0, 1.0], [0.3, -0.2, 0.09],
                        [4.4, -7.7, 0.11], [-13.0, 9.0, 0.1]])
        quat = rng.normal(size=(B, 4))
        quat /= np.linalg.norm(quat, axis=1, keepdims=True)
        d = dict(qpos=np.concatenate([pos, quat], 1).T,
                 qvel=0.3 * rng.normal(size=(m.nv, B)),
                 ctrl=np.zeros((0, B)))
        p0 = PhysParams.from_model(m, B, CPU)
        d.update({k: getattr(p0, k).numpy() for k in HF_KEYS})
        d["hfield"], d["hfield_active"] = _terrain_params(B, rng, 0.08)
        d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    jp = JaxPhysParams.from_model(jm)
    jp = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[..., None],
                                   jnp.shape(x) + (B,)), jp)
    jp = jp.replace(**{k: jnp.asarray(d[k]) for k in HF_KEYS})
    dyn_j, con_j, qpos_j, qvel_j, qacc_j, _ = jax.jit(
        lambda p, q, v, u: jax_fleet.fleet_step(jm, p, q, v, u))(
            jp, d["qpos"], d["qvel"], d["ctrl"])
    p = PhysParams.from_model(m, B, CPU)
    for k in HF_KEYS:
        setattr(p, k, torch.tensor(d[k]))
    dyn, con, qpos, qvel, qacc, _ = fleet.fleet_step(
        m, p, torch.tensor(d["qpos"]), torch.tensor(d["qvel"]),
        torch.tensor(d["ctrl"]))
    depth = np.asarray(con_j.depth)
    assert depth.max() > 0.0
    close = lambda a, b, **tol: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), **tol)
    close(con.depth, con_j.depth, rtol=1e-4, atol=1e-6)
    close(con.pos, con_j.pos, rtol=1e-4, atol=1e-5)
    close(con.force, con_j.force, rtol=5e-2, atol=1.0)
    close(qpos, qpos_j, rtol=1e-4, atol=2e-5)
    close(qvel, qvel_j, rtol=5e-2, atol=2e-2)
    close(qacc, qacc_j, rtol=1e-1, atol=50.0)
    # the terrain changed the answer: the plane gives other depths
    flat = dataclasses.replace(p, hfield_active=torch.zeros(B))
    _, con_flat, _, _, _, _ = fleet.fleet_step(
        m, flat, torch.tensor(d["qpos"]), torch.tensor(d["qvel"]),
        torch.tensor(d["ctrl"]))
    on = d["hfield_active"] > 0.5
    assert float((con_flat.depth - con.depth)[:, on].abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# K1's heightfield branch: the plain version
# ---------------------------------------------------------------------------

def _k1_terrain_inputs(seed):
    """tests/test_torch_megakernel.py's dyn-rand fleet (env 0 in flight,
    envs 1-3 in contact) on noise terrain; env 2 beyond the table's edge,
    env 3 on the plane."""
    qpos, qvel, cmd, params = _k1_fleet(seed)
    qpos[0:2, 2] = [10.4, -10.2]
    rng = np.random.default_rng(seed + 7)
    params["hfield"], params["hfield_active"] = _terrain_params(
        qpos.shape[-1], rng, 0.02, [1.0, 1.0, 1.0, 0.0])
    return qpos, qvel, cmd, params


@pytest.fixture(scope="module")
def k1_terrain():
    """One K1 substep on the terrain fleet: the JAX generator's body
    (eagerly, as tests/test_torch_megakernel.py runs it) and the port's
    plain version with its rounding envelope."""
    qpos, qvel, cmd, params = _k1_terrain_inputs(0)
    jm = jax_sim.cassie_model(True)
    jp = JaxPhysParams(**{k: jnp.asarray(v) for k, v in params.items()})
    with jax.disable_jit():
        ref = [np.asarray(x) for x in jax_fk.emulated_pd_substep(
            jm, jp, jnp.asarray(qpos), jnp.asarray(qvel), jnp.asarray(cmd))]
    m = cassie_sim.cassie_model(True)
    p = PhysParams(**{k: torch.tensor(v) for k, v in params.items()})
    gen = torch.Generator()
    gen.manual_seed(0)
    got, spread = fleet_kernel.plain_spread(
        m, p, torch.tensor(qpos), torch.tensor(qvel), torch.tensor(cmd), gen)
    return dict(inputs=(qpos, qvel, cmd, params), ref=ref, got=got,
                spread=spread)


def test_plain_substep_hfield_matches_the_jax_generator(k1_terrain):
    """`pd_substep_plain` with the heightfield branch against
    `emulated_pd_substep` on the terrain fleet, held as
    tests/test_torch_megakernel.py holds the flat branch: each row to four
    times the port's own spread under 1 +- 1e-7 input changes plus 1e-6
    of its magnitude, the kinematic diag rows to 1e-5."""
    ref, got, spread = k1_terrain["ref"], k1_terrain["got"], \
        k1_terrain["spread"]
    force_rows = [0, 1] + list(range(22, 34))
    for k, name in enumerate(("qpos", "qvel", "qacc", "diag")):
        g, r = got[k].numpy(), ref[k]
        err = np.abs(g - r).max(axis=1)
        scale = np.abs(r).max(axis=1)
        bound = 4 * spread[k].numpy().max(axis=1) + 1e-6 * (1.0 + scale)
        if name == "diag":
            kin = np.setdiff1d(np.arange(len(err)), force_rows)
            bound[kin] = 1e-5 * (1.0 + scale[kin])
        bad = np.nonzero(err > bound)[0]
        assert bad.size == 0, (name, bad.tolist(), err[bad], bound[bad])
    # env 2 (terrain beyond the edge) and env 3 (plane) are in contact,
    # env 0 is in flight
    frc = ref[3][0:2]
    assert (frc[:, 2:].max(axis=0) > 1.0).all() and (frc[:, 0] == 0).all()


def test_plain_substep_hfield_inactive_envs_are_the_flat_substep(k1_terrain):
    """Envs with hfield_active 0 give the flat model's results bit for bit,
    and the terrain envs do not (their contacts moved)."""
    qpos, qvel, cmd, params = k1_terrain["inputs"]
    flat = {k: v for k, v in params.items()}
    flat["hfield"] = np.zeros_like(flat["hfield"])
    flat["hfield_active"] = np.zeros_like(flat["hfield_active"])
    out = fleet_kernel.pd_substep_plain(
        cassie_sim.cassie_model(), PhysParams(
            **{k: torch.tensor(v) for k, v in flat.items()}),
        torch.tensor(qpos), torch.tensor(qvel), torch.tensor(cmd))
    got = k1_terrain["got"]
    for a, b in zip(got, out):
        assert torch.equal(a[:, 3], b[:, 3])
    assert not torch.equal(got[1][:, 1], out[1][:, 1])


def test_plain_substep_hfield_ball_matches_the_jax_generator():
    """The ball on noise terrain (tests/test_fleet_kernel.py's hfield case),
    every contact of which is in the table, two substeps: the port's plain
    version against the JAX generator's body (jitted: the model is
    small), to f32 rounding of the contact solve."""
    jm = dataclasses.replace(jax_parse_mjcf(BALL_DROP_XML),
                             enable_hfield=True)
    m = dataclasses.replace(parse_mjcf_string(BALL_DROP_XML),
                            enable_hfield=True)
    B = 4
    rng = np.random.default_rng(4)
    pos = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 0.0999],
                    [0.4, -0.7, 0.12], [-11.3, 10.9, 0.1]])
    quat = rng.normal(size=(B, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    qpos = np.concatenate([pos, quat], 1).T.astype(np.float32)
    qvel = (0.1 * rng.normal(size=(m.nv, B))).astype(np.float32)
    p = PhysParams.from_model(m, B, CPU)
    p.hfield, act = (torch.tensor(x) for x in _terrain_params(B, rng, 0.08))
    jp = JaxPhysParams(**{f.name: jnp.asarray(getattr(p, f.name).numpy())
                          for f in dataclasses.fields(PhysParams)})
    cmd = np.zeros((0, B), np.float32)
    run = jax.jit(lambda q, v: jax_fk.emulated_pd_substep(jm, jp, q, v, cmd))
    q_j, v_j, q_p, v_p = qpos, qvel, torch.tensor(qpos), torch.tensor(qvel)
    for _ in range(2):
        ref = [np.asarray(x) for x in run(q_j, v_j)]
        got = fleet_kernel.pd_substep_plain(m, p, q_p, v_p,
                                            torch.tensor(cmd))
        np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got[2].numpy(), ref[2], rtol=1e-3,
                                   atol=1e-1)
        q_j, v_j, q_p, v_p = ref[0], ref[1], got[0], got[1]
    assert float(np.abs(ref[2][2]).max()) > 1.0      # contact forces act


# ---------------------------------------------------------------------------
# the speedmatch rewards
# ---------------------------------------------------------------------------

def _speedmatch_draws(B, seed):
    """Random SpeedmatchInputs fields, batch-first numpy, drawn to land on
    both sides of every deadzone, threshold and gate."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape + (B,)).T
    q = rng.normal(size=(B, 4)) * [4.0, 0.3, 0.3, 0.3]
    qpos = u(-0.2, 0.2, 35)
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, 1] = u(-0.1, 0.1)
    qpos[:, 2] = u(0.6, 1.1)
    qvel = u(-2.0, 2.0, 32)
    d = dict(qpos=qpos, qvel=qvel, speed=u(0.0, 3.0),
             orient_add=u(-0.5, 0.5),
             pelvis_orientation=qpos[:, 3:7].copy(),
             side_speed=u(-0.3, 0.3),
             time=rng.integers(400, 600, B).astype(np.int32),
             foot_pos=np.stack([u(-0.2, 0.2, 3), u(-0.2, 0.2, 3)], 1),
             lfoot_vel=u(-0.8, 0.8, 3) * rng.choice([0.01, 1.0], (B, 1)),
             rfoot_vel=u(-0.8, 0.8, 3) * rng.choice([0.01, 1.0], (B, 1)),
             l_high=rng.integers(0, 2, B).astype(np.float32),
             r_high=rng.integers(0, 2, B).astype(np.float32),
             l_foot_frc=u(0.0, 1500.0) * rng.integers(0, 2, B),
             r_foot_frc=u(0.0, 1500.0) * rng.integers(0, 2, B),
             pelvis_accel=u(-10.0, 10.0, 3), action=u(-0.3, 0.3, 10),
             prev_action=u(-0.3, 0.3, 10))
    d["foot_pos"][:, :, 2] = u(0.0, 0.4, 2)
    d["qvel"][:, 0] = d["speed"] + u(-0.1, 0.1)
    scalar_costs = [f for f in speedmatch.SpeedmatchInputs._fields
                    if f not in d]
    for f in scalar_costs:
        d[f] = u(0.0, 2.0)
    return {k: np.asarray(v, np.int32 if k == "time" else np.float32)
            for k, v in d.items()}


@pytest.mark.parametrize("name", sorted(speedmatch.SPEEDMATCH_FUNCS))
def test_speedmatch_reward_matches_jax(name):
    """Every entry of SPEEDMATCH_FUNCS (the 35 functions under their full
    and short names, and the 5k aliases) on random inputs of 16 envs:
    the port's batch-last function against JAX's, vmapped (f32 rounding
    of exp and norms)."""
    d = _speedmatch_draws(16, seed=sorted(speedmatch.SPEEDMATCH_FUNCS)
                          .index(name))
    jax_in = jax_sm.SpeedmatchInputs(**{k: jnp.asarray(v)
                                        for k, v in d.items()})
    ref = np.asarray(jax.vmap(jax_sm.SPEEDMATCH_FUNCS[name])(jax_in))
    port_in = speedmatch.SpeedmatchInputs(**{k: bt(v) for k, v in d.items()})
    got = speedmatch.SPEEDMATCH_FUNCS[name](port_in)
    assert tuple(got.shape) == (16,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    assert set(speedmatch.SPEEDMATCH_FUNCS) == set(jax_sm.SPEEDMATCH_FUNCS)


# ---------------------------------------------------------------------------
# the mk5c configuration: env and evaluation
# ---------------------------------------------------------------------------

B, T = 2, 3


def _reset_draws(env, keys):
    """The draws of apex_tpu CassieEnv.reset / _sample_params per key, with
    the terrain table's index (fold_in(k_dyn, 17)); the dyn-rand draws are
    made though mk5c ignores them."""
    from tests.test_torch_env import _reset_draws as flat_draws

    noise = flat_draws(env, keys)

    def idx(rng):
        k_dyn = jax.random.split(rng, 5)[4]
        return jax.random.randint(jax.random.fold_in(k_dyn, 17), (), 0, 64)
    return noise._replace(terrain_idx=torch.tensor(
        np.asarray(jax.vmap(idx)(keys)), dtype=torch.int64))


def _jax_draws(env):
    """[reset, step, reset, ...] draws of the JAX eval protocol
    (tests/test_torch_env.py), with the terrain indices."""
    from tests.test_torch_env import _step_draws

    rng, key = jax.random.split(jax.random.PRNGKey(42))
    seq = [("reset", _reset_draws(env, jax.random.split(key, B)))]
    for _ in range(T):
        rng, _, k_step, k_reset = jax.random.split(rng, 4)
        seq.append(("step", _step_draws(env, jax.random.split(k_step, B))))
        seq.append(("reset", _reset_draws(env, jax.random.split(k_reset, B))))
    return seq


@pytest.fixture(scope="module")
def mk5c_jax():
    """The JAX eval protocol on mk5c at 2 envs and 3 steps, stepped with one
    compiled vmapped `env.step` (as `rollout_scan` steps; the episodes all
    run the 3 steps), and the JAX fleet's own divergence over those steps
    when the reset state's joint positions change by 1 +- 1e-6 (six
    draws), as tests/test_torch_env.py measures it."""
    from apex_tpu.agents.rollout import init_runner

    ppo, state, _ = jax_load_experiment(MK5C)
    env = ppo.env
    runner0 = init_runner(env, jax.random.PRNGKey(42), B)
    step = jax.jit(jax.vmap(env.step))

    def run(env_state, actions=None):
        rng, obs, out = runner0.rng, runner0.obs, []
        for t in range(T):
            rng, _, k_step, _ = jax.random.split(rng, 4)
            action = (state.actor.act(state.norm, obs, deterministic=True)
                      if actions is None else actions[t])
            env_state, obs, reward, term, _ = step(
                env_state, action, jax.random.split(k_step, B))
            out.append(dict(action=np.asarray(action), obs=np.asarray(obs),
                            reward=np.asarray(reward),
                            terminated=np.asarray(term)))
        return out

    traj = run(runner0.env_state)
    actions = [o["action"] for o in traj]
    envelope = dict(pos=0.0, vel=0.0, reward=0.0)
    draws = np.random.default_rng(0)
    for _ in range(6):
        s = runner0.env_state
        scale = 1.0 + 1e-6 * draws.choice([-1.0, 1.0],
                                          size=s.phys.qpos[:, 7:].shape)
        s = s.replace(phys=s.phys.replace(qpos=s.phys.qpos.at[:, 7:].multiply(
            scale.astype(np.float32))))
        for o, o0 in zip(run(s, actions), traj):
            err = np.abs(o["obs"] - o0["obs"])
            envelope["pos"] = max(envelope["pos"], float(err[:, POS_OBS].max()))
            envelope["vel"] = max(envelope["vel"], float(err[:, VEL_OBS].max()))
            envelope["reward"] = max(envelope["reward"], float(
                np.abs(o["reward"] - o0["reward"]).max()))
    return dict(env=env, runner0=runner0, traj=traj, envelope=envelope,
                draws=_jax_draws(env))


@pytest.fixture(scope="module")
def mk5c_port():
    return load_experiment(MK5C, device="cpu")


def test_mk5c_reset_matches_jax(mk5c_jax, mk5c_port):
    """mk5c's reset with JAX's draws (terrain index included): the terrain
    tables and every other parameter equal JAX's, dyn-rand off leaves the
    defaults and no encoder offsets, and the observation matches to f32
    rounding; simrate 60 gives JAX's clock."""
    env = mk5c_port.env
    assert (env.simrate, env.dynamics_randomization, env.terrain,
            env.reward) == (60, False, "noise", "5k_speed_reward")
    kind, noise = mk5c_jax["draws"][0]
    state, obs = env.reset(noise)
    js = mk5c_jax["runner0"]
    np.testing.assert_allclose(obs.numpy(), np.asarray(js.obs), rtol=1e-5,
                               atol=1e-6)
    ref = _port_state(js.env_state)
    for field in dataclasses.fields(PhysParams):
        torch.testing.assert_close(getattr(state.params, field.name),
                                   getattr(ref.params, field.name),
                                   rtol=0, atol=0)
    assert float(state.params.hfield.abs().max()) > 0.01
    for name in ("phase", "speed", "side_speed", "swing_duration",
                 "stance_duration", "motor_enc_noise", "joint_enc_noise",
                 "prev_action", "prev_torque", "l_high", "r_high"):
        torch.testing.assert_close(getattr(state, name), getattr(ref, name))
    for field in dataclasses.fields(GaitClock):
        torch.testing.assert_close(getattr(state.clock, field.name),
                                   getattr(ref.clock, field.name),
                                   rtol=1e-5, atol=1e-5)


def test_mk5c_steps_match_jax(mk5c_jax, mk5c_port):
    """The JAX reset state stepped three times by the port (fleet tier,
    terrain contacts, 60 substeps, the 5k_speed_reward with its tracking
    inputs) with JAX's actions and command draws: observation, reward and
    termination within twice the JAX fleet's own divergence on this input
    (`mk5c_jax`) plus f32 rounding, as tests/test_torch_env.py holds the
    default configuration; the swing-apex flags and the previous action
    and torque as JAX carries them."""
    env = mk5c_port.env
    traj, env_ = mk5c_jax["traj"], mk5c_jax["envelope"]
    state = _port_state(mk5c_jax["runner0"].env_state)
    steps = [n for kind, n in mk5c_jax["draws"] if kind == "step"]
    for t in range(T):
        state, obs, reward, term = env.step(
            state, torch.tensor(traj[t]["action"]), steps[t])
        err = np.abs(obs.numpy() - traj[t]["obs"])
        np.testing.assert_array_equal(term.numpy(), traj[t]["terminated"])
        np.testing.assert_allclose(reward.numpy(), traj[t]["reward"], rtol=0,
                                   atol=2 * env_["reward"] + 1e-5)
        assert err[:, POS_OBS].max() <= 2 * env_["pos"] + 1e-5
        assert err[:, VEL_OBS].max() <= 2 * env_["vel"] + 1e-4
    torch.testing.assert_close(state.prev_action,
                               torch.tensor(traj[-1]["action"]).T)
    assert state.time.tolist() == [T] * B


def test_flag_sequence_matches_the_jax_scan():
    """The swing-apex flag recurrence in closed form against the JAX env's
    associative scan, on random contact and height sequences."""
    rng = np.random.default_rng(1)
    L, n = 60, 64
    a = rng.random((L, n)) < 0.3
    b = rng.random((L, n)) < 0.3
    init = rng.random(n) < 0.5

    def comp(x, y):
        return (jnp.where(x[0], y[1], y[0]), jnp.where(x[1], y[1], y[0]))

    F0, F1 = jax.lax.associative_scan(comp, (jnp.asarray(b), ~jnp.asarray(a)))
    ref = np.asarray(jnp.where(jnp.asarray(init), F1, F0))
    got = port_cassie._flag_seq(torch.tensor(init), torch.tensor(a),
                                torch.tensor(b))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mk5c_eval_checkpoint_matches_jax(mk5c_jax, monkeypatch):
    """The slice end to end: the port's eval_checkpoint of mk5c on the CPU,
    fed the JAX protocol's draws in order, returns JAX's mean return and
    length (three rewards per episode, each to the step test's bound)."""
    draws = list(mk5c_jax["draws"])

    def take(kind):
        def sample(self, generator, batch):
            got, noise = draws.pop(0)
            assert got == kind and batch == B
            return noise
        return sample

    monkeypatch.setattr(port_cassie.CassieEnv, "sample_reset_noise",
                        take("reset"))
    monkeypatch.setattr(port_cassie.CassieEnv, "sample_step_noise",
                        take("step"))
    ep_ret, ep_len = eval_checkpoint(MK5C, n_episodes=B, traj_len=T,
                                     device="cpu")
    assert not draws
    traj = mk5c_jax["traj"]
    assert not any(o["terminated"].any() for o in traj)
    assert ep_len == pytest.approx(T)
    ref = float(np.mean(np.sum([o["reward"] for o in traj], axis=0)))
    assert ep_ret == pytest.approx(
        ref, abs=T * (2 * mk5c_jax["envelope"]["reward"] + 1e-5))


@pytest.mark.parametrize("path", [MK5C, MK4_TERRAIN])
def test_terrain_checkpoints_load(path):
    """Both terrain checkpoints load through the port's checkpoint reader
    into the mk4 network shapes, on the heightfield model."""
    exp = load_experiment(path, device="cpu")
    assert exp.env.model.enable_hfield and exp.env.terrain == "noise"
    assert (exp.env.observation_size, exp.env.action_size) == (50, 10)
    assert tuple(exp.actor.layers[0].weight.shape) == (256, 50)
    ckpt = checkpoint.load_checkpoint(path)
    torch.testing.assert_close(exp.norm.mean, ckpt.norm["mean"])


def test_mk5c_policy_matches_jax(mk5c_jax, mk5c_port):
    """The mk5c actor loaded from the JAX checkpoint gives JAX's
    deterministic actions on the run's observations (f32 MLP rounding)."""
    obs = np.concatenate([np.asarray(mk5c_jax["runner0"].obs)]
                         + [o["obs"] for o in mk5c_jax["traj"][:-1]])
    ref = np.concatenate([o["action"] for o in mk5c_jax["traj"]])
    with torch.no_grad():
        got = mk5c_port.actor.act(mk5c_port.norm, torch.tensor(obs),
                                  deterministic=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
