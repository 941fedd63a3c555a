"""The port's clock rewards, reward clocks and observation builders against
the JAX package on the CPU, as plain functions on shared numpy-made inputs
(no env step is compiled): every clock reward on built clocks of each
stance mode, with and without the incentive, and on loaded clocks; every
table of `data/reward_clocks.npz`; the observation of each input profile
and command profile, with the omniscient appendix and a history; and the
terrain bank of `terrain_amplitude` through both factories.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.envs.cassie import CassieEnvState as JaxCassieEnvState
from apex_tpu.envs.registry import env_factory as jax_env_factory
from apex_tpu.physics.cassie_sim import CassiePhysState as JaxPhysState
from apex_tpu.physics.cassie_sim import CassieStateOut as JaxStateOut
from apex_tpu.physics.engine import PhysParams as JaxPhysParams
from apex_tpu.rewards import clock as jax_clock
from apex_tpu_torch.envs import cassie as port_cassie
from apex_tpu_torch.envs.registry import env_factory
from apex_tpu_torch.physics.cassie_sim import CassieStateOut
from apex_tpu_torch.rewards import clock as port_clock

B = 16
bt = lambda x: torch.tensor(np.moveaxis(np.asarray(x), 0, -1).copy())
bf = lambda x: jnp.asarray(np.moveaxis(x.numpy(), -1, 0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reward_inputs(rng):
    """Per-env reward inputs, batch-first numpy: a standing-like pose with
    random forces, foot velocities, orientation costs, torques and
    actions."""
    n = lambda *s, sc=1.0: (sc * rng.normal(size=(B,) + s)).astype(
        np.float32)
    qpos = n(35, sc=0.1)
    qpos[:, 2] += 0.9
    qpos[:, 3] += 1.0
    quat = lambda: (lambda q: q / np.linalg.norm(q, axis=1, keepdims=True))(
        n(4) + np.float32([2, 0, 0, 0]))
    return dict(
        qpos=qpos, qvel=n(32), l_foot_frc=np.abs(n(sc=300.0)),
        r_foot_frc=np.abs(n(sc=300.0)), l_foot_vel=n(3), r_foot_vel=n(3),
        l_foot_orient_cost=np.abs(n(sc=0.1)),
        r_foot_orient_cost=np.abs(n(sc=0.1)), pelvis_rot_vel=n(3),
        pelvis_accel=n(3), motor_torque=n(10, sc=30.0),
        prev_torque=n(10, sc=30.0), action=n(10, sc=0.3),
        prev_action=n(10, sc=0.3), speed=rng.uniform(
            -0.3, 3.0, B).astype(np.float32),
        est_lfoot_orient=quat(), est_rfoot_orient=quat())


def _clocks(kind, rng):
    """(JAX clock per env, the port's batch-last clock, phases): a built
    clock of a stance mode and incentive from random swing/stance
    durations, or a loaded table."""
    if kind.startswith("load_"):
        name = kind[len("load_"):]
        jc = jax_clock.load_reward_clock(name, phaselen=32.0)
        jcs = jax.tree_util.tree_map(lambda x: jnp.stack([x] * B), jc)
        pc = port_clock.load_reward_clock(name, B, "cpu", phaselen=32.0)
        return jcs, pc, rng.uniform(0, 32.0, B).astype(np.float32)
    mode, incentive = kind.split("-")
    onehot = {"grounded": [1.0, 0, 0], "aerial": [0, 1.0, 0],
              "zero": [0, 0, 1.0]}[mode]
    swing = rng.uniform(0.05, 0.5, B).astype(np.float32)
    stance = rng.uniform(0.05, 0.3, B).astype(np.float32)
    inc = incentive == "incentive"
    jcs = jax.vmap(lambda sw, st: jax_clock.build_clock(
        sw, st, jnp.asarray(onehot), 0.1, inc, 40.0))(swing, stance)
    pc = port_clock.build_clock(
        torch.tensor(swing), torch.tensor(stance),
        torch.tensor(onehot)[:, None].expand(3, B), 0.1, inc, 40.0)
    phase = rng.uniform(0, 1, B).astype(np.float32) * np.asarray(
        jcs.phaselen)
    return jcs, pc, phase


CLOCKS = ["grounded-incentive", "aerial-incentive", "zero-incentive",
          "grounded-no_incentive", "aerial-no_incentive",
          "load_incentive_clock_strict0.1",
          "load_no_incentive_aslip_clock_strict0.3"]


@pytest.mark.parametrize("clock", CLOCKS)
@pytest.mark.parametrize("reward", list(jax_clock.REWARD_FUNCS))
def test_clock_rewards_match_jax(reward, clock):
    """Each clock reward of REWARD_FUNCS on the same inputs and clock, to
    1e-5."""
    rng = np.random.default_rng(zlib.crc32(f"{reward} {clock}".encode()))
    ri = _reward_inputs(rng)
    jcs, pc, phase = _clocks(clock, rng)
    ri["phase"] = phase
    jri = jax_clock.RewardInputs(**{k: jnp.asarray(v) for k, v in ri.items()})
    want = jax.vmap(jax_clock.REWARD_FUNCS[reward])(jcs, jri)
    pri = port_clock.RewardInputs(**{k: bt(v) for k, v in ri.items()})
    got = port_clock.REWARD_FUNCS[reward](pc, pri)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


with np.load(port_clock.REWARD_CLOCKS) as _f:
    CLOCK_TABLES = sorted(k for k in _f if not k.startswith("__"))


@pytest.mark.parametrize("name", CLOCK_TABLES)
def test_load_reward_clock_matches_jax(name):
    """Every table of reward_clocks.npz: the knots, values and PCHIP
    derivatives, and the clock at random phases, to 1e-5."""
    jc = jax_clock.load_reward_clock(name, phaselen=32.0)
    pc = port_clock.load_reward_clock(name, 4, "cpu", phaselen=32.0)
    for f in ("x", "y", "d"):
        np.testing.assert_allclose(getattr(pc, f)[..., 0].numpy(),
                                   np.asarray(getattr(jc, f)), rtol=1e-5,
                                   atol=1e-5)
    assert pc.phaselen.tolist() == [32.0] * 4
    t = np.float32([0.0, 7.3, 16.5, 31.9])
    want = np.stack([np.asarray(jc.eval(x)) for x in t], axis=-1)
    np.testing.assert_allclose(np.stack(pc.eval(torch.tensor(t))), want,
                               rtol=1e-5, atol=1e-5)


PROFILES = [
    dict(input_profile="full"),
    dict(input_profile="full", command_profile="phase"),
    dict(input_profile="min"),
    dict(input_profile="min", command_profile="phase", history=2),
    dict(input_profile="footdist"),
    dict(input_profile="noaccel_footdist", omniscient=True),
    dict(input_profile="novel_footdist", history=1),
    dict(input_profile="noaccel_footdist_nojoint"),
    dict(input_profile="full", omniscient=True, history=1),
]


def _random_est(rng):
    n = lambda k, sc=1.0: torch.tensor(
        (sc * rng.normal(size=(k, B))).astype(np.float32))
    return CassieStateOut(
        pelvis_position=n(3), pelvis_orientation=n(4),
        pelvis_rot_vel=n(3), pelvis_trans_vel=n(3),
        pelvis_trans_accel=n(3, 10.0), motor_position=n(10),
        motor_velocity=n(10), motor_torque=n(10), joint_position=n(6),
        joint_velocity=n(6), left_foot_position=n(3),
        right_foot_position=n(3), left_foot_orientation=n(4),
        right_foot_orientation=n(4),
        terrain_height=torch.zeros(B))


def _jax_state(ps):
    pick = lambda cls, obj: cls(**{f.name: bf(getattr(obj, f.name))
                                   for f in dataclasses.fields(cls)})
    nested = {"phys": JaxPhysState, "params": JaxPhysParams,
              "clock": jax_clock.GaitClock}
    return JaxCassieEnvState(
        **{f.name: (pick(nested[f.name], getattr(ps, f.name))
                    if f.name in nested else bf(getattr(ps, f.name)))
           for f in dataclasses.fields(ps)})


@pytest.mark.parametrize("config", PROFILES,
                         ids=["-".join(f"{v}" for v in c.values())
                              for c in PROFILES])
def test_observation_builders_match_jax(config):
    """The observation of each profile (the research variants' [clock,
    speed] appendix with the phaselen + 1 divisor, the phase profile's
    gait, the omniscient parameters, the history pushed one frame on) on
    a random estimator output, heading offset and history, to 1e-5;
    sizes and mirror tables as JAX's."""
    rng = np.random.default_rng(len(str(config)))
    penv = port_cassie.CassieEnv(device="cpu", **config)
    jenv = JaxCassieEnv(**config)
    assert (penv.observation_size, penv.mirrored_obs, penv.clock_inds) == (
        jenv.observation_size, jenv.mirrored_obs, jenv.clock_inds)
    g = torch.Generator()
    g.manual_seed(0)
    state, _ = penv.reset(penv.sample_reset_noise(g, B))
    state = dataclasses.replace(
        state,
        orient_add=torch.tensor(rng.uniform(-1, 1, B).astype(np.float32)),
        obs_history=torch.tensor(rng.normal(
            size=state.obs_history.shape).astype(np.float32)))
    est = _random_est(rng)
    new_state, obs = penv._observe(state, est)
    jest = JaxStateOut(**{f.name: bf(getattr(est, f.name))
                          for f in dataclasses.fields(est)})
    jobs, jhist = jax.jit(jax.vmap(jenv._build_obs))(_jax_state(state), jest)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(new_state.obs_history.numpy(),
                               np.moveaxis(np.asarray(jhist), 0, -1),
                               rtol=1e-5, atol=1e-5)


def test_terrain_amplitude_reaches_the_bank():
    """`terrain_amplitude` passes through the port's factory as through
    JAX's: the noise bank at amplitude 0.1 is JAX's, max |h| 0.1 (the
    factory used to drop the key, giving 0.05)."""
    penv = env_factory("Cassie-v0", device="cpu", terrain="noise",
                       terrain_amplitude=0.1)
    jenv = jax_env_factory("Cassie-v0", terrain="noise",
                           terrain_amplitude=0.1)
    assert penv.terrain_amplitude == jenv.terrain_amplitude == 0.1
    got = penv._terrain_bank.numpy()
    want = np.asarray(jenv._terrain_bank).reshape(got.shape)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert float(np.abs(got).max()) == pytest.approx(0.1, abs=1e-6)


def test_unknown_terrain_and_env_raise_value_error():
    """An unknown terrain or environment name raises ValueError in both
    stacks (envs/cassie.py:228, envs/registry.py:62)."""
    for factory, kw in ((jax_env_factory, {}), (env_factory,
                                                {"device": "cpu"})):
        with pytest.raises(ValueError):
            factory("Cassie-v0", terrain="stairs", **kw)
        with pytest.raises(ValueError):
            factory("Hopper-v9", **kw)
