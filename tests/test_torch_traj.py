"""CassieTraj-v0 of the port against the JAX package on the CPU, through
both factories: the Agility walking trajectory (the committed cassie_traj
checkpoint's iros_paper reward and clock commands, with dyn-rand on) and
the aslip gait library in delta mode (the PD baseline the reference's
next motor positions) with the traj command profile, the aslip_old
reward and learned gains; reset onto the reference trajectory, three
steps, and the state's checkpoint leaves; and the aslip trajectories'
IK-net targets.

Each configuration is one JAX fleet reset and step, compiled once, at
FLEET envs and SIMRATE substeps. The port is handed JAX's draws (the
speed or gait-library index, the side speed, the phase, dyn-rand, the
phase profile's gait; each step's heading change), recomputed from JAX's
keys; observation and reward are held to twice the JAX fleet's own
spread under 1e-6 changes of its joint positions, per entry, plus f32
rounding (`check_fleet_steps`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs import trajectory as jax_traj
from apex_tpu.envs.registry import env_factory as jax_env_factory
from apex_tpu_torch.envs import cassie_traj as port_traj
from apex_tpu_torch.envs import trajectory as port_trajectory
from apex_tpu_torch.envs.registry import env_factory
from apex_tpu_torch.physics.cassie_sim import CassiePhysState
from apex_tpu_torch.physics.engine import PhysParams

SIMRATE = 3
FLEET = 8
T = 3
f32 = lambda x: jnp.asarray(x, jnp.float32)
bt = lambda x: torch.tensor(np.moveaxis(np.asarray(x), 0, -1).copy())

GROUPS = {
    "walking_iros": dict(traj="walking", dynamics_randomization=True),
    "aslip_delta_traj_aslip_old_gains": dict(
        traj="aslip", no_delta=False, command_profile="traj",
        reward="aslip_old", dynamics_randomization=False, learn_gains=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def port_state(js, cls):
    """A batch-first JAX env state as the port's batch-last one of `cls`
    (its phys and params nested, integer indices as int64)."""
    nested = {"phys": CassiePhysState, "params": PhysParams}
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(js, f.name)
        if f.name in nested:
            out[f.name] = nested[f.name](**{
                g.name: bt(getattr(v, g.name))
                for g in dataclasses.fields(nested[f.name])})
        else:
            out[f.name] = bt(v)
    if "traj_idx" in out:
        out["traj_idx"] = out["traj_idx"].long()
    return cls(**out)


def traj_reset_draws(env, keys):
    """The draws of JAX's CassieTrajEnv.reset per key (envs/cassie_traj.py:
    322-343, _sample_params :288-318) as the port's TrajResetNoise."""
    def one(rng):
        k_speed, k_side, k_clock, k_phase, k_dyn = jax.random.split(rng, 5)
        k_damp, k_mass, k_fric, k_slope, k_menc, k_jenc = \
            jax.random.split(k_dyn, 6)
        k_sw, k_st, k_mode = jax.random.split(k_clock, 3)
        u = lambda k, shape, lo, hi: jax.random.uniform(
            k, shape, minval=lo, maxval=hi)
        m = env.model
        return (jax.random.randint(k_speed, (), 0,
                                   env.num_speeds if env.aslip else 41),
                u(k_side, (), env.min_side_speed, env.max_side_speed),
                jax.random.uniform(k_phase, ()),
                u(k_damp, (m.nv,), env.damping_low, env.damping_high),
                u(k_mass, (m.nbody,), env.mass_low, env.mass_high),
                u(k_fric, (), env.fric_low, env.fric_high),
                u(k_slope, (), -env.max_roll_incline, env.max_roll_incline),
                u(jax.random.fold_in(k_slope, 1), (),
                  -env.max_pitch_incline, env.max_pitch_incline),
                u(k_menc, (10,), -env.encoder_noise, env.encoder_noise),
                u(k_jenc, (6,), -env.encoder_noise, env.encoder_noise),
                jax.random.randint(k_sw, (), 1, 51) / 100.0,
                jax.random.randint(k_st, (), 1, 31) / 100.0,
                jax.random.randint(k_mode, (), 0, 3))
    d = [bt(x) for x in jax.vmap(one)(keys)]
    noise = port_traj.TrajResetNoise(d[0].long(), *d[1:10])
    if env.command_profile == "phase":
        noise = noise._replace(swing=d[10], stance=d[11], mode=d[12].long())
    return noise


def traj_step_draws(env, keys):
    def one(rng):
        k1, k2 = jax.random.split(rng)
        return (jax.random.randint(k1, (), 0, 300) == 0,
                jax.random.uniform(k2, (), minval=-env.max_orient_change,
                                   maxval=env.max_orient_change))
    return port_traj.TrajStepNoise(*(bt(x) for x in jax.vmap(one)(keys)))


def jax_fleet_run(env, keys, actions, step_keys):
    """JAX's fleet reset from `keys` and its steps with `actions`: the
    reset state and observation, each step's (state, obs, reward,
    terminated), and JAX's own spread over the steps (per observation
    entry, and the reward's) when the reset state's joint positions change
    by random factors 1 +- 1e-6."""
    js, jobs = jax.jit(jax.vmap(env.reset))(keys)
    step = jax.jit(jax.vmap(env.step))

    def run(s):
        out = []
        for a, k in zip(actions, step_keys):
            s, obs, rew, term, _ = step(s, a, k)
            out.append(dict(state=s, obs=np.asarray(obs),
                            reward=np.asarray(rew),
                            terminated=np.asarray(term)))
        return out

    ref = run(js)
    spread = dict(obs=np.zeros(env.observation_size), reward=0.0)
    rng = np.random.default_rng(1)
    for _ in range(4):
        q = js.phys.qpos
        scale = 1.0 + 1e-6 * rng.choice([-1.0, 1.0], size=q[:, 7:].shape)
        s = js.replace(phys=js.phys.replace(
            qpos=q.at[:, 7:].multiply(scale.astype(np.float32))))
        for a, b in zip(run(s), ref):
            spread["obs"] = np.maximum(
                spread["obs"], np.abs(a["obs"] - b["obs"]).max(axis=0))
            spread["reward"] = max(spread["reward"], float(
                np.abs(a["reward"] - b["reward"]).max()))
    return js, np.asarray(jobs), ref, spread


def check_fleet_steps(port_env, state, ref, spread, actions, noises):
    """The port's steps against JAX's run: each observation entry within
    twice JAX's spread plus f32 rounding, the reward within twice JAX's
    reward spread, termination exactly."""
    for t, r in enumerate(ref):
        state, obs, reward, term = port_env.step(
            state, torch.tensor(np.asarray(actions[t])), noises[t])
        err = np.abs(obs.numpy() - r["obs"])
        bound = 2 * spread["obs"] + 1e-4 + 1e-5 * np.abs(r["obs"])
        worst = np.unravel_index(np.argmax(err - bound), err.shape)
        assert (err <= bound).all(), (t, worst, err[worst], bound[worst])
        np.testing.assert_allclose(reward.numpy(), r["reward"], rtol=0,
                                   atol=2 * spread["reward"] + 1e-5)
        np.testing.assert_array_equal(term.numpy(), r["terminated"])
    return state


@pytest.fixture(scope="module", params=list(GROUPS))
def group(request):
    """One CassieTraj-v0 configuration through both factories, and JAX's
    run of it."""
    config = GROUPS[request.param]
    jenv = jax_env_factory("CassieTraj-v0", simrate=SIMRATE, **config)
    penv = env_factory("CassieTraj-v0", device="cpu", simrate=SIMRATE,
                       **config)
    keys = jax.random.split(jax.random.PRNGKey(5), FLEET)
    rng = np.random.default_rng(5)
    actions = [f32(rng.normal(0.0, 0.2, (FLEET, jenv.action_size)))
               for _ in range(T)]
    step_keys = [jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(5), t), FLEET) for t in range(T)]
    js, jobs, ref, spread = jax_fleet_run(jenv, keys, actions, step_keys)
    return dict(jenv=jenv, penv=penv, js=js, jobs=jobs, ref=ref,
                spread=spread, actions=actions,
                reset_noise=traj_reset_draws(jenv, keys),
                step_noise=[traj_step_draws(jenv, k) for k in step_keys])


def test_traj_reset_matches_jax(group):
    """The reset onto the reference trajectory at JAX's drawn phase and
    speed: observation to f32 rounding, qpos and qvel, the phase length
    and the gait-library index; sizes and mirror tables as JAX's."""
    jenv, penv = group["jenv"], group["penv"]
    assert isinstance(penv, port_traj.CassieTrajEnv)
    assert (penv.observation_size, penv.action_size, penv.clock_inds) == (
        jenv.observation_size, jenv.action_size, jenv.clock_inds)
    np.testing.assert_array_equal(np.asarray(penv.mirrored_obs, float),
                                  np.asarray(jenv.mirrored_obs, float))
    state, obs = penv.reset(group["reset_noise"])
    np.testing.assert_allclose(obs.numpy(), group["jobs"], rtol=1e-5,
                               atol=1e-5)
    ref = port_state(group["js"], port_traj.CassieTrajEnvState)
    torch.testing.assert_close(state.phys.qpos, ref.phys.qpos, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(state.phys.qvel, ref.phys.qvel)
    for name in ("phase", "speed", "traj_idx"):
        torch.testing.assert_close(getattr(state, name), getattr(ref, name))
    for name in ("phaselen", "clock", "clock_y", "clock_d"):
        torch.testing.assert_close(getattr(state, name), getattr(ref, name),
                                   rtol=1e-5, atol=1e-6)
    for field in dataclasses.fields(PhysParams):
        torch.testing.assert_close(getattr(state.params, field.name),
                                   getattr(ref.params, field.name))


def test_traj_steps_match_jax(group):
    state = port_state(group["js"], port_traj.CassieTrajEnvState)
    state = check_fleet_steps(group["penv"], state, group["ref"],
                              group["spread"], group["actions"],
                              group["step_noise"])
    last = port_state(group["ref"][-1]["state"],
                      port_traj.CassieTrajEnvState)
    for name in ("phase", "counter", "time", "simsteps", "orient_add",
                 "prev_action"):
        torch.testing.assert_close(getattr(state, name), getattr(last, name))


def test_traj_checkpoint_leaves_map_onto_the_jax_state(group):
    js = group["js"]
    ours = group["penv"].checkpoint_leaves(
        port_state(js, port_traj.CassieTrajEnvState),
        torch.tensor(group["jobs"]))
    theirs = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_aslip_library_and_iknet_match_jax():
    """The 21 aslip gait cycles and their IK-net targets, and the IK net on
    random task-space inputs, as JAX's (both numpy on the same bytes)."""
    ours = port_trajectory.get_all_aslip_trajectories()
    theirs = jax_traj.get_all_aslip_trajectories()
    assert len(ours) == len(theirs) == 21
    for a, b in zip(ours, theirs):
        assert a.length == b.length
        for k in ("qpos", "qvel", "rpos", "lpos", "cpos", "cvel", "ik_pos"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    x = np.random.default_rng(0).normal(size=(7, 9)).astype(np.float32)
    np.testing.assert_array_equal(port_trajectory.IKNet()(x),
                                  jax_traj.IKNet()(x))
