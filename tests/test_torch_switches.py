"""The CassieEnv switches of the port against the JAX package on the CPU:
learned PD gains with an observation history, the min profile and the
clock reward; the phase command profile with the omniscient appendix and
a grounded no_speed clock reward; the reward dispatch over its name
modifiers; reset_for_test with a loaded clock; and PPO's mirror loss with
a history, which both stacks refuse.

Each switch group is one JAX configuration, compiled once (a reset and a
step of FLEET envs at SIMRATE substeps, which changes none of the
switches' logic). jax.random and torch draw different numbers, so the
port is handed JAX's own draws, recomputed from JAX's keys: the reset's
(with the phase profile's gait) and each step's (with the heading
curriculum's jump and the estimator's noise). The port steps from JAX's
reset state with JAX's actions; observation and reward are held to twice
the JAX fleet's own spread under 1e-6 changes of its joint positions,
per observation entry, plus f32 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.agents.ppo import PPO as JaxPPO
from apex_tpu.agents.ppo import PPOConfig as JaxPPOConfig
from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.models.nets import GaussianFFActor as JaxActor
from apex_tpu.models.nets import NormState as JaxNorm
from apex_tpu_torch.agents.ppo import PPO, PPOConfig
from apex_tpu_torch.envs import cassie as port_cassie
from test_torch_env import _port_state

SIMRATE = 3
FLEET = 8
T = 3
f32 = lambda x: jnp.asarray(x, jnp.float32)
bt = lambda x: torch.tensor(np.moveaxis(np.asarray(x), 0, -1).copy())

# the switch groups: (c) learned gains, a two-frame history, the min
# profile and the clock reward; (d) the phase profile, the omniscient
# appendix and a grounded no_speed clock reward
GROUPS = {
    "gains_history_min_clock": dict(learn_gains=True, history=2,
                                    input_profile="min", reward="clock"),
    "phase_omniscient_no_speed_grounded": dict(
        command_profile="phase", omniscient=True,
        reward="no_speed_clock_grounded"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: one torch
    thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reset_draws(env, keys):
    """The draws of JAX's CassieEnv.reset per key, as the port's
    ResetNoise: _sample_params's, and the phase profile's gait from the
    clock key (envs/cassie.py:361-365)."""
    def one(rng):
        k_speed, k_side, k_clock, k_phase, k_dyn = jax.random.split(rng, 5)
        k_damp, k_mass, k_fric, k_slope, k_menc, k_jenc = \
            jax.random.split(k_dyn, 6)
        k_sw, k_st, k_mode = jax.random.split(k_clock, 3)
        u = lambda k, shape, lo, hi: jax.random.uniform(
            k, shape, minval=lo, maxval=hi)
        m = env.model
        return (u(k_speed, (), env.min_speed, env.max_speed),
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
    noise = port_cassie.ResetNoise(*d[:10])
    if env.command_profile == "phase":
        noise = noise._replace(swing=d[10], stance=d[11], mode=d[12].long())
    return noise


def step_draws(env, keys):
    """The draws of JAX's CassieEnv.step per key, as the port's StepNoise:
    the command changes (k1-k6), the heading jump (k7-k9) and the
    estimator noise (fold_in(rng, 7) split four ways)."""
    def one(rng):
        k1, k2, k3, k4, k5, k6, k7, k8, k9 = jax.random.split(rng, 9)
        u = lambda k, lo, hi: jax.random.uniform(k, (), minval=lo, maxval=hi)
        ks = jax.random.split(jax.random.fold_in(rng, 7), 4)
        return (jax.random.randint(k1, (), 0, 300) == 0,
                u(k2, -env.max_orient_change, env.max_orient_change),
                jax.random.randint(k3, (), 0, 100) == 0,
                u(k4, env.min_speed, env.max_speed),
                jax.random.randint(k5, (), 0, 300) == 0,
                u(k6, env.min_side_speed, env.max_side_speed),
                u(k7, jnp.pi / 6, jnp.pi / 3), jax.random.bernoulli(k8),
                jax.random.uniform(k9, ()),
                jnp.concatenate([jax.random.normal(ks[0], (3,)),
                                 jax.random.normal(ks[1], (3,)),
                                 jax.random.normal(ks[2], (10,)),
                                 jax.random.normal(ks[3], (6,))]))
    d = [bt(x) for x in jax.vmap(one)(keys)]
    noise = port_cassie.StepNoise(*d[:6])
    if env.orient_jump_prob > 0:
        noise = noise._replace(jump_size=d[6], jump_sign=d[7], jump_u=d[8])
    if env.estimator == "firmware" and env.estimator_noise > 0:
        noise = noise._replace(est_noise=d[9])
    return noise


def jax_group(config: dict, seed: int = 0, act_scale: float = 0.2):
    """JAX's run of one switch configuration: the fleet's reset, T steps
    with numpy-made actions, the port's draws of both, and JAX's own
    spread over the run (per observation entry, and the reward's) when the
    reset state's joint positions change by random factors 1 +- 1e-6."""
    env = JaxCassieEnv(simrate=SIMRATE, **config)
    keys = jax.random.split(jax.random.PRNGKey(seed), FLEET)
    js, jobs = jax.jit(jax.vmap(env.reset))(keys)
    rng = np.random.default_rng(seed)
    actions = [f32(rng.normal(0.0, act_scale, (FLEET, env.action_size)))
               for _ in range(T)]
    step_keys = [jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(seed), 100 + t), FLEET) for t in range(T)]
    step = jax.jit(jax.vmap(env.step))

    def run(s):
        out = []
        for t in range(T):
            s, obs, rew, term, _ = step(s, actions[t], step_keys[t])
            out.append(dict(state=s, obs=np.asarray(obs),
                            reward=np.asarray(rew),
                            terminated=np.asarray(term)))
        return out

    ref = run(js)
    spread = dict(obs=np.zeros(env.observation_size), reward=0.0)
    draw_rng = np.random.default_rng(1)
    for _ in range(4):
        q = js.phys.qpos
        scale = 1.0 + 1e-6 * draw_rng.choice([-1.0, 1.0], size=q[:, 7:].shape)
        s = js.replace(phys=js.phys.replace(
            qpos=q.at[:, 7:].multiply(scale.astype(np.float32))))
        for a, b in zip(run(s), ref):
            spread["obs"] = np.maximum(
                spread["obs"], np.abs(a["obs"] - b["obs"]).max(axis=0))
            spread["reward"] = max(spread["reward"], float(
                np.abs(a["reward"] - b["reward"]).max()))
    return dict(env=env, state0=js, obs0=np.asarray(jobs), ref=ref,
                actions=actions, spread=spread,
                reset_noise=reset_draws(env, keys),
                step_noise=[step_draws(env, k) for k in step_keys])


def check_reset(run, port_env):
    """The port's reset from JAX's draws: the observation (with its
    history) to f32 rounding, the gait and the phase increment."""
    state, obs = port_env.reset(run["reset_noise"])
    np.testing.assert_allclose(obs.numpy(), run["obs0"], rtol=1e-5,
                               atol=1e-6)
    ref = _port_state(run["state0"])
    for name in ("phase", "speed", "swing_duration", "stance_duration",
                 "stance_mode", "phase_add", "motor_enc_noise"):
        torch.testing.assert_close(getattr(state, name), getattr(ref, name))
    torch.testing.assert_close(state.obs_history, ref.obs_history,
                               rtol=1e-5, atol=1e-6)
    assert state.prev_action.shape == (port_env.action_size, FLEET)


def check_steps(run, port_env):
    """T port steps from JAX's reset state with JAX's actions and draws:
    each observation entry within twice JAX's spread on it plus f32
    rounding, the reward within twice JAX's reward spread, termination
    exactly; and the commands, phase increment and history JAX carries."""
    state = _port_state(run["state0"])
    spread = run["spread"]
    for t in range(T):
        ref = run["ref"][t]
        state, obs, reward, term = port_env.step(
            state, torch.tensor(np.asarray(run["actions"][t])),
            run["step_noise"][t])
        err = np.abs(obs.numpy() - ref["obs"])
        bound = 2 * spread["obs"] + 1e-4 + 1e-5 * np.abs(ref["obs"])
        worst = np.unravel_index(np.argmax(err - bound), err.shape)
        assert (err <= bound).all(), (t, worst, err[worst], bound[worst])
        np.testing.assert_allclose(reward.numpy(), ref["reward"], rtol=0,
                                   atol=2 * spread["reward"] + 1e-5)
        np.testing.assert_array_equal(term.numpy(), ref["terminated"])
        js = _port_state(ref["state"])
        for name in ("orient_add", "speed", "side_speed", "phase",
                     "phase_add", "counter", "time"):
            torch.testing.assert_close(getattr(state, name),
                                       getattr(js, name), rtol=1e-6,
                                       atol=1e-6)
        torch.testing.assert_close(state.prev_action, js.prev_action)
        np.testing.assert_allclose(
            state.obs_history.numpy(), js.obs_history.numpy(),
            rtol=0, atol=float((2 * spread["obs"]).max()) + 1e-3)
    return state


@pytest.fixture(scope="module", params=list(GROUPS))
def group(request):
    config = GROUPS[request.param]
    return dict(run=jax_group(config),
                port=port_cassie.CassieEnv(simrate=SIMRATE, device="cpu",
                                           **config))


def test_group_reset_matches_jax(group):
    run, env = group["run"], group["port"]
    assert env.observation_size == run["env"].observation_size
    assert env.action_size == run["env"].action_size
    assert env.mirrored_obs == run["env"].mirrored_obs
    assert env.mirrored_acts == run["env"].mirrored_acts
    assert env.clock_inds == run["env"].clock_inds
    check_reset(run, env)


def test_group_steps_match_jax(group):
    check_steps(group["run"], group["port"])


def test_checkpoint_leaves_map_onto_the_jax_state(group):
    """checkpoint_leaves of JAX's state carried across gives JAX's leaves,
    leaf for leaf: shapes, dtypes and values (the history's frames
    included)."""
    js = group["run"]["state0"]
    ours = group["port"].checkpoint_leaves(
        _port_state(js), torch.tensor(group["run"]["obs0"]))
    theirs = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


REWARD_NAMES = ["early_clock", "clock", "no_speed_clock", "max_vel_clock",
                "aslip_clock", "clock_grounded", "early_clock_aerial",
                "no_incentive_clock", "clock_switch", "max_vel_clock_aerial",
                "load_incentive_clock_strict0.1_aerial",
                "load_no_incentive_clock_smooth",
                "load_no_incentive_aslip_clock_strict0.3",
                "5k_speed_reward"]


@pytest.mark.parametrize("reward", REWARD_NAMES)
def test_reward_dispatch_matches_jax(reward):
    """A reward name selects the same clock reward, stance mode, incentive
    and switch in both stacks (envs/cassie.py:263-300); the same function
    runs (the speedmatch family apart)."""
    jenv = JaxCassieEnv(reward=reward)
    penv = port_cassie.CassieEnv(reward=reward, device="cpu")
    assert penv._clock_reward.__name__ == \
        jax_reward_name(jenv._reward_key)
    assert penv.have_incentive == jenv.have_incentive
    assert penv._switch == jenv._switch
    np.testing.assert_array_equal(penv._stance_mode[:, 0].numpy(),
                                  np.asarray(jenv._stance_mode))
    assert (penv._speedmatch is None) == (jenv._speedmatch_key is None)
    assert (penv._loaded_clock is None) == (jenv._loaded_clock is None)


def jax_reward_name(key):
    from apex_tpu.rewards.clock import REWARD_FUNCS

    return REWARD_FUNCS[key].__name__


@pytest.mark.parametrize("reward", ["load_incentive_clock_strict0.4",
                                    "early_clock_aerial"])
def test_reset_for_test_matches_jax(reward):
    """reset_for_test's deterministic state: the loaded clock in place of
    the grounded one for a load_ reward (envs/cassie.py:418-422), with
    the incentive of the reward's name; the observation to f32
    rounding."""
    jenv = JaxCassieEnv(reward=reward, simrate=SIMRATE)
    js, jobs = jax.jit(jenv.reset_for_test)()
    penv = port_cassie.CassieEnv(reward=reward, simrate=SIMRATE,
                                 device="cpu")
    state, obs = penv.reset_for_test(2)
    np.testing.assert_allclose(obs.numpy(), np.stack([np.asarray(jobs)] * 2),
                               rtol=1e-5, atol=1e-6)
    for f in ("x", "y", "d", "phaselen"):
        np.testing.assert_allclose(
            getattr(state.clock, f)[..., 0].numpy(),
            np.asarray(getattr(js.clock, f)), rtol=1e-5, atol=1e-5)


def test_mirror_loss_with_history_raises_like_jax():
    """With history > 0 the mirror table covers one frame of the
    observation (envs/cassie.py:248-260); JAX's mirror loss fails on the
    shapes at its first update, the port's PPO refuses at construction."""
    jenv = JaxCassieEnv(history=1)
    ppo = JaxPPO(jenv, JaxPPOConfig(use_mirror=True))
    actor = JaxActor.init(jax.random.PRNGKey(0), jenv.observation_size,
                          jenv.action_size, fixed_std=0.2)
    obs = jnp.zeros((4, jenv.observation_size))
    with pytest.raises(TypeError):
        ppo._policy_losses(actor, JaxNorm.create(jenv.observation_size), obs,
                           jnp.zeros((4, jenv.action_size)), jnp.zeros(4),
                           jnp.zeros(4), 1.0)
    env = port_cassie.CassieEnv(history=1, device="cpu")
    with pytest.raises(ValueError, match="mirror"):
        PPO(env, PPOConfig(use_mirror=True))
    PPO(env, PPOConfig(use_mirror=False))
