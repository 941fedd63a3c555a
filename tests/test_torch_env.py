"""The port's evaluation slice against the JAX package on the CPU: the
Cassie-v0 env (reset, three policy steps), the policy loaded from the
JAX-trained mk4_hardened checkpoint, and `eval_checkpoint` as a whole.

The JAX side runs its own evaluation protocol once per module
(`init_runner` with PRNGKey(42), then `rollout_scan` with the
deterministic policy, as `apex_tpu.runtime.evaluate.eval_checkpoint`
does) at 2 envs and 3 steps. jax.random and torch draw different numbers,
so the port is handed the JAX run's own draws, recomputed here from the
same key sequence: the reset draws (command, gait phase, dyn-rand
parameters, encoder offsets) and the step draws (random command changes).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.agents.rollout import init_runner as jax_init_runner
from apex_tpu.agents.rollout import rollout_scan as jax_rollout_scan
from apex_tpu.runtime.evaluate import load_experiment as jax_load_experiment
from apex_tpu_torch.envs import cassie as port_cassie
from apex_tpu_torch.physics.cassie_sim import CassiePhysState
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.rewards.clock import GaitClock
from apex_tpu_torch.runtime import checkpoint
from apex_tpu_torch.runtime.evaluate import eval_checkpoint, load_experiment

CKPT = os.path.join(os.path.dirname(__file__), "..", "curves",
                    "cassie_mk4_hardened_ckpt")
B, T = 2, 3
bt = lambda x: torch.tensor(np.moveaxis(np.asarray(x), 0, -1).copy())


def _reset_draws(env, keys):
    """The draws of apex_tpu CassieEnv.reset / _sample_params per key."""
    def one(rng):
        k_speed, k_side, _, k_phase, k_dyn = jax.random.split(rng, 5)
        k_damp, k_mass, k_fric, k_slope, k_menc, k_jenc = \
            jax.random.split(k_dyn, 6)
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
                u(k_jenc, (6,), -env.encoder_noise, env.encoder_noise))
    return port_cassie.ResetNoise(*(bt(x) for x in jax.vmap(one)(keys)))


def _step_draws(env, keys):
    """The draws of apex_tpu CassieEnv.step's command changes per key."""
    def one(rng):
        k1, k2, k3, k4, k5, k6 = jax.random.split(rng, 9)[:6]
        u = lambda k, lo, hi: jax.random.uniform(k, (), minval=lo, maxval=hi)
        return (jax.random.randint(k1, (), 0, 300) == 0,
                u(k2, -env.max_orient_change, env.max_orient_change),
                jax.random.randint(k3, (), 0, 100) == 0,
                u(k4, env.min_speed, env.max_speed),
                jax.random.randint(k5, (), 0, 300) == 0,
                u(k6, env.min_side_speed, env.max_side_speed))
    return port_cassie.StepNoise(*(bt(x) for x in jax.vmap(one)(keys)))


def _jax_draw_sequence(env):
    """[reset, step, reset, step, ...] draws of the JAX eval protocol:
    init_runner splits PRNGKey(42) once, each rollout step splits the
    carried key into (next, action, step, reset)."""
    rng, key = jax.random.split(jax.random.PRNGKey(42))
    seq = [("reset", _reset_draws(env, jax.random.split(key, B)))]
    for _ in range(T):
        rng, _, k_step, k_reset = jax.random.split(rng, 4)
        seq.append(("step", _step_draws(env, jax.random.split(k_step, B))))
        seq.append(("reset", _reset_draws(env, jax.random.split(k_reset, B))))
    return seq


@pytest.fixture(scope="module")
def jax_run():
    ppo, state, _ = jax_load_experiment(CKPT)
    env = ppo.env

    def policy_fn(_, obs):
        return state.actor.act(state.norm, obs, deterministic=True)

    runner0 = jax_init_runner(env, jax.random.PRNGKey(42), B)
    _, traj = jax.jit(
        lambda r: jax_rollout_scan(env, policy_fn, r, T, T))(runner0)
    return dict(state=state, env=env, runner0=runner0, traj=traj,
                draws=_jax_draw_sequence(env),
                envelope=_jax_envelope(env, runner0, traj))


# observation entries that are velocities or accelerations (full profile:
# pelvis translational and rotational velocity, motor velocities, pelvis
# acceleration, joint velocities); the rest are positions and commands
VEL_OBS = np.r_[15:34, 40:46]
POS_OBS = np.setdiff1d(np.arange(50), VEL_OBS)


def _jax_envelope(env, runner0, traj, n_draws=6):
    """How far the JAX fleet diverges from itself over the T steps of the
    run (same actions and command draws) when the joint positions of the
    reset state change by random factors 1 +- 1e-6, over `n_draws` draws
    and the run itself recompiled as single steps: the largest errors in
    the position and velocity entries of the observation, the 90th
    percentile of the velocity errors, and the reward error."""
    step = jax.jit(jax.vmap(env.step))

    def run(env_state):
        rng, _ = jax.random.split(jax.random.PRNGKey(42))
        out = []
        for t in range(T):
            rng, _, k_step, _ = jax.random.split(rng, 4)
            env_state, obs, reward, _, _ = step(
                env_state, traj.action[t], jax.random.split(k_step, B))
            out.append((np.asarray(obs), np.asarray(reward)))
        return out

    base = run(runner0.env_state)
    runs = [[(np.asarray(traj.next_obs[t]), np.asarray(traj.reward[t]))
             for t in range(T)]]
    rng = np.random.default_rng(0)
    for _ in range(n_draws):
        s = runner0.env_state
        scale = 1.0 + 1e-6 * rng.choice([-1.0, 1.0],
                                        size=s.phys.qpos[:, 7:].shape)
        s = s.replace(phys=s.phys.replace(qpos=s.phys.qpos.at[:, 7:].multiply(
            scale.astype(np.float32))))
        runs.append(run(s))
    env_ = dict(pos=0.0, vel=0.0, vel_q90=0.0, reward=0.0)
    for r in runs:
        for (obs, rew), (obs0, rew0) in zip(r, base):
            err = np.abs(obs - obs0)
            env_["pos"] = max(env_["pos"], float(err[:, POS_OBS].max()))
            env_["vel"] = max(env_["vel"], float(err[:, VEL_OBS].max()))
            env_["vel_q90"] = max(env_["vel_q90"],
                                  float(np.quantile(err[:, VEL_OBS], 0.9)))
            env_["reward"] = max(env_["reward"],
                                 float(np.abs(rew - rew0).max()))
    return env_


def _port_state(js) -> port_cassie.CassieEnvState:
    """A batch-first JAX CassieEnvState as the port's batch-last one."""
    pick = lambda cls, obj: cls(**{f.name: bt(getattr(obj, f.name))
                                   for f in dataclasses.fields(cls)})
    skip = ("phys", "params", "clock")
    return port_cassie.CassieEnvState(
        phys=pick(CassiePhysState, js.phys),
        params=pick(PhysParams, js.params),
        clock=pick(GaitClock, js.clock),
        **{f.name: bt(getattr(js, f.name))
           for f in dataclasses.fields(port_cassie.CassieEnvState)
           if f.name not in skip})


@pytest.fixture(scope="module")
def port_env():
    return port_cassie.CassieEnv(device="cpu")


def test_reset_matches_jax(jax_run, port_env):
    """The same reset draws give the same state and observation (f32
    rounding: the reset state is FK of the standing pose)."""
    kind, noise = jax_run["draws"][0]
    assert kind == "reset"
    state, obs = port_env.reset(noise)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jax_run["runner0"].obs),
                               rtol=1e-5, atol=1e-6)
    ref = _port_state(jax_run["runner0"].env_state)
    for name in ("phase", "speed", "side_speed", "swing_duration",
                 "stance_duration", "motor_enc_noise", "joint_enc_noise"):
        torch.testing.assert_close(getattr(state, name), getattr(ref, name))
    for field in dataclasses.fields(PhysParams):
        torch.testing.assert_close(getattr(state.params, field.name),
                                   getattr(ref.params, field.name))
    for field in dataclasses.fields(GaitClock):
        torch.testing.assert_close(getattr(state.clock, field.name),
                                   getattr(ref.clock, field.name),
                                   rtol=1e-5, atol=1e-5)


def test_steps_match_jax(jax_run, port_env):
    """The JAX reset state, carried across, stepped three times with the
    JAX run's actions and command draws: observation, reward and
    termination.

    Bounds: 150 substeps of stiff contact amplify f32 noise chaotically,
    so the port is held to twice the JAX fleet's own divergence under
    1e-6 changes of its input (`_jax_envelope`, measured here on this very
    input; e.g. ~0.04 in the hip-yaw motor angles and ~3 in the largest
    velocity entry after the second step), plus f32 rounding."""
    traj = jax_run["traj"]
    env_ = jax_run["envelope"]
    state = _port_state(jax_run["runner0"].env_state)
    step_draws = [n for kind, n in jax_run["draws"] if kind == "step"]
    for t in range(T):
        action = torch.tensor(np.asarray(traj.action[t]))
        state, obs, reward, terminated = port_env.step(state, action,
                                                       step_draws[t])
        ref = np.asarray(traj.next_obs[t])
        err = np.abs(obs.numpy() - ref)
        np.testing.assert_array_equal(terminated.numpy(),
                                      np.asarray(traj.terminated[t]))
        np.testing.assert_allclose(reward.numpy(), np.asarray(traj.reward[t]),
                                   rtol=0, atol=2 * env_["reward"] + 1e-5)
        assert err[:, POS_OBS].max() <= 2 * env_["pos"] + 1e-5
        assert err[:, VEL_OBS].max() <= 2 * env_["vel"] + 1e-4
        assert np.quantile(err[:, VEL_OBS], 0.9) <= 2 * env_["vel_q90"] + 1e-4


def test_policy_matches_jax(jax_run):
    """The mk4_hardened actor loaded from the JAX checkpoint gives the
    deterministic actions of JAX's actor.act on the same observations
    (f32 MLP, 256 wide: rounding ~1e-6)."""
    exp = load_experiment(CKPT, device="cpu")
    traj = jax_run["traj"]
    obs = np.asarray(traj.obs).reshape(-1, exp.env.observation_size)
    with torch.no_grad():
        got = exp.actor.act(exp.norm, torch.tensor(obs), deterministic=True)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(traj.action).reshape(got.shape),
        rtol=1e-5, atol=1e-5)


def test_checkpoint_leaves_map_to_the_jax_state(jax_run):
    """load_checkpoint reads the 88-leaf pickle without JAX and gives the
    JAX train state's actor, critic and normalizer."""
    state = jax_run["state"]
    ckpt = checkpoint.load_checkpoint(CKPT)
    assert len(jax.tree_util.tree_leaves(state)) == 88
    np.testing.assert_array_equal(
        ckpt.actor["layers.0.weight"].numpy(),
        np.asarray(state.actor.params["layers"][0]["w"]).T)
    np.testing.assert_array_equal(
        ckpt.critic["out.bias"].numpy(),
        np.asarray(state.critic.params["out"]["b"]))
    np.testing.assert_array_equal(ckpt.norm["var"].numpy(),
                                  np.asarray(state.norm.var))
    same = checkpoint.from_jax_leaves(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(state)])
    for a, b in zip(same, ckpt):
        for k in a:
            torch.testing.assert_close(a[k], b[k])
    with pytest.raises(ValueError):
        checkpoint.from_jax_leaves(
            [np.asarray(x) for x in jax.tree_util.tree_leaves(state)][6:])


def test_eval_checkpoint_matches_jax(jax_run, monkeypatch):
    """The slice as a whole: the port's eval_checkpoint on the CPU, fed the
    JAX run's draws in order, returns the JAX protocol's mean return and
    length (three rewards per episode, each to the step test's bound)."""
    draws = list(jax_run["draws"])

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
    ep_ret, ep_len = eval_checkpoint(CKPT, n_episodes=B, traj_len=T,
                                     device="cpu")
    assert not draws
    traj = jax_run["traj"]
    n_done = int(jnp.sum(traj.done_ep_len > 0))
    assert ep_len == pytest.approx(float(jnp.sum(traj.done_ep_len)) / n_done)
    assert ep_ret == pytest.approx(
        float(jnp.sum(traj.done_ep_return)) / n_done,
        abs=T * (2 * jax_run["envelope"]["reward"] + 1e-5))
