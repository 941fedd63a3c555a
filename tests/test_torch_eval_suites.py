"""The port's evaluation battery against the JAX package on the CPU: the
env entry points the command and push suites drive (reset_for_test,
phase_add), the mission and trajectory data, and the command and
perturbation suites (the 5k suite and its entry points:
tests/test_torch_eval_5k.py).

The envs take the mk4_hardened and mk5c checkpoints' settings; where they
step, their simrate is cut to 3 substeps per policy step (a port step on
the CPU costs ~27 ms per substep), which changes no suite's logic. The
policies are the checkpoints' actors: the port's on its side, the same
weights in jax.numpy on JAX's (`jax_policy`). jax.random and torch draw
different numbers, so the port is handed JAX's draws (resets, the steps'
command changes, the command schedules), recomputed here from JAX's key
sequence. Each JAX suite is run through its own eager pieces (one jitted
env step per configuration) where jitting the whole suite would compile
the physics again; `eval_commands` also runs whole on a stub env,
which compiles in a second.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import struct

from apex_tpu.envs import trajectory as jax_traj
from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.envs.cassie import CassieEnvState as JaxCassieEnvState
from apex_tpu.physics.cassie_sim import CassiePhysState as JaxPhysState
from apex_tpu.physics.engine import PhysParams as JaxPhysParams
from apex_tpu.rewards.clock import GaitClock as JaxGaitClock
from apex_tpu.runtime import eval_suites as jax_suites
from apex_tpu_torch.envs import cassie as port_cassie
from apex_tpu_torch.envs import trajectory as port_traj
from apex_tpu_torch.runtime import eval_suites
from apex_tpu_torch.runtime.evaluate import load_experiment
from test_torch_env import _port_state, _reset_draws, _step_draws

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPTS = {"mk4_hardened": "curves/cassie_mk4_hardened_ckpt",
         "mk5c": "curves/cassie_mk5c_ckpt"}
# the checkpoints' env settings (their experiment.pkl)
CONFIGS = {
    "mk4_hardened": dict(simrate=50, dynamics_randomization=True,
                         reward="early_clock", estimator="firmware"),
    "mk5c": dict(simrate=60, dynamics_randomization=False,
                 reward="5k_speed_reward", estimator="firmware",
                 terrain="noise", min_speed=0.0, max_speed=3.0)}
SIMRATE = 3
# every JAX fleet step runs FLEET envs, so that its step compiles once
FLEET = 8
# strongly typed f32 (a weakly typed state field would make the jitted
# step trace and compile once more when its output comes back strong)
f32 = lambda x: jnp.asarray(x, jnp.float32)
VEL_OBS = np.r_[15:34, 40:46]       # velocity and acceleration entries
POS_OBS = np.setdiff1d(np.arange(50), VEL_OBS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: one torch
    thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def envs(name, simrate=None):
    """(JAX env, port env) of a checkpoint's settings."""
    cfg = dict(CONFIGS[name], **({"simrate": simrate} if simrate else {}))
    return JaxCassieEnv(**cfg), port_cassie.CassieEnv(device="cpu", **cfg)


def jax_policy(exp):
    """The port actor's deterministic policy in jax.numpy."""
    sd = {k: jnp.asarray(v.detach().numpy())
          for k, v in exp.actor.state_dict().items()}
    mean = jnp.asarray(exp.norm.mean.numpy())
    std = jnp.asarray(exp.norm.std.numpy())
    n_layers = len(exp.actor.layers)

    def policy_fn(obs):
        x = (obs - mean) / std
        for i in range(n_layers):
            x = jax.nn.relu(x @ sd[f"layers.{i}.weight"].T
                            + sd[f"layers.{i}.bias"])
        return x @ sd["mean.weight"].T + sd["mean.bias"]
    return policy_fn


@pytest.fixture(scope="module")
def mk4():
    """The mk4_hardened envs at SIMRATE, the policy on both sides, and
    JAX's jitted fleet step."""
    jenv, penv = envs("mk4_hardened", SIMRATE)
    exp = load_experiment(os.path.join(ROOT, CKPTS["mk4_hardened"]),
                          device="cpu")
    return dict(jenv=jenv, penv=penv, exp=exp,
                port_policy=lambda o: exp.actor.act(exp.norm, o,
                                                    deterministic=True),
                jax_policy=jax.jit(jax_policy(exp)),
                step=jax.jit(jax.vmap(jenv.step)))


def _step_draws_seq(jenv, keys):
    """`_step_draws` for a sequence of (B, 2) key arrays in one call:
    eager jax.random costs ~60 ms a call, whatever its batch."""
    flat = _step_draws(jenv, jnp.concatenate(keys))
    B = keys[0].shape[0]
    return [type(flat)(*(None if x is None else x[t * B:(t + 1) * B]
                         for x in flat))
            for t in range(len(keys))]


def _strong(tree):
    """The tree's arrays strongly typed, as a step returns them: JAX's
    reset_for_test leaves a few weakly typed (jnp.asarray(0.15)), and the
    jitted step would trace and compile again for them."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), tree)


def _jax_state(ps):
    """A port fleet state as the JAX env's batch-first CassieEnvState (the
    inverse of test_torch_env._port_state)."""
    bf = lambda x: jnp.asarray(np.moveaxis(x.numpy(), -1, 0))
    pick = lambda cls, obj: cls(**{f.name: bf(getattr(obj, f.name))
                                   for f in dataclasses.fields(cls)})
    nested = {"phys": JaxPhysState, "params": JaxPhysParams,
              "clock": JaxGaitClock}
    return JaxCassieEnvState(
        **{f.name: (pick(nested[f.name], getattr(ps, f.name))
                    if f.name in nested else bf(getattr(ps, f.name)))
           for f in dataclasses.fields(ps)})


def _obs_errors(got, ref):
    err = np.abs(np.asarray(got) - np.asarray(ref))
    return err[:, POS_OBS].max(), err[:, VEL_OBS].max()


def _envelope(run, jstate, n_draws=4):
    """How far JAX's own run(state) -> [(obs, reward), ...] moves when the
    joint positions of the start state change by random factors 1 +- 1e-6:
    the largest (position, velocity, reward) errors over the steps."""
    base = run(jstate)
    rng = np.random.default_rng(0)
    env_ = np.zeros(3)
    for _ in range(n_draws):
        q = jstate.phys.qpos
        scale = 1.0 + 1e-6 * rng.choice([-1.0, 1.0], size=q[:, 7:].shape)
        s = jstate.replace(phys=jstate.phys.replace(
            qpos=q.at[:, 7:].multiply(scale.astype(np.float32))))
        for (obs, rew), (obs0, rew0) in zip(run(s), base):
            env_ = np.maximum(env_, [*_obs_errors(obs, obs0),
                                     np.abs(rew - rew0).max()])
    return base, env_


# ---------------------------------------------------------------------------
# the env entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mk4_hardened", "mk5c"])
def test_reset_for_test_matches_jax(name):
    """The deterministic eval reset at the checkpoint's settings: default
    dynamics, no encoder noise, the grounded swing-0.15/stance-0.25 clock,
    phase_add 1; the state and the observation (f32 rounding of the
    standing pose's FK)."""
    jenv, penv = envs(name)
    js, jobs = jax.jit(jax.vmap(jenv.reset_for_test))(
        jax.random.split(jax.random.PRNGKey(0), 2))
    state, obs = penv.reset_for_test(2)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-5,
                               atol=1e-5)
    ref = _port_state(js)
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(ref, f.name)
        for x, y in zip(*(dataclasses.astuple(v) if dataclasses.is_dataclass(v)
                          else (v,) for v in (a, b))):
            torch.testing.assert_close(x, y.to(x.dtype), rtol=1e-5,
                                       atol=1e-5)


def test_phase_add_steps_match_jax(mk4):
    """Three env steps from the eval reset at the command suite's faster
    gait (phase_add 1.5, 1.6 m/s) and a heading, with JAX's command
    draws: the phase moves by 1.5 a step and wraps past the clock;
    observation, reward and termination held as
    tests/test_torch_env.py::test_steps_match_jax holds them, to twice
    JAX's own divergence under 1e-6 changes of its start state (measured
    here on this input) plus f32 rounding."""
    B, T = FLEET, 3
    jenv, penv = mk4["jenv"], mk4["penv"]
    js, jobs = _strong(jax.jit(jax.vmap(jenv.reset_for_test))(
        jax.random.split(jax.random.PRNGKey(0), B)))
    phaselen = float(js.clock.phaselen[0])
    # even envs from phase 0, odd ones 2 short of the clock's end
    start = np.where(np.arange(B) % 2 == 0, 0.0, phaselen - 2.0)
    js = js.replace(speed=f32([1.6] * B), phase_add=f32([1.5] * B),
                    orient_add=f32(np.linspace(-0.4, 0.4, B)),
                    phase=f32(start))
    keys = [jax.random.split(k, B) for k in
            jax.random.split(jax.random.PRNGKey(5), T)]
    actions, ref = [], []
    s, obs = js, jobs
    for t in range(T):
        actions.append(mk4["jax_policy"](obs))
        s, obs, rew, term, _ = mk4["step"](s, actions[t], keys[t])
        ref.append((np.asarray(obs), np.asarray(rew), np.asarray(term),
                    np.asarray(s.phase)))

    def run(s):
        out = []
        for t in range(T):
            s, obs, rew, _, _ = mk4["step"](s, actions[t], keys[t])
            out.append((np.asarray(obs), np.asarray(rew)))
        return out

    _, env_ = _envelope(run, js)
    state = _port_state(js)
    for t, noise in enumerate(_step_draws_seq(jenv, keys)):
        state, obs, rew, term = penv.step(
            state, torch.tensor(np.asarray(actions[t])), noise)
        r_obs, r_rew, r_term, r_phase = ref[t]
        np.testing.assert_allclose(state.phase.numpy(), r_phase, atol=1e-6)
        np.testing.assert_array_equal(term.numpy(), r_term)
        np.testing.assert_allclose(rew.numpy(), r_rew, rtol=0,
                                   atol=2 * env_[2] + 1e-5)
        pos, vel = _obs_errors(obs.numpy(), r_obs)
        assert pos <= 2 * env_[0] + 1e-5
        assert vel <= 2 * env_[1] + 1e-4
    # 0 -> 1.5 -> 3 -> 4.5; phaselen - 2 -> - 0.5 -> + 1 wraps to 0 -> 1.5
    np.testing.assert_allclose(state.phase.numpy(),
                               np.where(start == 0.0, 4.5, 1.5), atol=1e-5)
    torch.testing.assert_close(state.phase_add, torch.full((B,), 1.5))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_mission_and_trajectory_data_equal_jax():
    """The port's copies of the mission schedules and the walking
    trajectory give JAX's arrays."""
    names = sorted(f[len("mission_"):-len(".npz")]
                   for f in os.listdir(os.path.join(ROOT, "apex_tpu/data"))
                   if f.startswith("mission_"))
    assert len(names) == 25
    for name in names:
        a, b = port_traj.CommandTrajectory(name), \
            jax_traj.CommandTrajectory(name)
        assert a.trajlen == b.trajlen
        for k in ("global_pos", "speed_cmd", "orient"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    a, b = port_traj.CassieTrajectory(), jax_traj.CassieTrajectory()
    assert len(a) == len(b)
    for k in ("time", "qpos", "qvel", "torque", "mpos", "mvel"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# ---------------------------------------------------------------------------
# the suites
# ---------------------------------------------------------------------------

@struct.dataclass
class _StubPhys:
    qpos: jnp.ndarray


@struct.dataclass
class _StubState:
    phys: _StubPhys
    speed: jnp.ndarray
    phase_add: jnp.ndarray
    orient_add: jnp.ndarray


class _JaxStubEnv:
    """An env whose pelvis sinks when the command is hard: 0.02 a step
    above 2 m/s, 0.01 with the faster gait, 0.05 past a heading of 1.3
    rad; so the command suite's failures follow its schedules."""

    def reset_for_test(self, rng=None):
        s = _StubState(phys=_StubPhys(qpos=jnp.asarray([0.0, 0.0, 1.0])),
                       speed=jnp.zeros(()), phase_add=jnp.ones(()),
                       orient_add=jnp.zeros(()))
        return s, self._obs(s)

    def _obs(self, s):
        return jnp.stack([s.speed, s.phase_add, s.orient_add])

    def step(self, s, action, rng):
        drop = (0.02 * (s.speed > 2.0) + 0.01 * (s.phase_add > 1.2)
                + 0.05 * (jnp.abs(s.orient_add) > 1.3))
        s = s.replace(phys=_StubPhys(qpos=s.phys.qpos.at[2].add(-drop)))
        return s, self._obs(s), jnp.zeros(()), jnp.zeros((), bool), {}


@dataclasses.dataclass
class _PortStubState:
    phys: object
    speed: torch.Tensor
    phase_add: torch.Tensor
    orient_add: torch.Tensor


class _PortStubEnv:
    """`_JaxStubEnv` as a port fleet."""
    device = torch.device("cpu")

    def reset_for_test(self, batch):
        qpos = torch.tensor([0.0, 0.0, 1.0])[:, None].repeat(1, batch)
        z = torch.zeros(batch)
        s = _PortStubState(phys=port_cassie.CassiePhysState(
            qpos=qpos, qvel=None, qacc=None), speed=z, phase_add=z + 1.0,
            orient_add=z)
        return s, self._obs(s)

    def _obs(self, s):
        return torch.stack([s.speed, s.phase_add, s.orient_add]).T

    def sample_step_noise(self, generator, batch):
        return None

    def step(self, s, action, noise):
        drop = (0.02 * (s.speed > 2.0) + 0.01 * (s.phase_add > 1.2)
                + 0.05 * (s.orient_add.abs() > 1.3))
        qpos = s.phys.qpos.clone()
        qpos[2] -= drop
        s = dataclasses.replace(s, phys=dataclasses.replace(s.phys,
                                                            qpos=qpos))
        return s, self._obs(s), torch.zeros_like(drop), drop < 0


def _jax_command_draws(n_trials, n_commands, seed=0):
    """The schedule draws of JAX's eval_commands per trial key
    (eval_suites.py:136-153), as the port's CommandDraws, and each
    trial's run key."""
    def one(key):
        _, k_sp, k_mag, k_sgn, k_run = jax.random.split(key, 5)
        sign = lambda k: jax.random.choice(k, jnp.asarray([-1.0, 1.0]),
                                           (n_commands,))
        return (jax.random.uniform(k_sp, (n_commands,), minval=0.4,
                                   maxval=1.3),
                sign(jax.random.fold_in(k_sp, 1)),
                jax.random.uniform(k_mag, (n_commands,), minval=jnp.pi / 6,
                                   maxval=jnp.pi / 3),
                sign(k_sgn), k_run)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
    *draws, k_run = jax.vmap(one)(keys)
    return eval_suites.CommandDraws(
        *(torch.tensor(np.asarray(x)) for x in draws)), k_run


def _assert_command_results_equal(got, ref):
    np.testing.assert_array_equal(got["passed"], np.asarray(ref["passed"]))
    np.testing.assert_array_equal(got["fail_command_idx"],
                                  np.asarray(ref["fail_command_idx"]))
    for k in ("pass_rate", "n_speed_fails", "n_orient_fails",
              "avg_failing_speed", "avg_failing_orient_delta"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, err_msg=k)


def test_eval_commands_semantics_match_jax():
    """JAX's whole eval_commands and the port's on a stub env whose
    failures follow the commands (64 trials, 4 commands of 10 steps),
    with JAX's schedule draws: the same trials fail at the same commands
    and the failure statistics agree -- the schedules' random walk and
    headings, the phase_add bump above 1.4 m/s at the block's start, the
    heading at its midpoint, and the speed/heading classification."""
    kw = dict(n_trials=64, n_commands=4, steps_per_command=10)
    ref = jax_suites.eval_commands(_JaxStubEnv(), lambda o: o, **kw)
    draws, _ = _jax_command_draws(64, 4)
    got = eval_suites.eval_commands(_PortStubEnv(), lambda o: o, **kw,
                                    draws=draws)
    assert 0 < got["pass_rate"] < 1
    assert got["n_speed_fails"] > 0 and got["n_orient_fails"] > 0
    _assert_command_results_equal(got, ref)


def test_eval_commands_matches_jax(mk4, monkeypatch):
    """eval_commands on the mk4_hardened env (4 trials, 2 commands of 30
    steps) with JAX's schedules and step draws fed through, against JAX's
    suite run through its eager pieces (reset_for_test, the command
    schedule, and its jitted fleet step under the suite's key sequence):
    passed, fail_command_idx and the failure statistics."""
    n, nc, spc = 4, 2, 30
    half = spc // 2
    jenv, penv = mk4["jenv"], mk4["penv"]
    draws, k_run = _jax_command_draws(n, nc)
    speeds, orients = eval_suites.command_schedule(draws)
    # JAX's schedule (eval_suites.py:143-156) from the same draws
    d = np.asarray(draws.delta * draws.delta_sign)
    s, walk = np.full(n, 0.5, np.float32), []
    for i in range(nc):
        di = np.where((s + d[:, i] < 0) | (s + d[:, i] > 3.0), -d[:, i],
                      d[:, i])
        s = s + di
        walk.append(s)
    np.testing.assert_allclose(speeds.numpy()[:, 1:],
                               np.stack(walk, 1)[:, :-1], rtol=1e-6)

    # the step keys of each block's two halves, per trial
    def block_keys(idx, which, count):
        return jax.vmap(lambda k: jax.random.split(
            jax.random.fold_in(k, 2 * idx + which), count))(k_run)

    seq = []
    for idx in range(nc):
        for which, count in ((0, half), (1, spc - half)):
            ks = block_keys(idx, which, count)
            seq += [ks[:, t] for t in range(count)]

    # JAX's fleet runs the n trials and copies of them up to FLEET envs
    pad = lambda x: np.resize(np.asarray(x), (FLEET,) + np.shape(x)[1:])
    js, jobs = _strong(jax.jit(jax.vmap(jenv.reset_for_test))(
        jax.random.split(jax.random.PRNGKey(0), FLEET)))
    seq = [pad(k) for k in seq]
    fallen = np.zeros(FLEET, bool)
    fail_idx = np.full(FLEET, -1)
    t = 0
    for idx in range(nc):
        sp = f32(pad(speeds.numpy()[:, idx]))
        js = js.replace(speed=sp, phase_add=f32(jnp.where(sp > 1.4, 1.5,
                                                          1.0)))
        f = np.zeros(FLEET, bool)
        for step in range(spc):
            if step == half:
                js = js.replace(
                    orient_add=f32(pad(orients.numpy()[:, idx])))
            js, jobs, _, _, _ = mk4["step"](js, mk4["jax_policy"](jobs),
                                            seq[t])
            t += 1
            f |= np.asarray(js.phys.qpos[:, 2]) < 0.4
        fail_idx = np.where(fallen | ~f, fail_idx, idx)
        fallen |= f
    passed, fail_idx = ~fallen[:n], fail_idx[:n]
    seq = [k[:n] for k in seq]
    ref = {"passed": passed, "fail_command_idx": fail_idx,
           "pass_rate": passed.mean()}
    ref.update(eval_suites._command_failures(
        passed, fail_idx, speeds.numpy(), orients.numpy(), 3.0))

    noise = iter(_step_draws_seq(jenv, seq))
    monkeypatch.setattr(port_cassie.CassieEnv, "sample_step_noise",
                        lambda self, g, b: next(noise))
    got = eval_suites.eval_commands(penv, mk4["port_policy"], n_trials=n,
                                    n_commands=nc, steps_per_command=spc,
                                    draws=draws)
    assert next(noise, None) is None
    _assert_command_results_equal(got, ref)
    assert got["n_nonfinite"] == 0


def test_eval_perturbation_matches_jax(mk4, monkeypatch):
    """eval_perturbation on the mk4_hardened env (2 angles x 2 forces up to
    50 N x 2 phases; 10 steps to settle, the 8-step push, 10 to recover)
    with JAX's reset and step draws, against JAX's suite through its
    eager pieces (from the same reset): the survival matrix and the
    largest force per angle."""
    kw = dict(num_angles=2, max_force=50.0, num_phases=2, wait_steps=10,
              recover_steps=10)
    jenv, penv = mk4["jenv"], mk4["penv"]
    angles = np.linspace(0, 2 * np.pi, 2, endpoint=False)
    forces = np.arange(25.0, 50.0 + 1e-6, 25.0)
    A, F, P = (x.ravel() for x in np.meshgrid(angles, forces, np.arange(2),
                                              indexing="ij"))
    B = A.size
    keys = jax.vmap(lambda k: jax.random.split(k, 4))(
        jax.random.split(jax.random.PRNGKey(0), B))
    k_reset, k1, k2, k3 = (keys[:, i] for i in range(4))
    seq = []
    for kr, n in ((k1, 10), (k2, 8), (k3, 10)):
        ks = jax.vmap(lambda k: jax.random.split(k, n))(kr)
        seq.append([ks[:, t] for t in range(n)])

    # the fleet reset from JAX's draws (held against JAX's own reset by
    # tests/test_torch_env.py::test_reset_matches_jax), as JAX's state
    reset_noise = _reset_draws(jenv, k_reset)
    ps, pobs = penv.reset(reset_noise)
    js, jobs = _jax_state(ps), jnp.asarray(pobs.numpy())
    js = js.replace(speed=f32([0.5] * B), side_speed=f32([0.0] * B),
                    phase=js.clock.phaselen * f32(P) / 2)
    push = f32(np.zeros((B, 6))).at[:, 3].set(f32(F) * jnp.cos(f32(A)))
    push = push.at[:, 4].set(f32(F) * jnp.sin(f32(A)))
    fallen = np.zeros(B, bool)
    for ext, ks in zip((None, push, f32(np.zeros((B, 6)))), seq):
        if ext is not None:
            js = js.replace(params=js.params.replace(ext_force=ext))
        for k in ks:
            js, jobs, _, term, _ = mk4["step"](js, mk4["jax_policy"](jobs), k)
            fallen |= np.asarray(term)
    ref = (~fallen).reshape(2, 2, 2)

    monkeypatch.setattr(port_cassie.CassieEnv, "sample_reset_noise",
                        lambda self, g, b: reset_noise)
    noise = iter(_step_draws_seq(jenv, [k for ks in seq for k in ks]))
    monkeypatch.setattr(port_cassie.CassieEnv, "sample_step_noise",
                        lambda self, g, b: next(noise))
    got = eval_suites.eval_perturbation(penv, mk4["port_policy"], **kw)
    assert next(noise, None) is None
    np.testing.assert_array_equal(got["survival"], ref)
    want = [forces[np.where(ref[i].all(axis=1))[0].max()]
            if ref[i].all(axis=1).any() else 0.0 for i in range(2)]
    np.testing.assert_array_equal(got["max_force_per_angle"], want)
