"""The port's CassiePlayground and mission suite against the JAX package on
the CPU, and the committed flagship through the port's command suite.

The playground runs at 3 substeps per policy step (a port step on the CPU
costs ~27 ms per substep), which changes none of its logic; its policy is
the mk4_hardened actor with a zero side speed appended to the 49-dim
observation, as apex.py eval's mission suite does: the port's on its side,
the same weights in jax.numpy on JAX's. JAX's playground step is jitted
once, for fleets of FLEET envs.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs.cassie_playground import CassiePlayground as JaxPlayground
from apex_tpu_torch.envs.cassie_playground import (CassiePlayground,
                                                   PlaygroundState)
from apex_tpu_torch.physics.cassie_sim import CassiePhysState
from apex_tpu_torch.physics.engine import PhysParams
from apex_tpu_torch.runtime import eval_suites
from apex_tpu_torch.runtime.evaluate import load_experiment
from test_torch_eval_suites import jax_policy

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "curves/cassie_mk4_hardened_ckpt")
SIMRATE = 3
FLEET = 2
POS_OBS = np.r_[0:15, 34:40, 46:49]   # positions, orientation, commands


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: one torch
    thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pg():
    """The "default" mission's playground on both sides, the policies, and
    JAX's jitted fleet reset and step."""
    exp = load_experiment(CKPT, device="cpu")
    jenv = JaxPlayground(mission="default", simrate=SIMRATE)
    penv = CassiePlayground(mission="default", simrate=SIMRATE,
                            device="cpu")
    jpol50 = jax_policy(exp)
    jpol = jax.jit(lambda o: jpol50(jnp.concatenate(
        [o, jnp.zeros(o.shape[:-1] + (1,))], axis=-1)))
    return dict(jenv=jenv, penv=penv, jax_policy=jpol,
                port_policy=torch.no_grad()(
                    eval_suites.playground_policy(exp)),
                reset=jax.jit(jax.vmap(jenv.reset)),
                step=jax.jit(jax.vmap(jenv.step)))


def _port_state(js):
    """A batch-first JAX PlaygroundState as the port's batch-last one."""
    bt = lambda x: torch.tensor(np.moveaxis(np.asarray(x), 0, -1).copy())
    pick = lambda cls, obj: cls(**{f.name: bt(getattr(obj, f.name))
                                   for f in dataclasses.fields(cls)})
    return PlaygroundState(
        phys=pick(CassiePhysState, js.phys),
        params=pick(PhysParams, js.params), phase=bt(js.phase),
        counter=bt(js.counter),
        command_counter=bt(js.command_counter).long(), time=bt(js.time),
        last_position=bt(js.last_position), prev_action=bt(js.prev_action))


def _run_jax(pg, js, jobs, T):
    """T steps of JAX's playground fleet with its policy: per step (obs,
    reward, terminated, command_counter, last_position), and the actions."""
    out, actions = [], []
    for _ in range(T):
        actions.append(pg["jax_policy"](jobs))
        js, jobs, rew, term, _ = pg["step"](js, actions[-1], None)
        out.append(tuple(np.asarray(x) for x in (
            jobs, rew, term, js.command_counter, js.last_position)))
    return out, actions


def _envelope(pg, js, actions):
    """JAX's own divergence over the run when the joint positions of the
    start state change by random factors 1 +- 1e-6: the largest errors of
    the position and velocity entries of the observation and of the
    reward."""
    rng = np.random.default_rng(0)
    base, env_ = None, np.zeros(3)
    for draw in range(5):
        s = js
        if draw:
            q = js.phys.qpos
            scale = 1.0 + 1e-6 * rng.choice([-1.0, 1.0],
                                            size=q[:, 7:].shape)
            s = js.replace(phys=js.phys.replace(qpos=q.at[:, 7:].multiply(
                scale.astype(np.float32))))
        run = []
        for a in actions:
            s, obs, rew, _, _ = pg["step"](s, a, None)
            run.append((np.asarray(obs), np.asarray(rew)))
        if base is None:
            base = run
            continue
        for (obs, rew), (obs0, rew0) in zip(run, base):
            err = np.abs(obs - obs0)
            vel = np.setdiff1d(np.arange(49), POS_OBS)
            env_ = np.maximum(env_, [err[:, POS_OBS].max(),
                                     err[:, vel].max(),
                                     np.abs(rew - rew0).max()])
    return env_


def _check_steps(pg, js, jobs, T=3):
    """The port's fleet stepped from JAX's state with JAX's actions against
    JAX's run: observation and reward to twice JAX's own divergence plus
    f32 rounding, termination, the command counter and the mission
    origin exactly."""
    ref, actions = _run_jax(pg, js, jobs, T)
    env_ = _envelope(pg, js, actions)
    state = _port_state(js)
    vel = np.setdiff1d(np.arange(49), POS_OBS)
    for t in range(T):
        state, obs, rew, term = pg["penv"].step(
            state, torch.tensor(np.asarray(actions[t])))
        r_obs, r_rew, r_term, r_cc, r_last = ref[t]
        err = np.abs(obs.numpy() - r_obs)
        assert err[:, POS_OBS].max() <= 2 * env_[0] + 1e-5
        assert err[:, vel].max() <= 2 * env_[1] + 1e-4
        np.testing.assert_allclose(rew.numpy(), r_rew, rtol=0,
                                   atol=2 * env_[2] + 1e-5)
        np.testing.assert_array_equal(term.numpy(), r_term)
        np.testing.assert_array_equal(state.command_counter.numpy(), r_cc)
        np.testing.assert_array_equal(state.last_position.numpy().T, r_last)
    return state


def test_playground_reset_and_steps_match_jax(pg):
    """The reset's 49-dim observation (the heading quirk: the commanded
    heading minus the pelvis quaternion's y component) to f32 rounding,
    then three steps of the fleet."""
    js, jobs = pg["reset"](jax.random.split(jax.random.PRNGKey(0), FLEET))
    state, obs = pg["penv"].reset(FLEET)
    assert obs.shape == (FLEET, 49)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(state.last_position.numpy().T,
                                  np.asarray(js.last_position))
    _check_steps(pg, js, jobs)


def test_playground_through_both_factories(pg):
    """CassiePlayground-v0 is registered in both factories with the keys
    simrate and mission (the port's factory used to refuse it): the JAX
    factory builds the fixture's env, and the port's, stepped from JAX's
    reset, follows JAX's run for three steps; its checkpoint leaves are
    JAX's PlaygroundState's, leaf for leaf."""
    from apex_tpu.envs.registry import env_factory as jax_env_factory
    from apex_tpu_torch.envs.registry import env_factory

    jenv = jax_env_factory("CassiePlayground-v0", simrate=SIMRATE,
                           mission="default", reward="keepalive")
    assert jenv == pg["jenv"]
    penv = env_factory("CassiePlayground-v0", device="cpu",
                       simrate=SIMRATE, mission="default")
    assert isinstance(penv, CassiePlayground)
    assert (penv.simrate, penv.missions) == (SIMRATE, ("default",))
    js, jobs = pg["reset"](jax.random.split(jax.random.PRNGKey(1), FLEET))
    state, obs = penv.reset(FLEET)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-5,
                               atol=1e-5)
    _check_steps(dict(pg, penv=penv), js, jobs)
    ours = penv.checkpoint_leaves(_port_state(js), obs)
    theirs = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    assert [(a.shape, a.dtype) for a in ours] == [
        (b.shape, b.dtype) for b in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_playground_command_counter_wraps_like_jax(pg):
    """From a state two rows before the schedule's end, with a moved
    mission origin and a heading already commanded: the counter wraps one
    row before the table's end, to 0, adding the table's last position to
    the origin, as in JAX."""
    js, jobs = pg["reset"](jax.random.split(jax.random.PRNGKey(0), FLEET))
    T = pg["jenv"].trajlen
    js = js.replace(
        command_counter=jnp.asarray([T - 3, T - 4], jnp.int32),
        last_position=jnp.asarray([[1.0, -2.0, 1.0], [0.5, 0.5, 1.0]],
                                  jnp.float32))
    state = _check_steps(pg, js, jobs)
    np.testing.assert_array_equal(state.command_counter.numpy(), [1, 0])
    last = np.asarray(pg["jenv"]._cmd_pos[-1])
    np.testing.assert_allclose(
        state.last_position.numpy().T,
        np.float32([[1.0, -2.0, 1.0], [0.5, 0.5, 1.0]]) + last, rtol=1e-6)


def test_mission_suite_matches_jax(pg):
    """eval_missions' per-step errors, progress and success for the
    "default" mission (4 steps), against JAX's eval_mission loop through
    its jitted playground step; and a fleet of two missions gives each
    mission's results as a fleet of one does."""
    got = eval_suites.eval_missions(pg["port_policy"], ("default",),
                                    simrate=SIMRATE, max_steps=4,
                                    device="cpu")["default"]
    jenv = pg["jenv"]
    js, jobs = pg["reset"](jax.random.split(jax.random.PRNGKey(0), FLEET))
    fallen, progress, errs = False, 0, []
    for _ in range(4):
        js, jobs, _, term, _ = pg["step"](js, pg["jax_policy"](jobs), None)
        term = bool(term[0])
        progress += int(not (fallen or term))
        qpos, qvel = np.asarray(js.phys.qpos[0]), np.asarray(js.phys.qvel[0])
        cc = int(js.command_counter[0])
        last = np.asarray(js.last_position[0])
        w, x, y, z = qpos[3:7]
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        errs.append([
            np.linalg.norm(qpos[0:2] - (np.asarray(jenv._cmd_pos[cc, 0:2])
                                        + last[0:2])),
            abs(np.linalg.norm(qvel[0:2]) - float(jenv._cmd_speed[cc])),
            abs(yaw - float(jenv._cmd_orient[cc]))])
        fallen = fallen or term
    errs = np.asarray(errs)
    assert (got["success"], got["progress"], got["total"]) == (
        not fallen, progress, 4)
    for k, col in (("pos_error", 0), ("speed_error", 1),
                   ("orient_error", 2)):
        np.testing.assert_allclose(got[k], errs[:, col], rtol=1e-3,
                                   atol=1e-3)

    # the fleet of two, each env with its own table: the CPU fleet step's
    # rounding depends a little on the batch, so the error traces agree to
    # 1e-3 (the two missions' commands differ by ~1 m/s and ~1 m)
    pair = eval_suites.eval_missions(
        pg["port_policy"], ("straight_1.4", "default"), simrate=SIMRATE,
        max_steps=4, device="cpu")
    for name, alone in (("default", got), ("straight_1.4", None)):
        alone = alone or eval_suites.eval_mission(
            pg["port_policy"], name, simrate=SIMRATE, max_steps=4,
            device="cpu")
        for k, v in alone.items():
            np.testing.assert_allclose(pair[name][k], v, rtol=0, atol=1e-3,
                                       err_msg=f"{name} {k}")


def test_eval_commands_on_committed_flagship():
    """tests/test_eval_suites.py::test_eval_commands_on_committed_flagship
    on the port: the committed mk4_hardened walker at its own 50 substeps,
    two trials of one 30-step command from the eval reset, seed 0, must
    not fall -- a wrong failure criterion, a broken reset_for_test state
    or broken command plumbing fails it at once."""
    exp = load_experiment(CKPT, device="cpu")

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    out = eval_suites.eval_commands(exp.env, policy_fn, n_trials=2,
                                    n_commands=1, steps_per_command=30,
                                    seed=0)
    assert out["pass_rate"] == 1.0, out
    assert out["n_nonfinite"] == 0
