"""The port's 5k robustness suite against the JAX package on the CPU: the
env entry points it drives (update_speed_state with its phase floor,
step_basic), the exported terrain tables, and eval_5k_matrix, with the
mk5c policy and settings (its simrate cut to 3 substeps per step, as in
tests/test_torch_eval_suites.py, whose helpers this module shares).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs import trajectory as jax_traj
from apex_tpu.runtime import eval_suites as jax_suites
from apex_tpu.utils.quaternion import euler2quat as jax_euler2quat
from apex_tpu_torch.runtime import eval_suites
from apex_tpu_torch.runtime.evaluate import load_experiment
from test_torch_env import _port_state
from test_torch_eval_suites import (CKPTS, ROOT, SIMRATE, _envelope,
                                    _obs_errors, envs, f32, jax_policy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: one torch
    thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("quantize", [True, False])
def test_update_speed_state_matches_jax(quantize):
    """update_speed on random speeds (some beyond mk5c's [0, 3] range, so
    clamped) from random phases: the clock and durations to f32 rounding;
    the rescaled phase exactly with the floor that freezes the clock on a
    speed ramp, and to f32 rounding without it (XLA may fuse the rescale's
    product and quotient differently)."""
    jenv, penv = envs("mk5c")
    B = 16
    rng = np.random.default_rng(1)
    speeds = rng.uniform(-1.0, 4.0, B).astype(np.float32)
    js, _ = jax.jit(jax.vmap(jenv.reset_for_test))(
        jax.random.split(jax.random.PRNGKey(0), B))
    phase = (rng.uniform(0, 1, B) * np.asarray(js.clock.phaselen)).astype(
        np.float32)
    phase[:4] = np.floor(phase[:4])
    js = js.replace(phase=jnp.asarray(phase))
    upd = jax.jit(jax.vmap(lambda s, v: jenv.update_speed_state(
        s, v, quantize_phase=quantize)))
    jout = upd(js, jnp.asarray(speeds))
    pout = penv.update_speed_state(_port_state(js), torch.tensor(speeds),
                                   quantize_phase=quantize)
    if quantize:
        np.testing.assert_array_equal(pout.phase.numpy(),
                                      np.asarray(jout.phase))
    else:
        np.testing.assert_allclose(pout.phase.numpy(),
                                   np.asarray(jout.phase), rtol=1e-6)
    for name in ("speed", "side_speed", "swing_duration", "stance_duration"):
        np.testing.assert_allclose(getattr(pout, name).numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-6, atol=1e-7)
    for f in dataclasses.fields(pout.clock):
        np.testing.assert_allclose(
            getattr(pout.clock, f.name).numpy(),
            np.moveaxis(np.asarray(getattr(jout.clock, f.name)), 0, -1),
            rtol=1e-5, atol=1e-5)


def test_5k_terrains_equal_jax():
    """`_terrain_config` for all eleven 5k terrains: the heightfield tables
    (the exported seed-0 draws) bit for bit, the tilts and their signs."""
    for name in jax_suites.DEFAULT_5K_TERRAINS:
        ref = jax_suites._terrain_config(name)
        got = eval_suites._terrain_config(name)
        assert got[0] == ref[0] and got[2] == ref[2], name
        if ref[1] is None:
            assert got[1] is None
        else:
            np.testing.assert_array_equal(got[1], np.asarray(ref[1]))
    with pytest.raises(ValueError):
        eval_suites._terrain_config("noise1", seed=1)


def test_eval_5k_matrix_matches_jax():
    """eval_5k_matrix on the grid of tests/test_eval_suites.py:46-58
    (straight at 0.9 m/s; flat, noise1 and up_3; friction 1; foot masses 1
    and 1.2; 3 steps) with the mk5c policy and settings, against JAX's
    suite through its eager pieces (reset_for_test, the cell's parameters,
    and per step update_speed_state with its phase floor, the heading and
    step_basic, jitted): the pass tensor and every axis rate; and the
    observations of the three steps, held to twice JAX's own divergence
    under 1e-6 changes of the start state."""
    jenv, penv = envs("mk5c", SIMRATE)
    exp = load_experiment(os.path.join(ROOT, CKPTS["mk5c"]), device="cpu")
    grid = dict(missions=("straight",), mission_speeds=(0.9,),
                terrains=("flat", "noise1", "up_3"), frictions=(1.0,),
                foot_mass_scales=(1.0, 1.2), max_steps=3)
    jpol = jax.jit(jax_policy(exp))

    @torch.no_grad()
    def ppol(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    got = eval_suites.eval_5k_matrix(ppol, penv, **grid)

    # JAX's trials (eval_suites.py:411-438): terrain-major, foot mass
    # fastest, the cell's parameters on the eval reset
    B = 6
    cmd = jax_traj.CommandTrajectory("straight_0.9")
    js, jobs = jax.jit(jax.vmap(jenv.reset_for_test))(
        jax.random.split(jax.random.PRNGKey(0), B))
    cfg = [jax_suites._terrain_config(t) for t in grid["terrains"]]
    hf = np.stack([np.asarray(c[1]) if c[0] else np.zeros((32, 32))
                   for c in cfg]).repeat(2, 0).astype(np.float32)
    mass = np.asarray(js.params.body_mass).copy()
    for fid in (jenv.model.body_id("left-foot"),
                jenv.model.body_id("right-foot")):
        mass[:, fid] *= np.tile(np.float32([1.0, 1.2]), 3)
    ey = jnp.asarray([c[2][0] for c in cfg], jnp.float32).repeat(2)
    ex = jnp.asarray([c[2][1] for c in cfg], jnp.float32).repeat(2)
    js = js.replace(params=js.params.replace(
        body_mass=jnp.asarray(mass),
        floor_quat=jax.vmap(lambda y, x: jax_euler2quat(
            z=jnp.zeros(()), y=y, x=x))(ey, ex),
        hfield=jnp.asarray(hf),
        hfield_active=jnp.asarray([float(c[0]) for c in cfg]).repeat(2)))
    step = jax.jit(jax.vmap(lambda s, sp, orr, a: jenv.step_basic(
        jenv.update_speed_state(s, sp).replace(orient_add=orr), a)))

    def run(s):
        out, obs, fallen = [], jobs, np.zeros(B, bool)
        for i in range(3):
            s, obs = step(s, f32([cmd.speed_cmd[i]] * B),
                          f32([cmd.orient[i]] * B), jpol(obs))
            fallen |= np.asarray(s.phys.qpos[:, 2]) < 0.4
            out.append((np.asarray(obs), fallen.copy(), np.asarray(s.phase)))
        return out

    base, env_ = _envelope(
        lambda s: [(o, np.zeros(B)) for o, _, _ in run(s)], js)
    ref = run(js)
    passed = ~ref[-1][1].reshape(1, 1, 3, 1, 2)
    np.testing.assert_array_equal(got["passed"], passed)
    assert got["pass_rate"] == passed.mean()
    for ax, name in enumerate(("by_mission", "by_speed", "by_terrain",
                               "by_friction", "by_foot_mass")):
        keep = tuple(i for i in range(5) if i != ax)
        names = list(grid.values())[ax]
        assert got[name] == dict(zip(names, passed.mean(axis=keep))), name
    assert got["pass_rate_ref_subset"] == passed[:, :, :2].mean()
    assert got["policy_steps"] == 3 and got["n_nonfinite"] == 0

    state, obs = _port_state(js), torch.tensor(np.asarray(jobs))
    for i in range(3):
        state = penv.update_speed_state(state, float(cmd.speed_cmd[i]))
        state = dataclasses.replace(
            state, orient_add=torch.full((B,), float(cmd.orient[i])))
        state, obs = penv.step_basic(state, ppol(obs))
        pos, vel = _obs_errors(obs.numpy(), base[i][0])
        assert pos <= 2 * env_[0] + 1e-5
        assert vel <= 2 * env_[1] + 1e-4
        # the phase, through update_speed's floor, exactly
        np.testing.assert_array_equal(state.phase.numpy(), ref[i][2])
