"""CassieStanding-v0, and CassieTraj-v0's remaining switches, of the port
against the JAX package on the CPU, through both factories: the standing
env's reset onto random phases of the stepping trajectory, three steps of
its capture-point reward (with the two reference quirks: qpos[1] as the
height, the right heel read twice) and its checkpoint leaves; and
CassieTraj-v0 on the aslip library with the IK-net PD baseline, the phase
command profile and the foot-orientation trajmatch reward, and on the
stepping trajectory with the traj command profile, the jonah_RNN reward
and a history. Held as tests/test_torch_traj.py holds its groups.
"""
import jax
import numpy as np
import pytest
import torch

from apex_tpu.envs.registry import env_factory as jax_env_factory
from apex_tpu_torch.envs import cassie_standing as port_standing
from apex_tpu_torch.envs import cassie_traj as port_traj
from apex_tpu_torch.envs.registry import env_factory
from apex_tpu_torch.physics.cassie_sim import estimate_state, static_diag
from test_torch_traj import (FLEET, SIMRATE, T, check_fleet_steps, f32,
                             jax_fleet_run, port_state, traj_reset_draws,
                             traj_step_draws)

GROUPS = {
    "aslip_ik_phase_trajmatch_footorient": dict(
        traj="aslip", ik_baseline=True, command_profile="phase",
        reward="trajmatch_footorient_hiprollvelact",
        dynamics_randomization=False),
    "stepping_traj_jonah_history": dict(
        traj="stepping", command_profile="traj", reward="jonah_RNN",
        history=1, dynamics_randomization=False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(jenv, seed, act_scale=0.2):
    keys = jax.random.split(jax.random.PRNGKey(seed), FLEET)
    rng = np.random.default_rng(seed)
    actions = [f32(rng.normal(0.0, act_scale, (FLEET, jenv.action_size)))
               for _ in range(T)]
    step_keys = [jax.random.split(jax.random.fold_in(
        jax.random.PRNGKey(seed), t), FLEET) for t in range(T)]
    js, jobs, ref, spread = jax_fleet_run(jenv, keys, actions, step_keys)
    return dict(keys=keys, step_keys=step_keys, actions=actions, js=js,
                jobs=jobs, ref=ref, spread=spread)


@pytest.fixture(scope="module", params=list(GROUPS))
def group(request):
    config = GROUPS[request.param]
    jenv = jax_env_factory("CassieTraj-v0", simrate=SIMRATE, **config)
    penv = env_factory("CassieTraj-v0", device="cpu", simrate=SIMRATE,
                       **config)
    return dict(jenv=jenv, penv=penv, **_run(jenv, 9))


def test_traj_switch_reset_and_steps_match_jax(group):
    jenv, penv = group["jenv"], group["penv"]
    assert (penv.observation_size, penv.action_size) == (
        jenv.observation_size, jenv.action_size)
    state, obs = penv.reset(traj_reset_draws(jenv, group["keys"]))
    np.testing.assert_allclose(obs.numpy(), group["jobs"], rtol=1e-5,
                               atol=1e-5)
    state = port_state(group["js"], port_traj.CassieTrajEnvState)
    noises = [traj_step_draws(jenv, k) for k in group["step_keys"]]
    state = check_fleet_steps(penv, state, group["ref"], group["spread"],
                              group["actions"], noises)
    last = port_state(group["ref"][-1]["state"],
                      port_traj.CassieTrajEnvState)
    np.testing.assert_allclose(
        state.obs_history.numpy(), last.obs_history.numpy(), rtol=0,
        atol=float(2 * group["spread"]["obs"].max()) + 1e-3)


@pytest.fixture(scope="module")
def standing():
    """CassieStanding-v0 through both factories (the CLI's simrate 50, cut
    to SIMRATE), and JAX's run of it with actions of 0.3 std."""
    jenv = jax_env_factory("CassieStanding-v0", simrate=SIMRATE)
    penv = env_factory("CassieStanding-v0", device="cpu", simrate=SIMRATE)
    return dict(jenv=jenv, penv=penv, **_run(jenv, 4, act_scale=0.3))


def test_standing_reset_matches_jax(standing):
    """The reset onto JAX's drawn phases of the stepping trajectory
    (qpos with y zeroed, qvel as recorded): the 46-entry observation to
    f32 rounding."""
    jenv, penv = standing["jenv"], standing["penv"]
    assert isinstance(penv, port_standing.CassieStandingEnv)
    assert penv.phaselen == jenv.phaselen
    phase = jax.vmap(lambda k: jax.random.randint(
        k, (), 0, jenv.phaselen + 1))(standing["keys"])
    state, obs = penv.reset(port_standing.StandingResetNoise(
        torch.tensor(np.asarray(phase)).long()))
    np.testing.assert_allclose(obs.numpy(), standing["jobs"], rtol=1e-5,
                               atol=1e-5)
    ref = port_state(standing["js"], port_standing.StandingState)
    torch.testing.assert_close(state.phys.qpos, ref.phys.qpos)
    torch.testing.assert_close(state.phase, ref.phase)
    assert float(state.phys.qpos[1].abs().max()) == 0.0


def test_standing_steps_match_jax(standing):
    """Three steps from JAX's state: observation, the capture-point reward
    and termination; and the phase, counter and time JAX carries."""
    state = port_state(standing["js"], port_standing.StandingState)
    state = check_fleet_steps(standing["penv"], state, standing["ref"],
                              standing["spread"], standing["actions"],
                              [None] * T)
    last = port_state(standing["ref"][-1]["state"],
                      port_standing.StandingState)
    for name in ("phase", "counter", "time"):
        torch.testing.assert_close(getattr(state, name), getattr(last, name))


def test_standing_checkpoint_leaves_map_onto_the_jax_state(standing):
    js = standing["js"]
    ours = standing["penv"].checkpoint_leaves(
        port_state(js, port_standing.StandingState),
        torch.tensor(standing["jobs"]))
    theirs = [np.asarray(x) for x in jax.tree_util.tree_leaves(js)]
    assert [(a.shape, a.dtype) for a in ours] == [
        (b.shape, b.dtype) for b in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_standing_reward_quirks():
    """The reward's two reference quirks on hand-made inputs: its height
    terms read qpos[1] (with |qpos[1]| floored at 1e-6 in the capture-point
    velocity), and the right toe's force never counts (the right heel is
    read twice)."""
    env = port_standing.CassieStandingEnv(device="cpu", simrate=SIMRATE)
    # two envs on the same phase; the reset zeroes qpos[1]
    state, _ = env.reset(port_standing.StandingResetNoise(
        torch.tensor([3, 3])))
    diag = static_diag(env.model, env.params(2), state.phys)
    thf = torch.zeros(2, 2, 3, 2)
    thf[..., 2, :] = 100.0              # every contact loaded
    thf[1, 0, 2, 1] = 0.0               # env 1: the right toe unloaded
    diag = diag._replace(toe_heel_force=thf)
    est = estimate_state(env.model, state.phys, diag)
    r = env._reward(state.phys, est, diag)
    assert torch.isfinite(r).all()
    assert float(r[0]) == pytest.approx(float(r[1]), abs=1e-7)
