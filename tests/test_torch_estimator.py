"""The port's estimator switches and heading curriculum against the JAX
package on the CPU: the exact estimator (no filter lag), as the
checkpoints main, main2 and mk3 run it; and the firmware estimator with
its measurement noise, the heading curriculum's jumps (at a jump
probability of 0.5, so that the fleet jumps within three steps) and
speed_phase_add, with dynamics randomization, as mk5a runs them.

Each group is one JAX configuration at FLEET envs and SIMRATE substeps,
held as tests/test_torch_switches.py holds its groups (JAX's own draws,
twice JAX's spread); the draws a switch adds are taken only when it is
on, so the generator's sequence of every other configuration stays.
"""
import numpy as np
import pytest
import torch

from apex_tpu_torch.envs import cassie as port_cassie
from test_torch_switches import (FLEET, SIMRATE, check_reset, check_steps,
                                 jax_group)

GROUPS = {
    "exact": dict(estimator="exact", dynamics_randomization=False),
    "noise_jump_speed_phase_add": dict(
        estimator="firmware", estimator_noise=0.05, orient_jump_prob=0.5,
        speed_phase_add=True, dynamics_randomization=True, min_speed=0.0,
        max_speed=3.0),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=list(GROUPS))
def group(request):
    config = GROUPS[request.param]
    return dict(name=request.param, run=jax_group(config, seed=3),
                port=port_cassie.CassieEnv(simrate=SIMRATE, device="cpu",
                                           **config))


def test_group_reset_matches_jax(group):
    check_reset(group["run"], group["port"])


def test_group_steps_match_jax(group):
    """Three steps from JAX's state; with the curriculum on, the heading
    jumps of JAX's draws land (some env jumps), and phase_add follows the
    commanded speed."""
    state = check_steps(group["run"], group["port"])
    if group["name"] != "exact":
        jumped = [n.jump_u < 0.5 for n in group["run"]["step_noise"]]
        assert bool(torch.stack(jumped).any())
        np.testing.assert_array_equal(
            state.phase_add.numpy(),
            np.where(state.speed.numpy() > 1.4, 1.5, 1.0))


def test_switch_draws_only_when_on():
    """A switch's draws come after the draws every configuration takes, and
    only when it is on: the same generator gives the default env and the
    switched one the same command draws."""
    plain = port_cassie.CassieEnv(device="cpu")
    switched = port_cassie.CassieEnv(device="cpu", estimator_noise=0.1,
                                     orient_jump_prob=0.1)
    phase = port_cassie.CassieEnv(device="cpu", command_profile="phase")
    draws = {}
    for name, env in (("plain", plain), ("switched", switched),
                      ("phase", phase)):
        g = torch.Generator()
        g.manual_seed(7)
        draws[name] = (env.sample_reset_noise(g, 5),
                       env.sample_step_noise(g, 5))
    for name in ("switched", "phase"):
        for a, b in zip(draws["plain"][0], draws[name][0]):
            if a is not None:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(draws["plain"][1][:6], draws["switched"][1][:6]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert draws["plain"][1].est_noise is None
    assert draws["switched"][1].est_noise.shape == (22, 5)
    assert draws["phase"][0].mode.dtype == torch.int64
    # the exact estimator takes no noise even when it is asked for
    exact = port_cassie.CassieEnv(device="cpu", estimator="exact",
                                  estimator_noise=0.1)
    assert exact.sample_step_noise(torch.Generator(), 2).est_noise is None


def test_estimator_noise_moves_the_observation():
    """The firmware estimator's noise reaches the velocity entries of the
    observation (pelvis, motors, joints) and nothing else, scaled by
    estimator_noise."""
    env = port_cassie.CassieEnv(simrate=SIMRATE, device="cpu",
                                **GROUPS["noise_jump_speed_phase_add"])
    g = torch.Generator()
    g.manual_seed(1)
    state0, _ = env.reset(env.sample_reset_noise(g, FLEET))
    action = 0.2 * torch.randn(FLEET, 10, generator=g)
    noise = env.sample_step_noise(g, FLEET)
    quiet = noise._replace(est_noise=torch.zeros_like(noise.est_noise))
    _, obs_n, _, _ = env.step(state0, action, noise)
    _, obs_q, _, _ = env.step(state0, action, quiet)
    moved = (obs_n - obs_q).abs().amax(dim=0).numpy() > 0
    # full profile: pelvis translational velocity 15-17, rotational 18-20,
    # motor velocities 21-30, joint velocities 40-45
    np.testing.assert_array_equal(np.flatnonzero(moved), np.r_[15:31, 40:46])
    # the pelvis translational velocity is rotated into the heading frame
    # (a norm-preserving map)
    d = (obs_n - obs_q).numpy()
    nz = env.estimator_noise * noise.est_noise.numpy().T
    np.testing.assert_allclose(np.linalg.norm(d[:, 15:18], axis=1),
                               np.linalg.norm(nz[:, 0:3], axis=1),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(d[:, 18:31], nz[:, 3:16], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(d[:, 40:46], nz[:, 16:22], rtol=1e-3,
                               atol=1e-5)


def test_exact_estimator_skips_the_filter():
    """With the exact estimator the observation's velocities are the
    physics' own at the step's end: the firmware estimator's lag moves
    them."""
    ex = port_cassie.CassieEnv(device="cpu", estimator="exact",
                               simrate=SIMRATE)
    fw = port_cassie.CassieEnv(device="cpu", simrate=SIMRATE)
    g = torch.Generator()
    g.manual_seed(0)
    noise = ex.sample_reset_noise(g, FLEET)
    step = ex.sample_step_noise(g, FLEET)
    action = 0.2 * torch.randn(FLEET, 10, generator=g)
    s, _ = ex.reset(noise)
    s_ex, obs_ex, _, _ = ex.step(s, action, step)
    _, obs_fw, _, _ = fw.step(s, action, step)
    np.testing.assert_allclose(obs_ex[:, 21:31].numpy(),
                               s_ex.phys.qvel[[6, 7, 8, 12, 18, 19, 20, 21,
                                               25, 31]].T.numpy(),
                               rtol=1e-6, atol=1e-6)
    assert float((obs_ex[:, 21:31] - obs_fw[:, 21:31]).abs().max()) > 1e-3
