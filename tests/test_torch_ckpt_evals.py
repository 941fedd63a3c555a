"""The committed checkpoints the port now loads, evaluated against the JAX
package on the CPU at a tiny size, as tests/test_torch_env.py's
test_eval_checkpoint_matches_jax holds mk4_hardened: `curves/
cassie_main_ckpt` (Cassie-v0 with the exact estimator: its experiment.pkl
has no estimator key) and `curves/cassie_traj_ckpt` (CassieTraj-v0, the
walking trajectory, the iros_paper reward).

JAX runs its evaluation protocol (`init_runner` with PRNGKey(42), then
`rollout_scan` with the deterministic policy) at 2 envs and 3 steps, and
the port's `eval_checkpoint` is fed JAX's draws in order. main's
checkpoint predates the env state's phase_add leaf, so JAX loads it
through `scripts/reference_eval_seeds.py`'s `load_experiment_lenient`
(the port reads only the leading model leaves). The returns are held to
three steps of twice the JAX fleet's own reward spread under 1e-6
changes of its joint positions, plus f32 rounding.
"""
import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.agents.rollout import init_runner as jax_init_runner
from apex_tpu.agents.rollout import rollout_scan as jax_rollout_scan
from apex_tpu_torch.envs import cassie as port_cassie
from apex_tpu_torch.envs import cassie_traj as port_traj
from apex_tpu_torch.runtime.evaluate import eval_checkpoint, load_experiment
from test_torch_switches import reset_draws, step_draws
from test_torch_traj import traj_reset_draws, traj_step_draws

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, T = 2, 3
CKPTS = {"main": "curves/cassie_main_ckpt",
         "cassie_traj": "curves/cassie_traj_ckpt"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_loader():
    return _script("reference_eval_seeds").load_experiment_lenient


@pytest.fixture(scope="module", params=list(CKPTS))
def run(request):
    """JAX's evaluation of the checkpoint, its draws in order, and its
    reward spread over the run under 1e-6 changes of the reset state's
    joint positions (the same compiled rollout, started perturbed)."""
    path = os.path.join(ROOT, CKPTS[request.param])
    ppo, state, _ = _reference_loader()(path)
    env = ppo.env

    def policy_fn(_, obs):
        return state.actor.act(state.norm, obs, deterministic=True)

    runner0 = jax_init_runner(env, jax.random.PRNGKey(42), B)
    rollout = jax.jit(lambda r: jax_rollout_scan(env, policy_fn, r, T, T))
    _, traj = rollout(runner0)
    spread = 0.0
    rng = np.random.default_rng(0)
    for _ in range(3):
        q = runner0.env_state.phys.qpos
        scale = 1.0 + 1e-6 * rng.choice([-1.0, 1.0], size=q[:, 7:].shape)
        r = runner0.replace(env_state=runner0.env_state.replace(
            phys=runner0.env_state.phys.replace(
                qpos=q.at[:, 7:].multiply(scale.astype(np.float32)))))
        _, other = rollout(r)
        spread = max(spread, float(jnp.abs(other.reward
                                           - traj.reward).max()))
    traj_env = request.param == "cassie_traj"
    resets = traj_reset_draws if traj_env else reset_draws
    steps = traj_step_draws if traj_env else step_draws
    key_rng, key = jax.random.split(jax.random.PRNGKey(42))
    draws = [("reset", resets(env, jax.random.split(key, B)))]
    for _ in range(T):
        key_rng, _, k_step, k_reset = jax.random.split(key_rng, 4)
        draws.append(("step", steps(env, jax.random.split(k_step, B))))
        draws.append(("reset", resets(env, jax.random.split(k_reset, B))))
    return dict(name=request.param, path=path, env=env, traj=traj,
                draws=draws, spread=spread, state=state)


def test_checkpoint_loads_with_jax_settings(run):
    """load_experiment builds the env JAX's does from the checkpoint's
    experiment.pkl (the exact estimator where the key is missing; the
    trajectory env's defaults) and its actor gives JAX's actions."""
    exp = load_experiment(run["path"], device="cpu")
    jenv = run["env"]
    assert type(exp.env).__name__ == type(jenv).__name__
    assert (exp.env.observation_size, exp.env.action_size,
            exp.env.simrate) == (jenv.observation_size, jenv.action_size,
                                 jenv.simrate)
    if run["name"] == "main":
        assert exp.env.estimator == jenv.estimator == "exact"
        with open(os.path.join(run["path"], "checkpoint.pkl"), "rb") as f:
            assert len(pickle.load(f)) == 87
    obs = np.asarray(run["traj"].obs).reshape(-1, jenv.observation_size)
    with torch.no_grad():
        got = exp.actor.act(exp.norm, torch.tensor(obs), deterministic=True)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(run["traj"].action).reshape(got.shape),
        rtol=1e-5, atol=1e-5)


def test_eval_checkpoint_matches_jax(run, monkeypatch):
    """The port's eval_checkpoint on the CPU, fed JAX's draws, returns the
    JAX protocol's mean return and length."""
    draws = list(run["draws"])

    def take(kind):
        def sample(self, generator, batch):
            got, noise = draws.pop(0)
            assert got == kind and batch == B
            return noise
        return sample

    cls = (port_traj.CassieTrajEnv if run["name"] == "cassie_traj"
           else port_cassie.CassieEnv)
    monkeypatch.setattr(cls, "sample_reset_noise", take("reset"))
    monkeypatch.setattr(cls, "sample_step_noise", take("step"))
    ep_ret, ep_len = eval_checkpoint(run["path"], n_episodes=B, traj_len=T,
                                     device="cpu")
    assert not draws
    traj = run["traj"]
    n_done = int(jnp.sum(traj.done_ep_len > 0))
    assert ep_len == pytest.approx(float(jnp.sum(traj.done_ep_len)) / n_done)
    assert ep_ret == pytest.approx(
        float(jnp.sum(traj.done_ep_return)) / n_done,
        abs=T * (2 * run["spread"] + 1e-5))


def test_eval_on_exported_jax_draws_matches_jax(run, tmp_path):
    """`scripts/export_eval_draws.py`'s sparse file of the draws JAX's run
    used, replayed by `chip_smoke.jax_draws` (as the card's eval_switches
    phase replays them), gives the port's eval_checkpoint JAX's draws: the
    same return as feeding them one by one (test_eval_checkpoint_matches_
    jax's bound)."""
    import chip_smoke

    export = _script("export_eval_draws")
    traj = run["traj"]
    draws = export.eval_draws(run["env"], np.asarray(traj.done_ep_len) > 0,
                              42)
    path = tmp_path / "draws.npz"
    np.savez(path, **draws)
    with chip_smoke.jax_draws(str(path)) as calls:
        ep_ret, ep_len = eval_checkpoint(run["path"], n_episodes=B,
                                         traj_len=T, device="cpu")
    assert calls == {"reset": T + 1, "step": T}
    n_done = int(jnp.sum(traj.done_ep_len > 0))
    assert ep_len == pytest.approx(float(jnp.sum(traj.done_ep_len)) / n_done)
    assert ep_ret == pytest.approx(
        float(jnp.sum(traj.done_ep_return)) / n_done,
        abs=T * (2 * run["spread"] + 1e-5))
