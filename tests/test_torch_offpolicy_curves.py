"""The collection paths of the port's TD3 and ARS on Walker2d against the
JAX package on the CPU, on JAX's own draws, and the JAX package's trained
TD3 checkpoint (`curves/td3_async_walker_ckpt`) evaluated in the port.

The learning curves (`scripts/torch_train_offpolicy_curve.py` on the card)
are held to JAX's only statistically; what can differ between the stacks
without showing in one update is held here:
  * TD3's collection into the replay ring, in the random warm-up and in
    the acting branch of an async iteration (the exploration noise per
    env, the clip to max_action, `not_done`, the auto-reset): JAX's
    `_train_iteration` itself, and the port's `collect` fed the draws JAX
    took (the key splits of apex_tpu/agents/td3.py:143-160 and
    agents/rollout.py:71-126 repeated here);
  * ARS's `_rollout_batch` (apex_tpu/agents/ars.py:80-123) on θ ± std δ
    from JAX's directions and a normaliser that is not the identity, on
    JAX's reset draws;
  * the deterministic evaluation of JAX's trained actor on JAX's
    initial-state draws.
Walker2d's stiff contacts make two stacks' trajectories part after a few
steps (ROADMAP limit (a)), so states are held at
tests/test_torch_walker2d.py's step tolerances over at most 3 steps: each
collected episode is cut at 3 steps (max_traj_len 3), the ARS episode is 3
steps long, and the 50-step evaluation is held at 3 steps and, as a
return, within the 1.8 % the JAX package sets between its own tiers.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.agents import ars as jax_ars
from apex_tpu.agents import td3 as jax_td3
from apex_tpu.agents.rollout import init_runner as jax_init_runner
from apex_tpu.agents.rollout import rollout_scan as jax_rollout_scan
from apex_tpu.envs.walker2d import Walker2dEnv as JaxWalker2dEnv
from apex_tpu.envs.walker2d import WalkerState as JaxWalkerState
from apex_tpu.models import nets as jax_nets
from apex_tpu_torch.agents import ars, td3
from apex_tpu_torch.agents.rollout import RunnerState
from apex_tpu_torch.agents.rollout import init_runner as port_init_runner
from apex_tpu_torch.agents.rollout import rollout_scan as port_rollout_scan
from apex_tpu_torch.envs.walker2d import (
    Walker2dEnv,
    WalkerResetNoise,
    WalkerState,
)
from apex_tpu_torch.models.nets import NormState
from apex_tpu_torch.runtime import checkpoint

t = torch.tensor
CKPT = "curves/td3_async_walker_ckpt"

# tests/test_torch_walker2d.py::test_env_steps_match_jax's step bounds
OBS_TOL = dict(rtol=5e-2, atol=2e-2)
REWARD_TOL = dict(rtol=1e-4, atol=2 * 2e-5 / 0.008)
EVAL_BOUND = 0.018      # the JAX package's 1.8 % between its own tiers


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: one torch
    thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reset_noise(keys, m):
    """Walker2dEnv.reset's U(-1, 1) draws for each JAX key
    (walker2d.py:63-70), as the port's batch-last noise."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (m.nq,), minval=-1.0, maxval=1.0),
                jax.random.uniform(k2, (m.nv,), minval=-1.0, maxval=1.0))
    q, v = jax.vmap(one)(keys)
    return WalkerResetNoise(qpos=t(np.asarray(q)).T.contiguous(),
                            qvel=t(np.asarray(v)).T.contiguous())


def load_params(net, params):
    """A JAX net's params (numpy leaves, (in, out) weights) into the
    port's module."""
    leaves = jax.tree_util.tree_leaves(params)
    pairs = checkpoint._jax_params(net)
    assert len(pairs) == len(leaves)
    with torch.no_grad():
        for (p, tr), x in zip(pairs, leaves):
            x = np.asarray(x)
            p.copy_(t(x.T if tr else x))


def close(a, b, **tol):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


# ---------------------------------------------------------------------------
# TD3: one async iteration's collection into the ring
# ---------------------------------------------------------------------------

B, T = 4, 8
TD3_CFG = dict(num_envs=B, collect_steps=T, max_traj_len=3, batch_size=8,
               updates_per_iter=1, replay_size=64, async_mode=True)


@pytest.mark.parametrize("branch", ["warmup", "acting"])
def test_td3_collection_fills_the_ring_as_jax(branch, monkeypatch):
    """JAX's `_train_iteration` of an async TD3 (4 envs x 8 steps, episodes
    cut at 3 steps) from a fleet whose envs 1 and 3 start pitched past 1
    rad (they end at the first step: `not_done` 0, then an auto-reset),
    and the port's `collect` from the same fleet and acting net, fed JAX's
    action draws (U(-1, 1) in the warm-up; N(0, 1) times the env's noise
    scale, then the clip, when acting) and its auto-reset draws. The ring
    after the add: obs, next obs, rewards at the step bounds, `not_done`
    exactly, the warm-up's actions exactly; the acting actions are the
    acting net on the port's obs plus JAX's noise times the per-env
    `noise_scales` (JAX's, exactly), clipped (1e-6), and JAX's within the
    obs bound (the net itself is held to JAX's by
    tests/test_torch_offpolicy.py::test_nets_forward_match_jax)."""
    random_actions = branch == "warmup"
    jenv, env = JaxWalker2dEnv(), Walker2dEnv(device="cpu")
    m = env.model
    jtd3 = jax_td3.TD3(jenv, jax_td3.TD3Config(**TD3_CFG))
    js = jtd3.init(seed=3)
    qpos = np.array(js.runner.env_state.qpos)
    qpos[1::2, 2] = 1.2
    qvel = np.asarray(js.runner.env_state.qvel)
    jstate = JaxWalkerState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
    js = js.replace(runner=js.runner.replace(
        env_state=jstate, obs=jax.vmap(jenv._obs)(jstate.qpos, jstate.qvel)))
    jnew, _ = jtd3._train_iteration(js, random_actions=random_actions)

    # JAX's draws: rollout_scan's split of the runner's key per step
    rng, acts, resets = js.runner.rng, [], []
    for _ in range(T):
        rng, k_act, _, k_reset = jax.random.split(rng, 4)
        acts.append(t(np.asarray(
            jax.random.uniform(k_act, (B, env.action_size))
            if random_actions else
            jax.random.normal(k_act, (B, env.action_size)))))
        resets.append(reset_noise(jax.random.split(k_reset, B), m))
    draws = list(acts)

    def fake(shape, generator=None, device=None):
        x = draws.pop(0)
        assert tuple(shape) == tuple(x.shape)
        return x.clone()

    agent = td3.TD3(env, td3.TD3Config(**TD3_CFG))
    state = agent.init(seed=3)
    load_params(state.behavior, js.behavior.params)
    state.runner = RunnerState(
        env_state=WalkerState(t(qpos.T.copy()), t(qvel.T.copy())),
        obs=t(np.asarray(js.runner.obs)),
        traj_len=torch.zeros(B, dtype=torch.int32), ep_return=torch.zeros(B))
    monkeypatch.setattr(torch, "rand" if random_actions else "randn", fake)
    monkeypatch.setattr(env, "sample_reset_noise",
                        lambda gen, batch: resets.pop(0))
    state, traj = td3.collect(env, state, state.behavior,
                              agent.noise_scales[:, None], agent.config,
                              random_actions)
    assert not draws and not resets
    monkeypatch.undo()

    ring, jring = state.replay, jnew.replay
    n = B * T
    assert (ring.ptr, ring.size) == (int(jring.ptr), int(jring.size)) == (
        n, n)
    get = lambda name: getattr(ring, name)[:n]
    jget = lambda name: np.asarray(getattr(jring, name))[:n]
    np.testing.assert_array_equal(get("not_done").numpy(), jget("not_done"))
    nd = jget("not_done").reshape(T, B)
    assert (nd[0, 1::2] == 0).all() and (nd[0, ::2] == 1).all()
    close(get("obs"), jget("obs"), **OBS_TOL)
    close(get("next_obs"), jget("next_obs"), **OBS_TOL)
    close(get("reward"), jget("reward"), **REWARD_TOL)
    # episodes of 1 step (the pitched envs' first) or 3 (cut), then reset
    lens = traj.done_ep_len.numpy()
    assert set(lens[0]) == {0, 1} and set(lens[lens > 0]) <= {1, 2, 3}
    if random_actions:
        np.testing.assert_array_equal(get("action").numpy(), jget("action"))
    else:
        scales = np.asarray(jtd3.noise_scales)
        np.testing.assert_array_equal(agent.noise_scales.numpy(), scales)
        obs = get("obs").reshape(T, B, -1)
        with torch.no_grad():
            want = [torch.clamp(state.behavior.act(state.norm, obs[s])
                                + acts[s] * agent.noise_scales[:, None],
                                -1.0, 1.0) for s in range(T)]
        close(get("action"), torch.cat(want), rtol=1e-6, atol=1e-6)
        close(get("action"), jget("action"), **OBS_TOL)


# ---------------------------------------------------------------------------
# ARS: the candidates' rollout
# ---------------------------------------------------------------------------

ARS_CFG = dict(deltas=4, deltas_used=2, delta_std=0.05, max_traj_len=3,
               hidden_size=8, algo="v2")


def test_ars_rollout_batch_matches_jax(monkeypatch):
    """JAX's `_rollout_batch` on Walker2d for the 8 candidates θ ± std δ
    of one `_iteration` (JAX's directions from its key split, θ and a
    normaliser that are not zero or the identity, large enough that the
    actions move the walker), against the port's on JAX's reset draws
    (the vmapped reset of each candidate's key): the returns at 3 steps'
    reward bound, the steps alive exactly, and the observation sequence
    the fleet acted on at the obs bound."""
    jenv, env = JaxWalker2dEnv(), Walker2dEnv(device="cpu")
    jagent = jax_ars.ARS(jenv, jax_ars.ARSConfig(**ARS_CFG))
    rng = np.random.default_rng(7)
    D, n = jagent._dim, 2 * ARS_CFG["deltas"]
    theta = (0.3 * rng.standard_normal(D)).astype(np.float32)
    mean = (0.1 * rng.standard_normal(17)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 17).astype(np.float32)
    jn = jax_nets.NormState(mean=jnp.asarray(mean), var=jnp.asarray(var),
                            count=jnp.asarray(100.0))
    _, k_delta, k_roll = jax.random.split(jax.random.PRNGKey(4), 3)
    deltas = np.asarray(jax.random.normal(k_delta, (ARS_CFG["deltas"], D)))
    cand = np.concatenate([theta + ARS_CFG["delta_std"] * deltas,
                           theta - ARS_CFG["delta_std"] * deltas])
    jret, jsteps, jobs = jagent._rollout_batch(jnp.asarray(cand), jn, k_roll)

    agent = ars.ARS(env, ars.ARSConfig(**ARS_CFG))
    assert agent.dim == D
    norm = NormState(17)
    norm.mean.copy_(t(mean))
    norm.var.copy_(t(var))
    norm.count.fill_(100.0)
    noise = reset_noise(jax.random.split(k_roll, n), env.model)
    monkeypatch.setattr(env, "sample_reset_noise", lambda gen, batch: noise)
    ret, steps, obs = agent._rollout_batch(t(cand), norm, torch.Generator())
    assert obs.shape == (3, n, 17)
    # the candidates' actions differ and move the walker off its start
    assert float((obs[-1] - obs[0]).abs().max()) > 0.1
    close(obs, np.moveaxis(np.asarray(jobs), 1, 0), **OBS_TOL)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jsteps))
    close(ret, jret, rtol=REWARD_TOL["rtol"], atol=3 * REWARD_TOL["atol"])


# ---------------------------------------------------------------------------
# the JAX package's trained TD3 checkpoint in the port
# ---------------------------------------------------------------------------

def test_jax_td3_checkpoint_evaluates_in_the_port(monkeypatch):
    """`curves/td3_async_walker_ckpt` restored by the JAX package's
    `load_checkpoint` into its TD3 template, and read by the port's
    `load_td3_actor`: the same actor and normaliser, bit for bit (also in
    the card's copy, `curves/jax_eval_draws/td3_async_walker.npz`). JAX's
    deterministic evaluation (`_evaluate`'s init_runner and rollout_scan,
    8 envs x 50 steps, PRNGKey(42)) and the port's `TD3._evaluate` on
    JAX's reset draws: the first 3 steps at the step bounds, the episode
    lengths equal, the mean return within 1.8 %."""
    from apex_tpu.runtime.checkpoint import load_checkpoint as jax_load

    jenv, env = JaxWalker2dEnv(), Walker2dEnv(device="cpu")
    template = jax_td3.TD3(jenv, jax_td3.TD3Config(
        num_envs=64, async_mode=True)).init(0)
    js = jax_load(CKPT, template)
    del template
    actor, norm = checkpoint.load_td3_actor(CKPT, "cpu")
    ours = checkpoint._net(actor) + checkpoint._norm(norm)
    theirs = jax.tree_util.tree_leaves(js.actor.params) + [
        js.norm.mean, js.norm.var, js.norm.count]
    assert len(ours) == len(theirs) == 9
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(checkpoint.td3_actor_leaves(
            "curves/jax_eval_draws/td3_async_walker.npz"),
            checkpoint.td3_actor_leaves(CKPT)):
        np.testing.assert_array_equal(a, b)

    Be, Te = 8, 50
    policy = lambda _, obs: js.actor.act(js.norm, obs)
    runner = jax_init_runner(jenv, jax.random.PRNGKey(42), Be)
    _, jtraj = jax.jit(lambda r: jax_rollout_scan(
        jenv, policy, r, Te, Te))(runner)
    rng, key = jax.random.split(jax.random.PRNGKey(42))
    draws = [reset_noise(jax.random.split(key, Be), env.model)]
    for _ in range(Te):
        rng, _, _, k_reset = jax.random.split(rng, 4)
        draws.append(reset_noise(jax.random.split(k_reset, Be), env.model))

    def script():
        queue = list(draws)
        monkeypatch.setattr(env, "sample_reset_noise",
                            lambda gen, batch: queue.pop(0))
        return queue

    queue = script()
    with torch.no_grad():
        _, traj = port_rollout_scan(
            env, lambda obs: actor.act(norm, obs),
            port_init_runner(env, torch.Generator(), Be), torch.Generator(),
            Te, Te)
    assert not queue
    for s in range(3):
        close(traj.obs[s], jtraj.obs[s], **OBS_TOL)
        close(traj.action[s], jtraj.action[s], **OBS_TOL)
        close(traj.reward[s], jtraj.reward[s], **REWARD_TOL)
    queue = script()
    ev = td3.TD3(env, td3.TD3Config(num_envs=Be, max_traj_len=Te))._evaluate(
        types.SimpleNamespace(actor=actor, norm=norm), torch.Generator())
    assert not queue
    done_len = np.asarray(jtraj.done_ep_len)
    n_done = max(int((done_len > 0).sum()), 1)
    jret = float(np.asarray(jtraj.done_ep_return).sum()) / n_done
    assert float(ev["ep_len"]) == float(done_len.sum()) / n_done
    assert abs(float(ev["ep_return"]) - jret) <= EVAL_BOUND * abs(jret)


def _script(name: str):
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent.parent / "scripts"
    spec = importlib.util.spec_from_file_location(name, path / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_td3_eval_scripts_replay_jax_draws(tmp_path, monkeypatch):
    """The card's route for a TD3 actor, on the CPU at 8 envs x 20 steps:
    `scripts/export_td3_draws.py` (JAX) writes the checkpoint's actor,
    normaliser, JAX's return and its sparse reset draws; `torch_eval_td3.py
    --export` writes the actor alone, which the export reads back to the
    same file; `torch_eval_td3.py` replays JAX's draws through
    `chip_smoke.jax_draws` (every reset draw JAX used) and holds the
    return within its bound, and evaluates on its own draws too; without
    --device cpu it wants the card."""
    small = str(tmp_path / "actor.npz")
    full = str(tmp_path / "draws.npz")
    port = _script("torch_eval_td3")
    port.export(CKPT, small)
    _script("export_td3_draws").main(["--path", small, "--out", full,
                                      "--n_episodes", "8", "--traj_len",
                                      "20", "--spread", "1"])
    with np.load(full) as f, np.load(small) as g:
        assert set(g.files) < set(f.files)
        for k in g.files:
            np.testing.assert_array_equal(f[k], g[k])
        assert f["jax_perturbed_returns"].shape == (1,)
    out = port.main([full, "--device", "cpu", "--n_episodes", "8",
                     "--traj_len", "20"])
    res = out["on_jax_draws"]
    assert res["held"] and abs(res["rel_diff"]) <= EVAL_BOUND
    assert res["ep_len"] == res["jax_length"]
    assert np.isfinite(out["own_draws"]["return"])
    # on the card unless told otherwise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main([full])
