"""The port's recurrent DPG (RDPG) against the JAX package on the CPU: the
episode ring, the collection of one episode per env and the recurrent
evaluation on JAX's draws, one `_train_iteration_rnn`'s BPTT updates on
JAX's episodes and sample indices, and a run dir that JAX loads.

As in tests/test_torch_recurrent.py, the port gets JAX's weights and
JAX's draws (PointMass-v0 keys turned into the port's noise), or the
episodes JAX collected.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.agents import dpg as jax_dpg
from apex_tpu.envs.base import PointMassEnv as JaxPointMassEnv
from apex_tpu.runtime.checkpoint import load_checkpoint as jax_load_ckpt
from apex_tpu_torch.agents import dpg
from apex_tpu_torch.envs.base import PointMassEnv
from apex_tpu_torch.runtime import checkpoint
from apex_tpu_torch.runtime.log import create_logger
from tests.test_torch_recurrent import (
    assert_leaves_close,
    close,
    load_params,
    norms,
    pm_reset_noise,
    pm_step_noise,
    script_noise,
)

OBS, ACT = 4, 2
t = torch.tensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: torch's
    default of one thread per core in each of them oversubscribes the
    CPU, and these many small tensors gain nothing from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_episode_buffer_matches_jax():
    """Adds of 3 episodes into a ring of 5 (wrapping on the second add):
    pointer, size and every field as JAX's after each add; a sample at
    JAX's indices gathers JAX's sample."""
    T, cap = 4, 5
    buf = dpg.EpisodeBuffer(cap, T, 3, 2, torch.device("cpu"))
    jbuf = jax_dpg.EpisodeBuffer.create(cap, T, 3, 2)
    rng = np.random.default_rng(0)
    for _ in range(3):
        eps = [rng.standard_normal(s).astype(np.float32) for s in (
            (3, T, 3), (3, T, 2), (3, T), (3, T, 3), (3, T), (3, T))]
        buf.add_episodes(*(t(x) for x in eps))
        jbuf = jbuf.add_episodes(*eps)
        assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
        for name in buf.FIELDS:
            np.testing.assert_array_equal(getattr(buf, name).numpy(),
                                          np.asarray(getattr(jbuf, name)))
    key = jax.random.PRNGKey(1)
    idx = jax.random.randint(key, (4,), 0, jnp.maximum(jbuf.size, 1))
    for a, b in zip(buf.gather(t(np.asarray(idx))), jbuf.sample(key, 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert buf.sample(torch.Generator(), 6)[0].shape == (6, T, 3)


def load_adam(opt, net, jopt):
    """optax.adam's (count, mu, nu) into a ClippedAdam."""
    count, *moments = jax.tree_util.tree_leaves(jopt)
    index = {id(p): i for i, p in enumerate(opt.params)}
    order = [(index[id(p)], tr) for p, tr in checkpoint._jax_params(net)]
    opt.count = int(count)
    with torch.no_grad():
        for k, x in enumerate(moments):
            i, tr = order[k % len(order)]
            x = np.asarray(x)
            (opt.mu if k < len(order) else opt.nu)[i].copy_(
                t(x.T if tr else x))


def port_state(agent, js, norm):
    """A port DPG state holding JAX's nets, targets, Adam states and
    ring."""
    state = agent.init(seed=0)
    for net, jnet in ((state.actor, js.actor),
                      (state.actor_target, js.actor_target),
                      (state.critic, js.critic),
                      (state.critic_target, js.critic_target)):
        load_params(net, jnet.params)
    load_adam(state.actor_opt, state.actor, js.actor_opt)
    load_adam(state.critic_opt, state.critic, js.critic_opt)
    for name in state.replay.FIELDS:
        getattr(state.replay, name).copy_(t(np.asarray(
            getattr(js.replay, name))))
    state.replay.ptr, state.replay.size = int(js.replay.ptr), int(
        js.replay.size)
    state.norm = norm
    return state


CFG = dict(num_envs=4, max_traj_len=10, episode_capacity=12, traj_batch=3,
           updates_per_iter=3, recurrent=True, tau=0.05)


def test_rdpg_updates_match_jax(monkeypatch):
    """The JAX package's `_train_iteration_rnn` (PointMass-v0 sizes, 4
    envs, 10-step episodes, a ring of 12, batches of 3 episodes, 3
    updates, the CLI's layers (128, 128)) on synthetic episodes that terminate early
    (so the masks cut them), after one earlier iteration (a nonzero Adam
    state, targets apart from the nets): the port's `_update_rnn` on
    JAX's ring after the add and its sample indices (`split(rng, 3)`,
    then `split(k_updates, updates_per_iter)`, dpg.py:293, 341) gives
    the nets, targets and both Adam states at rtol 1e-5 (absolute: 1e-5
    of the leaf's largest entry) and JAX's losses and episode metrics at
    rtol 1e-5."""
    jagent = jax_dpg.DPG(JaxPointMassEnv(), jax_dpg.DPGConfig(**CFG))
    rng = np.random.default_rng(3)
    B, T = CFG["num_envs"], CFG["max_traj_len"]

    def episodes():
        f = lambda *s: rng.standard_normal(s).astype(np.float32)
        term = (rng.random((B, T)) < 0.15).astype(np.float32)
        died = np.cumsum(term, axis=1) - term
        return (f(B, T, OBS), np.clip(f(B, T, ACT), -1, 1), f(B, T),
                f(B, T, OBS), (died == 0).astype(np.float32), 1.0 - term)

    batches = [episodes(), episodes()]
    assert batches[1][4].min() == 0.0      # some episode ends early
    monkeypatch.setattr(jagent, "_collect_episodes",
                        lambda st, k, random_actions: tuple(
                            jnp.asarray(x) for x in batches.pop(0)))
    jn, norm = norms(rng, OBS)
    js = jagent.init(1).replace(norm=jn)
    step = jax.jit(jagent._train_iteration_rnn,
                   static_argnames=("random_actions",))
    # the two iterations trace apart (random_actions is static), each
    # taking its own episodes
    js, _ = step(js, random_actions=True)
    eps = batches[0]
    jnew, jm = step(js, random_actions=False)
    _, _, k_updates = jax.random.split(js.rng, 3)
    size = jnp.maximum(jnew.replay.size, 1)
    idxs = [t(np.asarray(jax.random.randint(k, (CFG["traj_batch"],), 0,
                                            size)))
            for k in jax.random.split(k_updates, CFG["updates_per_iter"])]

    agent = dpg.DPG(PointMassEnv(device="cpu"), dpg.DPGConfig(**CFG))
    state = port_state(agent, jnew.replace(
        actor=js.actor, actor_target=js.actor_target, critic=js.critic,
        critic_target=js.critic_target, actor_opt=js.actor_opt,
        critic_opt=js.critic_opt), norm)
    losses = torch.stack([torch.stack(agent._update_rnn(
        state, state.replay.gather(idx))) for idx in idxs])
    m = agent._rnn_metrics(tuple(t(x) for x in eps), losses)
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    n = 4 * 10 + 3 + 2 * 21
    assert_leaves_close(
        checkpoint.to_jax_leaves(state, agent.env)[:n],
        jax.tree_util.tree_leaves(jnew)[:n], "rdpg")


def test_rdpg_collect_and_evaluate_match_jax():
    """Without exploration noise (expl_noise 0, so that only the env
    draws), `_collect_episodes` on the draws of JAX's (its fleet reset,
    then split(fold_in(key, 1), B) per step) gives JAX's episodes, masks
    and not_done; the recurrent `_evaluate` on JAX's draws (per-step keys
    split(fold_in(rng, t), B), dpg.py:371-374) gives its return, length
    and reward per step; at rtol 1e-5."""
    cfg = dict(CFG, expl_noise=0.0)
    jagent = jax_dpg.DPG(JaxPointMassEnv(), jax_dpg.DPGConfig(**cfg))
    env = PointMassEnv(device="cpu")
    agent = dpg.DPG(env, dpg.DPGConfig(**cfg))
    rng = np.random.default_rng(4)
    jn, norm = norms(rng, OBS)
    js = jagent.init(2).replace(norm=jn)
    state = port_state(agent, js, norm)
    B, T = cfg["num_envs"], cfg["max_traj_len"]

    key = jax.random.PRNGKey(5)
    jeps = jax.jit(jagent._collect_episodes, static_argnums=(2,))(
        js, key, False)
    k_reset, k_roll = jax.random.split(key)
    script_noise(env, [pm_reset_noise(jax.random.split(
        jax.random.split(k_reset)[1], B))],
        [pm_step_noise(jax.random.split(jax.random.fold_in(k, 1), B))
         for k in jax.random.split(k_roll, T)])
    eps = agent._collect_episodes(state, random_actions=False)
    for a, b in zip(eps, jeps):
        close(a, b, 1e-5)

    erng = jax.random.PRNGKey(6)
    jev = jax.jit(jagent._evaluate)(js, erng)
    script_noise(env, [pm_reset_noise(jax.random.split(
        jax.random.split(erng)[1], B))],
        [pm_step_noise(jax.random.split(jax.random.fold_in(erng, i), B))
         for i in range(T)])
    ev = agent._evaluate(state, torch.Generator())
    for k in ("ep_return", "ep_len", "reward_per_step"):
        np.testing.assert_allclose(float(ev[k]), float(jev[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(ev["num_episodes"]) == int(jev["num_episodes"]) == B


def test_rdpg_run_dir_loads_in_the_jax_package(tmp_path):
    """A port RDPG run (PointMass-v0, CPU, the CLI's layers (128, 128), one
    random warm-up iteration and one policy iteration) writes a run dir
    whose checkpoint (nets, targets, Adam states, the episode ring, the
    runner) restores into JAX's template leaf for leaf; the restored
    actor acts as the port's on fixed observations (1e-6); JAX's
    evaluation runs on it."""
    cfg = dict(num_envs=2, max_traj_len=8, episode_capacity=4,
               traj_batch=2, updates_per_iter=2, recurrent=True,
               start_timesteps=16)
    env = PointMassEnv(device="cpu")
    agent = dpg.DPG(env, dpg.DPGConfig(**cfg))
    logger = create_logger({"env_name": "PointMass-v0", "seed": 0,
                            "logdir": str(tmp_path), "algo": "rdpg"})
    state = agent.train(agent.init(0), max_timesteps=32, eval_freq_iters=1,
                        logger=logger, verbose=False,
                        save_fn=lambda st: checkpoint.save_checkpoint(
                            logger.dir, st, env))
    logger.close()
    assert state.replay.size == 4 and state.actor_opt.count == 4
    jagent = jax_dpg.DPG(JaxPointMassEnv(), jax_dpg.DPGConfig(**cfg))
    restored = jax_load_ckpt(logger.dir, jagent.init(0))
    with open(f"{logger.dir}/checkpoint.pkl", "rb") as f:
        saved = pickle.load(f)
    for a, b in zip(jax.tree_util.tree_leaves(restored), saved):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    obs = np.random.default_rng(7).standard_normal((3, 5, OBS)).astype(
        np.float32)
    with torch.no_grad():
        ours = state.actor.seq_act(state.norm, t(obs))
    close(ours, restored.actor.seq_act(restored.norm, obs), 1e-6)
    ev = jagent._evaluate(restored, jax.random.PRNGKey(0))
    assert np.isfinite(float(ev["ep_return"]))
