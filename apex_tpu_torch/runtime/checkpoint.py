"""Load a JAX PPO checkpoint into the port's modules.

`apex_tpu.runtime.checkpoint.save_checkpoint` pickles the flattened leaves
of the JAX `PPOTrainState` (apex_tpu/agents/ppo.py) as a plain list of
numpy arrays. Flattening follows the dataclass field order (actor, critic,
norm, actor_opt, critic_opt, runner, rng) and sorts dict keys, so the
leading leaves are, with weights stored (in, out):

  actor   layers[0].b, layers[0].w, layers[1].b, layers[1].w,
          [log_std.b, log_std.w  -- learned std only,] mean.b, mean.w
  critic  layers[0].b, layers[0].w, layers[1].b, layers[1].w, out.b, out.w
  norm    mean, var, count

followed by the optimizer states, the rollout runner and the rng, which
evaluation does not need. Reading the file needs numpy only.
`save_checkpoint` writes the same list from the port's PPO, recurrent
PPO, TD3, DDPG, RDPG and ARS train states (the JAX `PPOTrainState`,
`RecurrentPPOState`, `TD3TrainState`, `DPGTrainState` and `ARSTrainState`
in their field order), so that a run directory of the port loads in the
JAX package too; `load_recurrent_ppo` reads a JAX `RecurrentPPOState`
back into the port's (its LSTM cells store (in, 4H) weights, the port's
(4H, in), as nn.LSTMCell does), and `load_td3_actor` the acting net and
normaliser of a TD3 train state.
"""
from __future__ import annotations

import os
import pickle
from collections import OrderedDict
from typing import NamedTuple, Sequence

import numpy as np
import torch


class CheckpointState(NamedTuple):
    """state_dicts for GaussianFFActor, FFV and NormState."""
    actor: "OrderedDict[str, torch.Tensor]"
    critic: "OrderedDict[str, torch.Tensor]"
    norm: "OrderedDict[str, torch.Tensor]"


def _linear(prefix, b, w):
    # JAX keeps (in, out) weights for x @ W; nn.Linear keeps (out, in)
    return [(f"{prefix}.weight", torch.tensor(np.asarray(w, np.float32).T)),
            (f"{prefix}.bias", torch.tensor(np.asarray(b, np.float32)))]


def from_jax_leaves(leaves: Sequence[np.ndarray],
                    learn_stddev: bool = False) -> CheckpointState:
    """Map the leaves of a JAX PPO train state to the port's state_dicts."""
    n_actor = 8 if learn_stddev else 6
    if len(leaves) < n_actor + 9:
        raise ValueError(f"checkpoint has {len(leaves)} leaves, expected a "
                         "JAX PPO train state")
    a = list(leaves[:n_actor])
    actor = _linear("layers.0", a[0], a[1]) + _linear("layers.1", a[2], a[3])
    if learn_stddev:
        actor += _linear("log_std", a[4], a[5])
    actor += _linear("mean", a[-2], a[-1])
    c = leaves[n_actor:n_actor + 6]
    critic = (_linear("layers.0", c[0], c[1]) + _linear("layers.1", c[2], c[3])
              + _linear("out", c[4], c[5]))
    mean, var, count = leaves[n_actor + 6:n_actor + 9]
    norm = [("mean", torch.tensor(np.asarray(mean, np.float32))),
            ("var", torch.tensor(np.asarray(var, np.float32))),
            ("count", torch.tensor(np.asarray(count, np.float32)))]
    if norm[0][1].shape != actor[0][1].shape[1:]:
        raise ValueError("checkpoint leaves do not line up: normalizer of "
                         f"shape {tuple(norm[0][1].shape)} for an actor "
                         f"input of {actor[0][1].shape[1]}")
    return CheckpointState(OrderedDict(actor), OrderedDict(critic),
                           OrderedDict(norm))


def _jax_params(net) -> list:
    """(param tensor, stored transposed) pairs in the JAX flattening order
    of a net of `models/nets.py`: per dense layer (b, w (in, out)), dict
    keys sorted (GaussianFFActor: layers, log_std, mean; FFActor, FFV,
    FFQ: layers, out; DualQCritic: q1, q2, each layers, out; LinearActor:
    l1, l2; the LSTM nets: cells, [log_std,] out)."""
    if hasattr(net, "cells"):
        # LSTM nets: cells[i].{b_hh, b_ih, w_hh (H, 4H), w_ih (in, 4H)},
        # then [log_std,] out
        heads = [net.log_std] if getattr(net, "log_std", None) is not None \
            else []
        return ([x for cell in net.cells for x in (
                    (cell.bias_hh, False), (cell.bias_ih, False),
                    (cell.weight_hh, True), (cell.weight_ih, True))]
                + [x for layer in (*heads, net.out)
                   for x in ((layer.bias, False), (layer.weight, True))])
    if hasattr(net, "branches"):
        return [x for branch in net.branches for x in _jax_params(branch)]
    if hasattr(net, "l1"):
        layers = (net.l1, net.l2)
    elif hasattr(net, "out"):
        layers = (*net.layers, net.out)
    else:
        layers = (*net.layers,
                  *([net.log_std] if net.log_std is not None else []),
                  net.mean)
    return [x for layer in layers
            for x in ((layer.bias, False), (layer.weight, True))]


def _np(x: torch.Tensor, transpose: bool = False) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return np.array(a.T if transpose else a, order="C")


def _adam_leaves(opt, net) -> list:
    """optax.adam's state (ScaleByAdamState(count, mu, nu), then the
    learning-rate scale's empty state): count, mu tree, nu tree."""
    index = {id(p): i for i, p in enumerate(opt.params)}
    order = [(index[id(p)], t) for p, t in _jax_params(net)]
    return ([np.asarray(opt.count, np.int32)]
            + [_np(opt.mu[i], t) for i, t in order]
            + [_np(opt.nu[i], t) for i, t in order])


def _opt_leaves(opt, net) -> list:
    """optax's inject_hyperparams(clip + adam) state: count, hyperparams
    (eps, learning_rate, max_grad_norm), then the adam state."""
    return ([np.asarray(opt.count, np.int32)]
            + [np.asarray(v, np.float32) for v in
               (opt.eps, opt.lr, opt.max_grad_norm)]
            + _adam_leaves(opt, net))


def _net(net) -> list:
    return [_np(p, t) for p, t in _jax_params(net)]


def _norm(norm) -> list:
    return [_np(norm.mean), _np(norm.var), _np(norm.count)]


def _key(seed: int) -> np.ndarray:
    """The rng leaves hold the key PRNGKey(seed) of the run's seed."""
    return np.asarray([0, seed & 0xFFFFFFFF], np.uint32)


def _runner(runner, env, seed: int) -> list:
    return (env.checkpoint_leaves(runner.env_state, runner.obs)
            + [_np(runner.obs), _np(runner.traj_len), _np(runner.ep_return),
               _key(seed)])


def _replay(replay) -> list:
    return ([_np(getattr(replay, f)) for f in replay.FIELDS]
            + [np.asarray(replay.ptr, np.int32),
               np.asarray(replay.size, np.int32)])


def _carry(carry) -> list:
    return [_np(x) for hc in carry for x in hc]


def to_jax_leaves(state, env) -> list:
    """The leaf list of the JAX train state for the port's train state of
    PPO (fields actor, critic, norm, actor_opt, critic_opt, runner, rng),
    recurrent PPO (the same fields, plain adam states, the runner with its
    LSTM carries), RDPG (DDPG's fields with the episode ring),
    TD3 (actor, actor_target, behavior, critic, critic_target, norm,
    actor_opt, critic_opt, replay, runner, rng, update_count,
    param_noise_sigma), DDPG (actor, actor_target, critic, critic_target,
    norm, actor_opt, critic_opt, replay, runner, rng) or ARS (theta, norm,
    rng, total_steps)."""
    from apex_tpu_torch.agents.ars import ARSTrainState
    from apex_tpu_torch.agents.dpg import DPGTrainState
    from apex_tpu_torch.agents.ppo_recurrent import RecurrentPPOState
    from apex_tpu_torch.agents.td3 import TD3TrainState

    key = _key(state.seed)
    if isinstance(state, RecurrentPPOState):
        r = state.runner
        keys = state.jax_keys or (key, key)
        return (_net(state.actor) + _net(state.critic) + _norm(state.norm)
                + _adam_leaves(state.actor_opt, state.actor)
                + _adam_leaves(state.critic_opt, state.critic)
                + env.checkpoint_leaves(r.env_state, r.obs)
                + [_np(r.obs), _np(r.traj_len), _np(r.ep_return)]
                + _carry(r.actor_carry) + _carry(r.critic_carry)
                + [np.array(k, np.uint32) for k in keys])
    if isinstance(state, ARSTrainState):
        return ([_np(state.theta)] + _norm(state.norm)
                + [key, np.asarray(state.total_steps, np.int32)])
    if isinstance(state, (TD3TrainState, DPGTrainState)):
        td3 = isinstance(state, TD3TrainState)
        actors = (state.actor, state.actor_target) + (
            (state.behavior,) if td3 else ())
        out = ([x for net in (*actors, state.critic, state.critic_target)
                for x in _net(net)]
               + _norm(state.norm)
               + _adam_leaves(state.actor_opt, state.actor)
               + _adam_leaves(state.critic_opt, state.critic)
               + _replay(state.replay)
               + _runner(state.runner, env, state.seed) + [key.copy()])
        if td3:
            out += [np.asarray(state.update_count, np.int32),
                    _np(state.param_noise_sigma)]
        return out
    return (_net(state.actor) + _net(state.critic) + _norm(state.norm)
            + _opt_leaves(state.actor_opt, state.actor)
            + _opt_leaves(state.critic_opt, state.critic)
            + _runner(state.runner, env, state.seed) + [key.copy()])


def save_checkpoint(path: str, state, env,
                    name: str = "checkpoint.pkl") -> str:
    """Write the JAX leaf list of a PPO, TD3, DDPG or ARS train state to
    <path>/<name> (`apex_tpu.runtime.checkpoint.save_checkpoint`'s
    format)."""
    os.makedirs(path, exist_ok=True)
    full = os.path.join(path, name)
    tmp = full + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_jax_leaves(state, env), f)
    os.replace(tmp, full)
    return full


def _read(path: str, name: str = "checkpoint.pkl") -> list:
    full = path if path.endswith(".pkl") else os.path.join(path, name)
    with open(full, "rb") as f:
        return pickle.load(f)


@torch.no_grad()
def restore_recurrent_ppo(state, leaves: Sequence[np.ndarray], env):
    """Write the leaves of a JAX `RecurrentPPOState` (as `to_jax_leaves`
    lists them) into a port `RecurrentPPOState` of the same configuration,
    e.g. `RecurrentPPO(env, cfg).init(0)`, in place: nets, normaliser,
    both adam states, the runner with its env state (for envs with
    `state_from_checkpoint_leaves`) and LSTM carries, and the two rng
    leaves, which `to_jax_leaves` writes back as read. Returns the
    state."""
    want = len(to_jax_leaves(state, env))
    if len(leaves) != want:
        raise ValueError(f"checkpoint has {len(leaves)} leaves, the "
                         f"recurrent PPO state {want}")
    it = iter(leaves)

    def put(t: torch.Tensor, transpose: bool = False) -> None:
        x = np.asarray(next(it))
        x = x.T if transpose else x
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf of shape {x.shape} for a "
                             f"tensor of shape {tuple(t.shape)}")
        t.copy_(torch.as_tensor(np.array(x, order="C"), dtype=t.dtype))

    for net in (state.actor, state.critic):
        for p, tr in _jax_params(net):
            put(p, tr)
    for t in (state.norm.mean, state.norm.var, state.norm.count):
        put(t)
    for opt, net in ((state.actor_opt, state.actor),
                     (state.critic_opt, state.critic)):
        opt.count = int(next(it))
        index = {id(p): i for i, p in enumerate(opt.params)}
        order = [(index[id(p)], tr) for p, tr in _jax_params(net)]
        for moments in (opt.mu, opt.nu):
            for i, tr in order:
                put(moments[i], tr)
    r = state.runner
    n_env = len(env.checkpoint_leaves(r.env_state, r.obs))
    env_leaves = [next(it) for _ in range(n_env)]
    if not hasattr(env, "state_from_checkpoint_leaves"):
        raise ValueError(f"{type(env).__name__} cannot restore its env "
                         "state from checkpoint leaves")
    r.env_state = env.state_from_checkpoint_leaves(env_leaves)
    for t in (r.obs, r.traj_len, r.ep_return):
        put(t)
    for h, c in (*r.actor_carry, *r.critic_carry):
        put(h)
        put(c)
    state.jax_keys = [np.asarray(next(it), np.uint32) for _ in range(2)]
    return state


@torch.no_grad()
def restore_ppo_learner(state, leaves: Sequence[np.ndarray]):
    """Write the learner of a JAX `PPOTrainState`'s leaves (as
    `to_jax_leaves` lists them) into a port `PPOTrainState` of the same
    sizes, in place: the nets, the normaliser, and both optimisers' step
    counts and Adam moments (their injected hyperparameters are left as
    the state has them). The runner and generator stay the state's.
    Returns the state."""
    it = iter(leaves)

    def put(t: torch.Tensor, transpose: bool = False) -> None:
        x = np.asarray(next(it))
        x = x.T if transpose else x
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf of shape {x.shape} for a "
                             f"tensor of shape {tuple(t.shape)}")
        t.copy_(torch.as_tensor(np.array(x, order="C"), dtype=t.dtype))

    for net in (state.actor, state.critic):
        for p, tr in _jax_params(net):
            put(p, tr)
    for t in (state.norm.mean, state.norm.var, state.norm.count):
        put(t)
    for opt, net in ((state.actor_opt, state.actor),
                     (state.critic_opt, state.critic)):
        # inject_hyperparams' count and its eps, learning_rate and
        # max_grad_norm, then adam's count, mu and nu (`_opt_leaves`)
        for _ in range(4):
            next(it)
        opt.count = int(next(it))
        index = {id(p): i for i, p in enumerate(opt.params)}
        order = [(index[id(p)], tr) for p, tr in _jax_params(net)]
        for moments in (opt.mu, opt.nu):
            for i, tr in order:
                put(moments[i], tr)
    return state


def load_checkpoint(path: str, learn_stddev: bool = False,
                    name: str = "checkpoint.pkl") -> CheckpointState:
    """Read <path>/<name> (or a .pkl path) written by the JAX package."""
    return from_jax_leaves(_read(path, name), learn_stddev=learn_stddev)


def load_recurrent_ppo(path: str, agent, seed: int = 0,
                       name: str = "checkpoint.pkl"):
    """A port `RecurrentPPOState` from <path>/<name> (or a .pkl path), a
    JAX `RecurrentPPOState`'s leaves, through a template
    `agent.init(seed)` (as the JAX package's `load_checkpoint(path,
    RecurrentPPO(...).init(0))`)."""
    return restore_recurrent_ppo(agent.init(seed), _read(path, name),
                                 agent.env)


# a TD3TrainState's leaves: actor, actor_target and behavior (FFActor, 6
# leaves each), critic and critic_target (DualQCritic, 12 each), then norm
TD3_ACTOR_LEAVES, TD3_NORM_AT = 6, 3 * 6 + 2 * 12
# the names of the actor's and the normaliser's leaves in an .npz
TD3_NPZ_KEYS = tuple(f"actor_{i}" for i in range(TD3_ACTOR_LEAVES)) + (
    "norm_mean", "norm_var", "norm_count")


def td3_actor_leaves(path: str) -> list:
    """The actor's 6 leaves, then the normaliser's mean, var and count, of
    a TD3 run: a JAX `TD3TrainState` checkpoint (a run dir or a .pkl, the
    JAX package's or the port's), or an .npz holding them under
    TD3_NPZ_KEYS (`scripts/export_td3_draws.py` and `torch_eval_td3.py
    --export` write such files)."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return [f[k] for k in TD3_NPZ_KEYS]
    leaves = _read(path)
    return (list(leaves[:TD3_ACTOR_LEAVES])
            + list(leaves[TD3_NORM_AT:TD3_NORM_AT + 3]))


@torch.no_grad()
def load_td3_actor(path: str, device=None, max_action: float = 1.0):
    """(FFActor, NormState) of a TD3 run (`td3_actor_leaves`), on `device`:
    what the deterministic evaluation (`TD3._evaluate`) reads."""
    from apex_tpu_torch.models.nets import FFActor, NormState

    leaves = [np.asarray(x) for x in td3_actor_leaves(path)]
    w0, w1, w_out = leaves[1], leaves[3], leaves[5]
    actor = FFActor(w0.shape[0], w_out.shape[1], (w0.shape[1], w1.shape[1]),
                    max_action=max_action)
    for (p, tr), x in zip(_jax_params(actor), leaves[:TD3_ACTOR_LEAVES]):
        p.copy_(torch.tensor(x.T if tr else x))
    norm = NormState(w0.shape[0])
    for t, x in zip((norm.mean, norm.var, norm.count),
                    leaves[TD3_ACTOR_LEAVES:]):
        t.copy_(torch.tensor(x))
    return actor.to(device).requires_grad_(False), norm.to(device)
