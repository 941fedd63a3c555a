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
`save_checkpoint` writes the same list from the port's PPO, TD3, DDPG and
ARS train states (the JAX `PPOTrainState`, `TD3TrainState`,
`DPGTrainState` and `ARSTrainState` in their field order), so that a run
directory of the port loads in the JAX package too.
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
    l1, l2)."""
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


def to_jax_leaves(state, env) -> list:
    """The leaf list of the JAX train state for the port's train state of
    PPO (fields actor, critic, norm, actor_opt, critic_opt, runner, rng),
    TD3 (actor, actor_target, behavior, critic, critic_target, norm,
    actor_opt, critic_opt, replay, runner, rng, update_count,
    param_noise_sigma), DDPG (actor, actor_target, critic, critic_target,
    norm, actor_opt, critic_opt, replay, runner, rng) or ARS (theta, norm,
    rng, total_steps)."""
    from apex_tpu_torch.agents.ars import ARSTrainState
    from apex_tpu_torch.agents.dpg import DPGTrainState
    from apex_tpu_torch.agents.td3 import TD3TrainState

    key = _key(state.seed)
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


def load_checkpoint(path: str, learn_stddev: bool = False,
                    name: str = "checkpoint.pkl") -> CheckpointState:
    """Read <path>/<name> (or a .pkl path) written by the JAX package."""
    full = path if path.endswith(".pkl") else os.path.join(path, name)
    with open(full, "rb") as f:
        leaves = pickle.load(f)
    return from_jax_leaves(leaves, learn_stddev=learn_stddev)
