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


def load_checkpoint(path: str, learn_stddev: bool = False,
                    name: str = "checkpoint.pkl") -> CheckpointState:
    """Read <path>/<name> (or a .pkl path) written by the JAX package."""
    full = path if path.endswith(".pkl") else os.path.join(path, name)
    with open(full, "rb") as f:
        leaves = pickle.load(f)
    return from_jax_leaves(leaves, learn_stddev=learn_stddev)
