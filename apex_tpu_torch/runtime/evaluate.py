"""Deterministic policy evaluation of a saved run.

Port of `load_experiment` and `eval_checkpoint` from
`apex_tpu/runtime/evaluate.py` (reference apex.py:257-280): rebuild the
env and the policy from a run directory holding experiment.pkl and the
JAX checkpoint.pkl, run a fleet of envs for one episode length with the
deterministic policy, and report the mean return and length of the
episodes that finished.
"""
from __future__ import annotations

import os
import pickle
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from apex_tpu_torch.device import resolve_device
from apex_tpu_torch.envs.base import Env
from apex_tpu_torch.envs.registry import env_factory
from apex_tpu_torch.models.nets import FFV, GaussianFFActor, NormState
from apex_tpu_torch.runtime.checkpoint import load_checkpoint


class Experiment(NamedTuple):
    env: Env
    actor: GaussianFFActor
    critic: FFV
    norm: NormState
    args: SimpleNamespace


def load_experiment(path: str, device=None, physics=None) -> Experiment:
    """Rebuild (env, actor, critic, norm, args) from a run directory, with
    the JAX package's defaults for settings the run did not record.
    `physics` picks the PD scan's tier ("megakernel" or "fleet"; None: the
    device's default)."""
    device = resolve_device(device)
    with open(os.path.join(path, "experiment.pkl"), "rb") as f:
        args = SimpleNamespace(**pickle.load(f))
    env = env_factory(
        getattr(args, "env_name", "Cassie-v0"), device=device,
        simrate=getattr(args, "simrate", 50),
        command_profile=getattr(args, "command_profile", "clock"),
        input_profile=getattr(args, "input_profile", "full"),
        learn_gains=getattr(args, "learn_gains", False),
        dynamics_randomization=getattr(args, "dyn_random", False),
        reward=getattr(args, "reward", "early_clock"),
        history=getattr(args, "history", 0),
        estimator=getattr(args, "estimator", "exact"),
        terrain=getattr(args, "terrain", "flat"),
        min_speed=getattr(args, "min_speed", -0.3),
        max_speed=getattr(args, "max_speed", 4.0),
        orient_jump_prob=getattr(args, "orient_jump_prob", 0.0),
        speed_phase_add=getattr(args, "speed_phase_add", False),
        pd_tier=physics)

    learn_stddev = getattr(args, "learn_stddev", False)
    ckpt = load_checkpoint(path, learn_stddev=learn_stddev)
    obs_dim, act_dim = env.observation_size, env.action_size
    actor = GaussianFFActor(
        obs_dim, act_dim,
        fixed_std=None if learn_stddev
        else float(np.exp(getattr(args, "std_dev", -1.5))),
        bounded=getattr(args, "bounded", False))
    critic = FFV(obs_dim)
    norm = NormState(obs_dim)
    actor.load_state_dict(ckpt.actor)
    critic.load_state_dict(ckpt.critic)
    norm.load_state_dict(ckpt.norm)
    return Experiment(env, actor.to(device).eval(), critic.to(device).eval(),
                      norm.to(device), args)


@torch.no_grad()
def eval_checkpoint(path: str, n_episodes: int = 16, traj_len: int = 400,
                    device=None, seed: int = 42, physics=None):
    """Deterministic evaluation of a saved run: `n_episodes` envs step
    `traj_len` times (auto-resetting the ones that fall); prints and
    returns the mean return and length of the finished episodes."""
    from apex_tpu_torch.agents.rollout import init_runner, rollout_scan

    exp = load_experiment(path, device=device, physics=physics)
    env = exp.env
    generator = torch.Generator(device=env.device)
    generator.manual_seed(seed)

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    runner = init_runner(env, generator, n_episodes)
    runner, traj = rollout_scan(env, policy_fn, runner, generator,
                                traj_len, traj_len)

    n_done = int(torch.sum(traj.done_ep_len > 0))
    ep_ret = float(torch.sum(traj.done_ep_return) / max(n_done, 1))
    ep_len = float(torch.sum(traj.done_ep_len) / max(n_done, 1))
    print(f"episodes: {n_done}  mean return: {ep_ret:.2f}  "
          f"mean length: {ep_len:.1f}")
    return ep_ret, ep_len
