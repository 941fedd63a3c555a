"""Fleet rollout with auto-reset.

Port of `init_runner` and `rollout_scan` from `apex_tpu/agents/rollout.py`
(itself the replacement of the reference's Ray worker pool,
rl/algos/ppo.py:139-237): every env of the fleet steps each iteration,
finished envs are replaced by freshly reset ones (`tree_where`), and
episode returns and lengths are carried across. The JAX `lax.scan` is a
Python loop here; the env draws its randomness from an explicit generator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from apex_tpu_torch.envs.base import Env
from apex_tpu_torch.utils.tree import tree_map


def tree_where(cond: torch.Tensor, x, y):
    """Select between two batch-last states with a per-env (B,) boolean."""
    return tree_map(lambda a, b: torch.where(cond, a, b), x, y)


@dataclasses.dataclass
class RunnerState:
    """Per-fleet rollout carry."""
    env_state: Any            # batch-last env state
    obs: torch.Tensor         # (B, obs_dim) current observation
    traj_len: torch.Tensor    # (B,) steps since last reset
    ep_return: torch.Tensor   # (B,) running undiscounted return


class Rollout(NamedTuple):
    """(T, B, ...) stacked trajectory slices."""
    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor   # env death at this step
    truncated: torch.Tensor    # max_traj_len cut (alive) at this step
    next_obs: torch.Tensor     # obs after the step (pre-reset)
    done_ep_return: torch.Tensor   # nonzero only at done steps
    done_ep_len: torch.Tensor


def init_runner(env: Env, generator: torch.Generator,
                num_envs: int) -> RunnerState:
    env_state, obs = env.reset_fresh(
        env.sample_reset_noise(generator, num_envs))
    return RunnerState(
        env_state=env_state, obs=obs,
        traj_len=torch.zeros((num_envs,), dtype=torch.int32,
                             device=obs.device),
        ep_return=torch.zeros((num_envs,), device=obs.device))


def rollout_scan(env: Env, policy_fn: Callable[[torch.Tensor], torch.Tensor],
                 runner: RunnerState, generator: torch.Generator,
                 num_steps: int, max_traj_len: int
                 ) -> Tuple[RunnerState, Rollout]:
    """Collect `num_steps` steps from every env of the fleet.

    policy_fn(obs (B, obs_dim)) -> action (B, act_dim). Finished envs are
    reset; episodes continue across successive calls."""
    B = runner.obs.shape[0]
    out = []
    for _ in range(num_steps):
        action = policy_fn(runner.obs)
        env_state, next_obs, reward, terminated = env.step(
            runner.env_state, action, env.sample_step_noise(generator, B))

        traj_len = runner.traj_len + 1
        truncated = (traj_len >= max_traj_len) & ~terminated
        done = terminated | truncated
        ep_return = runner.ep_return + reward

        # auto-reset finished envs
        reset_state, reset_obs = env.reset(
            env.sample_reset_noise(generator, B))
        out.append(Rollout(
            obs=runner.obs, action=action, reward=reward,
            terminated=terminated, truncated=truncated, next_obs=next_obs,
            done_ep_return=torch.where(done, ep_return, 0.0),
            done_ep_len=torch.where(done, traj_len, 0)))
        runner = RunnerState(
            env_state=tree_where(done, reset_state, env_state),
            obs=torch.where(done[:, None], reset_obs, next_obs),
            traj_len=torch.where(done, 0, traj_len),
            ep_return=torch.where(done, 0.0, ep_return))
    return runner, Rollout(*(torch.stack(x) for x in zip(*out)))


def episode_stats(traj: Rollout):
    """Mean return and length of the episodes finished in this rollout,
    their number, and the mean per-step reward (rollout.py:129-140)."""
    n_done = torch.clamp(torch.sum(traj.done_ep_len > 0), min=1)
    return {
        "ep_return": torch.sum(traj.done_ep_return) / n_done,
        "ep_len": torch.sum(traj.done_ep_len) / n_done,
        "num_episodes": torch.sum(traj.done_ep_len > 0),
        "reward_per_step": traj.reward.mean(),
    }


def first_episode_mask(terminated: torch.Tensor, dim: int = 0
                       ) -> torch.Tensor:
    """1.0 at the steps of each env's first episode, the terminating step
    included, along `dim` of a run without resets (ppo_recurrent.py:409-411,
    dpg.py:283-285)."""
    term = terminated.float()
    return ((torch.cumsum(term, dim=dim) - term) == 0).float()


@torch.no_grad()
def evaluate_policy(env: Env, policy_fn: Callable[[torch.Tensor],
                                                  torch.Tensor],
                    generator: torch.Generator, num_envs: int,
                    traj_len: int):
    """Deterministic evaluation (reference ppo.py:464, sync_td3.py:23-44):
    a fresh fleet of `num_envs` for `traj_len` steps; its episode stats."""
    runner = init_runner(env, generator, num_envs)
    _, traj = rollout_scan(env, policy_fn, runner, generator, traj_len,
                           traj_len)
    return episode_stats(traj)
