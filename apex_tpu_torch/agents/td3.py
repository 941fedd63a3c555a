"""Twin Delayed DDPG (TD3), sync and async-equivalent, on one device.

Port of `apex_tpu/agents/td3.py` (reference rl/algos/sync_td3.py,
async_td3.py): the env fleet collects `collect_steps` steps per env into
the replay ring on the device, then the learner takes `updates_per_iter`
updates. `async_mode` keeps the Ape-X ingredients of the JAX package:
per-env exploration noise spread over the fleet and an acting snapshot
refreshed every `load_freq` iterations (async_td3.py:206-213).

TD3's math as in the JAX package: clipped target-policy smoothing, the
twin-min backup, the critic step first, then (every `policy_freq`-th
update, counting from 0) the actor step on the updated critic and the
soft target updates. The targets and the acting snapshot are separate
modules with their own storage; the actor's gradient is taken with
respect to the actor's parameters only. One update (`_update`) takes its
batch and its target-policy noise as arguments, so that the tests can
feed it the JAX package's draws. Randomness comes from one
`torch.Generator`. Optimisers: `optax.adam` by its formulas
(`ClippedAdam` without the clip, eps 1e-8).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch.agents.ppo import ClippedAdam
from apex_tpu_torch.agents.replay import ReplayBuffer
from apex_tpu_torch.agents.rollout import (
    RunnerState,
    episode_stats,
    evaluate_policy,
    init_runner,
    rollout_scan,
)
from apex_tpu_torch.envs.base import Env
from apex_tpu_torch.models.nets import DualQCritic, FFActor, NormState

ADAM_EPS = 1e-8                       # optax.adam's default


@dataclasses.dataclass(frozen=True)
class TD3Config:
    """Defaults mirror reference apex.py:174-212 (td3.py:46-71)."""
    num_envs: int = 64
    collect_steps: int = 80            # env steps per iteration per env
    start_timesteps: int = 10000       # random warm-up (sync_td3.py:260)
    expl_noise: float = 0.1
    batch_size: int = 64
    discount: float = 0.99
    tau: float = 0.005
    policy_noise: float = 0.2
    noise_clip: float = 0.5
    policy_freq: int = 2
    a_lr: float = 1e-4
    c_lr: float = 1e-4
    replay_size: int = 1_000_000
    max_traj_len: int = 400
    max_action: float = 1.0
    updates_per_iter: int = 80
    async_mode: bool = False
    load_freq: int = 1                 # async: iterations between snapshots
    param_noise: bool = False
    noise_spread: float = 2.0          # async: env i noise = expl_noise *
                                       # spread^(i/(B-1) - 0.5)


@dataclasses.dataclass
class TD3TrainState:
    actor: FFActor
    actor_target: FFActor
    behavior: FFActor                  # acting snapshot (async staleness)
    critic: DualQCritic
    critic_target: DualQCritic
    norm: NormState
    actor_opt: ClippedAdam
    critic_opt: ClippedAdam
    replay: ReplayBuffer
    runner: RunnerState
    generator: torch.Generator
    seed: int
    update_count: int
    param_noise_sigma: torch.Tensor    # () float32


def frozen_copy(net: torch.nn.Module) -> torch.nn.Module:
    """A copy of a net with its own storage and no gradients: a target or
    an acting snapshot (JAX's `_tree_copy`, td3.py:38-41)."""
    out = copy.deepcopy(net)
    out.requires_grad_(False)
    return out


@torch.no_grad()
def soft_update(target: torch.nn.Module, source: torch.nn.Module,
                tau: float) -> None:
    """target <- (1 - tau) target + tau source, in place."""
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_((1.0 - tau) * t + tau * s)


@torch.no_grad()
def copy_params(target: torch.nn.Module, source: torch.nn.Module) -> None:
    for t, s in zip(target.parameters(), source.parameters()):
        t.copy_(s)


def collect(env: Env, state, act_net: FFActor, noise_scale, cfg,
            random_actions: bool):
    """The fleet's `collect_steps` steps into the replay ring
    (async_td3.py:240-295, dpg.py:140-152), acting with U[-max_action,
    max_action) actions in the random warm-up (sync_td3.py:259-261), else
    with act_net's action plus N(0, 1) noise times `noise_scale` (per env
    or one value), clipped. Returns (state with the new runner,
    trajectory)."""
    gen = state.generator
    m = cfg.max_action

    def policy_fn(obs):
        if random_actions:
            return -m + 2.0 * m * torch.rand(
                (obs.shape[0], env.action_size), generator=gen,
                device=obs.device)
        a = act_net.act(state.norm, obs)
        noise = torch.randn(a.shape, generator=gen, device=a.device)
        return torch.clamp(a + noise * noise_scale, -m, m)

    with torch.no_grad():
        runner, traj = rollout_scan(env, policy_fn, state.runner, gen,
                                    cfg.collect_steps, cfg.max_traj_len)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        # not_done excludes true terminations only: a time-limit cut
        # bootstraps (sync_td3.py:282-284)
        state.replay.add_batch(flat(traj.obs), flat(traj.action),
                               flat(traj.reward), flat(traj.next_obs),
                               1.0 - flat(traj.terminated).float())
    return dataclasses.replace(state, runner=runner), traj


class TD3:
    """Wires an Env and a TD3Config into the train and eval steps."""

    def __init__(self, env: Env, config: TD3Config):
        self.env = env
        self.config = config
        self.device = env.device
        B = config.num_envs
        if config.async_mode:
            scales = config.expl_noise * config.noise_spread ** (
                np.arange(B) / max(B - 1, 1) - 0.5)
        else:
            scales = np.full((B,), config.expl_noise)
        self.noise_scales = torch.tensor(scales, dtype=torch.float32,
                                         device=self.device)

    def init(self, seed: int) -> TD3TrainState:
        cfg = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        actor = FFActor.init(gen, obs_dim, act_dim, max_action=cfg.max_action)
        critic = DualQCritic.init(gen, obs_dim, act_dim)
        with torch.no_grad():
            runner = init_runner(self.env, gen, cfg.num_envs)
        return TD3TrainState(
            actor=actor, actor_target=frozen_copy(actor),
            behavior=frozen_copy(actor), critic=critic,
            critic_target=frozen_copy(critic),
            norm=NormState(obs_dim).to(self.device),
            actor_opt=ClippedAdam(actor.parameters(), cfg.a_lr, None,
                                  ADAM_EPS),
            critic_opt=ClippedAdam(critic.parameters(), cfg.c_lr, None,
                                   ADAM_EPS),
            replay=ReplayBuffer(cfg.replay_size, obs_dim, act_dim,
                                self.device),
            runner=runner, generator=gen, seed=seed, update_count=0,
            param_noise_sigma=torch.tensor(0.05, device=self.device))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _perturbed_actor(self, state: TD3TrainState) -> FFActor:
        """Parameter-space exploration (reference param_noise.py:50-58):
        every weight of the acting snapshot plus N(0, sigma^2)."""
        net = frozen_copy(state.behavior)
        for p in net.parameters():
            p.add_(state.param_noise_sigma * torch.randn(
                p.shape, generator=state.generator, device=p.device))
        return net

    def _update(self, state: TD3TrainState, batch: Sequence[torch.Tensor],
                noise: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One TD3 update (async_td3.py:406-487) on a replay batch (obs,
        action, reward, next_obs, not_done) with the target policy's
        N(0, 1) noise draws (batch, act_dim); the nets, targets and
        optimisers change in place. Returns (critic loss, actor loss; 0
        where the policy step is skipped)."""
        cfg = self.config
        obs, action, reward, next_obs, not_done = batch
        norm = state.norm
        with torch.no_grad():
            noise = torch.clamp(noise * cfg.policy_noise, -cfg.noise_clip,
                                cfg.noise_clip)
            next_action = torch.clamp(
                state.actor_target.act(norm, next_obs) + noise,
                -cfg.max_action, cfg.max_action)
            q1_t, q2_t = state.critic_target.q(norm, next_obs, next_action)
            target_q = reward[:, None] + not_done[:, None] * cfg.discount \
                * torch.minimum(q1_t, q2_t)

        q1, q2 = state.critic.q(norm, obs, action)
        c_loss = ((q1 - target_q) ** 2).mean() + ((q2 - target_q) ** 2).mean()
        state.critic_opt.step(torch.autograd.grad(c_loss,
                                                  state.critic_opt.params))

        if state.update_count % cfg.policy_freq == 0:
            # the updated critic; gradients for the actor's parameters only
            a_loss = -state.critic.q1(norm, obs,
                                      state.actor.act(norm, obs)).mean()
            state.actor_opt.step(torch.autograd.grad(
                a_loss, state.actor_opt.params))
            soft_update(state.actor_target, state.actor, cfg.tau)
            soft_update(state.critic_target, state.critic, cfg.tau)
        else:
            a_loss = torch.zeros((), device=obs.device)
        state.update_count += 1
        return c_loss.detach(), a_loss.detach()

    def _train_iteration(self, state: TD3TrainState, random_actions: bool):
        """Collect, adapt the parameter-noise sigma, then
        `updates_per_iter` updates on uniform replay batches."""
        cfg = self.config
        act_net = (self._perturbed_actor(state) if cfg.param_noise
                   else state.behavior)
        state, traj = collect(self.env, state, act_net,
                              self.noise_scales[:, None], cfg,
                              random_actions)

        if cfg.param_noise:                    # param_noise.py:10-48
            with torch.no_grad():
                obs = traj.obs.reshape(-1, traj.obs.shape[-1])
                plain = state.behavior.act(state.norm, obs)
                dist = torch.sqrt(torch.mean(
                    (traj.action.reshape(plain.shape) - plain) ** 2))
                sigma = state.param_noise_sigma
                state.param_noise_sigma = torch.where(
                    dist < cfg.expl_noise, sigma * 1.01, sigma / 1.01)

        losses = []
        for _ in range(cfg.updates_per_iter):
            batch = state.replay.sample(state.generator, cfg.batch_size)
            noise = torch.randn(batch[1].shape, generator=state.generator,
                                device=self.device)
            losses.append(torch.stack(self._update(state, batch, noise)))
        losses = torch.stack(losses)

        stats = episode_stats(traj)
        return state, {
            "critic_loss": losses[:, 0].mean(),
            "actor_loss": losses[:, 1].mean(),
            "train_ep_return": stats["ep_return"],
            "train_ep_len": stats["ep_len"],
            "reward_per_step": stats["reward_per_step"],
            "replay_size": state.replay.size,
        }

    def _evaluate(self, state: TD3TrainState, generator: torch.Generator):
        """Deterministic eval (sync_td3.py:23-44)."""
        return evaluate_policy(
            self.env, lambda obs: state.actor.act(state.norm, obs),
            generator, self.config.num_envs, self.config.max_traj_len)

    # ------------------------------------------------------------------
    def train(self, state: TD3TrainState, max_timesteps: int,
              eval_freq_iters: int = 10, logger=None, save_fn=None,
              verbose: bool = True) -> TD3TrainState:
        """Iterations with the random warm-up, the acting snapshot's
        refresh, and an evaluation every `eval_freq_iters` iterations,
        saving on a new best (td3.py:301-347)."""
        cfg = self.config
        steps_per_iter = cfg.collect_steps * cfg.num_envs
        n_iters = max(1, int(max_timesteps) // steps_per_iter)
        warmup_iters = max(1, cfg.start_timesteps // steps_per_iter)
        highest = -np.inf
        total_steps = 0

        for it in range(n_iters):
            # async staleness: refresh the acting snapshot every load_freq
            # iterations (async_td3.py:206-213); sync mode refreshes always
            if not cfg.async_mode or it % cfg.load_freq == 0:
                copy_params(state.behavior, state.actor)
            t0 = time.time()
            state, metrics = self._train_iteration(
                state, random_actions=it < warmup_iters)
            metrics = {k: float(v) for k, v in metrics.items()}
            total_steps += steps_per_iter
            dt = time.time() - t0

            if it % eval_freq_iters == 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(it)
                eval_ret = float(self._evaluate(state, gen)["ep_return"])
                if verbose:
                    print(f"it {it:5d} | steps {total_steps:9d} | "
                          f"eval {eval_ret:8.2f} | "
                          f"closs {metrics['critic_loss']:8.4f} | {dt:.2f}s",
                          flush=True)
                if logger is not None:
                    logger.add_scalar("Test/Return", eval_ret, total_steps)
                    logger.add_scalar("Train/Return",
                                      metrics["train_ep_return"], total_steps)
                    logger.add_scalar("Misc/Critic Loss",
                                      metrics["critic_loss"], total_steps)
                    logger.add_scalar("Misc/Actor Loss",
                                      metrics["actor_loss"], total_steps)
                    logger.add_scalar("Misc/Timesteps", total_steps, it)
                if eval_ret > highest:
                    highest = eval_ret
                    if save_fn is not None:
                        save_fn(state)
        return state


def make_env(args, device):
    """The env of an off-policy run, with the settings the JAX package's
    learners pass (td3.py:318-323)."""
    from apex_tpu_torch.envs.registry import env_factory

    return env_factory(
        args.env_name, device=device, simrate=args.simrate,
        command_profile=args.command_profile,
        input_profile=args.input_profile, learn_gains=args.learn_gains,
        dynamics_randomization=args.dyn_random, reward=args.reward,
        history=args.history)


def run_experiment(args, async_mode: bool = False, device=None):
    """CLI entry (reference sync_td3.py:235-349 / async_td3.py:27-97):
    `device` is where the run goes (None: the GPU); `args` holds apex.py's
    td3 flags only."""
    from apex_tpu_torch.runtime.checkpoint import save_checkpoint
    from apex_tpu_torch.runtime.log import create_logger

    env = make_env(args, device)
    cfg = TD3Config(
        num_envs=args.num_procs, start_timesteps=args.start_timesteps,
        expl_noise=args.expl_noise, batch_size=args.batch_size,
        discount=args.discount, tau=args.tau,
        policy_noise=args.policy_noise, noise_clip=args.noise_clip,
        policy_freq=args.policy_freq, a_lr=args.a_lr, c_lr=args.c_lr,
        max_traj_len=args.max_traj_len, async_mode=async_mode,
        param_noise=args.param_noise)
    td3 = TD3(env, cfg)
    state = td3.init(seed=args.seed)
    logger = create_logger(args)
    print(f"{'Asynchronous' if async_mode else 'Synchronous'} Twin-Delayed "
          f"DDPG on {env.device} (run dir {logger.dir})", flush=True)
    state = td3.train(state, max_timesteps=int(args.max_timesteps),
                      logger=logger,
                      save_fn=lambda st: save_checkpoint(logger.dir, st, env))
    logger.close()
    return state
