"""Deep deterministic policy gradient (DDPG) on one device.

Port of the feed-forward path of `apex_tpu/agents/dpg.py` (reference
rl/algos/dpg.py): the env fleet collects into the replay ring on the
device, then each update takes the critic step, the actor step on the
updated critic and the soft target updates. One update (`_update`) takes
its batch as an argument, so that the tests can feed it the JAX package's
draws. The recurrent variant (RDPG: the episode ring and the LSTM nets)
is not ported yet and raises NotImplementedError.
"""
from __future__ import annotations

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
)
from apex_tpu_torch.agents.td3 import (
    ADAM_EPS,
    collect,
    frozen_copy,
    make_env,
    soft_update,
)
from apex_tpu_torch.envs.base import Env
from apex_tpu_torch.models.nets import FFQ, FFActor, NormState


@dataclasses.dataclass(frozen=True)
class DPGConfig:
    """Defaults mirror reference apex.py ddpg flags (dpg.py:39-57)."""
    num_envs: int = 64
    collect_steps: int = 80
    start_timesteps: int = 10000
    expl_noise: float = 0.2
    batch_size: int = 64
    discount: float = 0.99
    tau: float = 0.001
    a_lr: float = 1e-4
    c_lr: float = 1e-3
    replay_size: int = 1_000_000
    max_traj_len: int = 400
    max_action: float = 1.0
    updates_per_iter: int = 80
    recurrent: bool = False


@dataclasses.dataclass
class DPGTrainState:
    actor: FFActor
    actor_target: FFActor
    critic: FFQ
    critic_target: FFQ
    norm: NormState
    actor_opt: ClippedAdam
    critic_opt: ClippedAdam
    replay: ReplayBuffer
    runner: RunnerState
    generator: torch.Generator
    seed: int


class DPG:
    """Wires an Env and a DPGConfig into the train and eval steps."""

    def __init__(self, env: Env, config: DPGConfig):
        if config.recurrent:
            raise NotImplementedError(
                "recurrent DPG (RDPG: EpisodeBuffer and the LSTM nets) is "
                "not ported to apex_tpu_torch yet")
        self.env = env
        self.config = config
        self.device = env.device

    def init(self, seed: int) -> DPGTrainState:
        cfg = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        actor = FFActor.init(gen, obs_dim, act_dim, max_action=cfg.max_action)
        critic = FFQ.init(gen, obs_dim, act_dim)
        with torch.no_grad():
            runner = init_runner(self.env, gen, cfg.num_envs)
        return DPGTrainState(
            actor=actor, actor_target=frozen_copy(actor), critic=critic,
            critic_target=frozen_copy(critic),
            norm=NormState(obs_dim).to(self.device),
            actor_opt=ClippedAdam(actor.parameters(), cfg.a_lr, None,
                                  ADAM_EPS),
            critic_opt=ClippedAdam(critic.parameters(), cfg.c_lr, None,
                                   ADAM_EPS),
            replay=ReplayBuffer(cfg.replay_size, obs_dim, act_dim,
                                self.device),
            runner=runner, generator=gen, seed=seed)

    def _update(self, state: DPGTrainState, batch: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One DDPG update (dpg.py:159-192) on a replay batch (obs, action,
        reward, next_obs, not_done); the nets, targets and optimisers
        change in place. Returns (critic loss, actor loss)."""
        cfg = self.config
        obs, action, reward, next_obs, not_done = batch
        norm = state.norm
        with torch.no_grad():
            target_q = reward[:, None] + not_done[:, None] * cfg.discount \
                * state.critic_target.q(
                    norm, next_obs, state.actor_target.act(norm, next_obs))

        c_loss = ((state.critic.q(norm, obs, action) - target_q) ** 2).mean()
        state.critic_opt.step(torch.autograd.grad(c_loss,
                                                  state.critic_opt.params))
        # the updated critic; gradients for the actor's parameters only
        a_loss = -state.critic.q(norm, obs, state.actor.act(norm, obs)).mean()
        state.actor_opt.step(torch.autograd.grad(a_loss,
                                                 state.actor_opt.params))
        soft_update(state.actor_target, state.actor, cfg.tau)
        soft_update(state.critic_target, state.critic, cfg.tau)
        return c_loss.detach(), a_loss.detach()

    def _train_iteration(self, state: DPGTrainState, random_actions: bool):
        cfg = self.config
        state, traj = collect(self.env, state, state.actor, cfg.expl_noise,
                              cfg, random_actions)
        losses = torch.stack([
            torch.stack(self._update(state, state.replay.sample(
                state.generator, cfg.batch_size)))
            for _ in range(cfg.updates_per_iter)])
        stats = episode_stats(traj)
        return state, {
            "critic_loss": losses[:, 0].mean(),
            "actor_loss": losses[:, 1].mean(),
            "train_ep_return": stats["ep_return"],
            "train_ep_len": stats["ep_len"],
            "reward_per_step": stats["reward_per_step"],
        }

    def _evaluate(self, state: DPGTrainState, generator: torch.Generator):
        return evaluate_policy(
            self.env, lambda obs: state.actor.act(state.norm, obs),
            generator, self.config.num_envs, self.config.max_traj_len)

    def train(self, state: DPGTrainState, max_timesteps: int,
              eval_freq_iters: int = 10, logger=None, save_fn=None,
              verbose: bool = True) -> DPGTrainState:
        """Iterations with the random warm-up and an evaluation every
        `eval_freq_iters` iterations, saving on a new best
        (dpg.py:417-441)."""
        cfg = self.config
        steps_per_iter = cfg.collect_steps * cfg.num_envs
        n_iters = max(1, int(max_timesteps) // steps_per_iter)
        warmup = max(1, cfg.start_timesteps // steps_per_iter)
        highest = -np.inf
        total = 0
        for it in range(n_iters):
            t0 = time.time()
            state, metrics = self._train_iteration(
                state, random_actions=it < warmup)
            metrics = {k: float(v) for k, v in metrics.items()}
            total += steps_per_iter
            if it % eval_freq_iters == 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(it)
                ret = float(self._evaluate(state, gen)["ep_return"])
                if verbose:
                    print(f"it {it:5d} | steps {total:9d} | eval {ret:8.2f} "
                          f"| {time.time() - t0:.2f}s", flush=True)
                if logger is not None:
                    logger.add_scalar("Test/Return", ret, total)
                    logger.add_scalar("Misc/Critic Loss",
                                      metrics["critic_loss"], total)
                if ret > highest:
                    highest = ret
                    if save_fn is not None:
                        save_fn(state)
        return state


def run_experiment(args, recurrent: bool = False, device=None):
    """CLI entry (reference dpg.py:197-341): `device` is where the run goes
    (None: the GPU); `args` holds apex.py's ddpg flags only."""
    from apex_tpu_torch.runtime.checkpoint import save_checkpoint
    from apex_tpu_torch.runtime.log import create_logger

    cfg = DPGConfig(
        num_envs=args.num_procs, expl_noise=args.expl_noise,
        batch_size=args.batch_size, discount=args.discount, tau=args.tau,
        a_lr=args.a_lr, c_lr=args.c_lr, max_traj_len=args.max_traj_len,
        recurrent=recurrent)
    env = make_env(args, device)
    dpg = DPG(env, cfg)
    state = dpg.init(seed=args.seed)
    logger = create_logger(args)
    print(f"Deterministic Policy Gradient on {env.device} (run dir "
          f"{logger.dir})", flush=True)
    state = dpg.train(state, max_timesteps=int(args.max_timesteps),
                      logger=logger,
                      save_fn=lambda st: save_checkpoint(logger.dir, st, env))
    logger.close()
    return state
