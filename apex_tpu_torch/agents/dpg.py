"""Deep deterministic policy gradient (DDPG) and recurrent DPG (RDPG) on
one device.

Port of `apex_tpu/agents/dpg.py` (reference rl/algos/dpg.py). DDPG: the
env fleet collects into the replay ring on the device, then each update
takes the critic step, the actor step on the updated critic and the soft
target updates. RDPG: a fresh fleet collects one episode per env
(`max_traj_len` steps, masked after the first termination) into a ring
of whole episodes (`EpisodeBuffer`), and each update samples
`traj_batch` episodes and takes the same three steps with BPTT through
the LSTM actor (tanh head) and LSTM Q, the losses averaged over the
masked steps. Both optimisers are plain `optax.adam`. One update
(`_update`, `_update_rnn`) takes its batch as an argument, so that the
tests can feed it the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from apex_tpu_torch.agents.ppo import ClippedAdam
from apex_tpu_torch.agents.replay import ReplayBuffer
from apex_tpu_torch.agents.rollout import (
    RunnerState,
    episode_stats,
    evaluate_policy,
    first_episode_mask,
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
from apex_tpu_torch.models.nets import (
    FFQ,
    LSTMQ,
    FFActor,
    LSTMActor,
    NormState,
)


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
    episode_capacity: int = 2048      # RDPG episode ring
    traj_batch: int = 16              # RDPG episodes per update


class EpisodeBuffer:
    """RDPG's ring of whole episodes (`EpisodeBuffer`, dpg.py:64-102):
    fields (capacity, T, ...), updated in place; `ptr` and `size` are
    host ints."""

    FIELDS = ("obs", "action", "reward", "next_obs", "mask", "not_done")

    def __init__(self, capacity: int, T: int, obs_dim: int, act_dim: int,
                 device: torch.device):
        z = lambda *shape: torch.zeros(shape, device=device)
        self.obs = z(capacity, T, obs_dim)
        self.action = z(capacity, T, act_dim)
        self.reward = z(capacity, T)
        self.next_obs = z(capacity, T, obs_dim)
        self.mask = z(capacity, T)          # 1 while the episode is alive
        self.not_done = z(capacity, T)      # 0 at a true termination
        self.ptr = 0
        self.size = 0

    def add_episodes(self, *episodes: torch.Tensor) -> None:
        """Insert n episodes (n, T, ...) per field, wrapping modulo the
        capacity."""
        n = episodes[0].shape[0]
        cap = self.obs.shape[0]
        idx = (self.ptr + torch.arange(n, device=self.obs.device)) % cap
        for name, rows in zip(self.FIELDS, episodes):
            getattr(self, name).index_copy_(0, idx, rows)
        self.ptr = (self.ptr + n) % cap
        self.size = min(self.size + n, cap)

    def gather(self, idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, name)[idx] for name in self.FIELDS)

    def sample(self, generator: torch.Generator, batch: int):
        """Uniform episodes over the filled rows."""
        idx = torch.randint(0, max(self.size, 1), (batch,),
                            generator=generator, device=self.obs.device)
        return self.gather(idx)


@dataclasses.dataclass
class DPGTrainState:
    actor: Union[FFActor, LSTMActor]
    actor_target: Union[FFActor, LSTMActor]
    critic: Union[FFQ, LSTMQ]
    critic_target: Union[FFQ, LSTMQ]
    norm: NormState
    actor_opt: ClippedAdam
    critic_opt: ClippedAdam
    replay: Union[ReplayBuffer, EpisodeBuffer]
    runner: RunnerState
    generator: torch.Generator
    seed: int


class DPG:
    """Wires an Env and a DPGConfig into the train and eval steps."""

    def __init__(self, env: Env, config: DPGConfig):
        self.env = env
        self.config = config
        self.device = env.device

    def init(self, seed: int) -> DPGTrainState:
        """The nets (DDPG: FFActor and FFQ; RDPG: the tanh LSTMActor and
        LSTMQ, layers (128, 128), dpg.py:138-146), their targets, the
        optimisers, the replay ring (RDPG: the episode ring) and a
        fleet."""
        cfg = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        if cfg.recurrent:
            actor = LSTMActor.init(gen, obs_dim, act_dim,
                                   max_action=cfg.max_action)
            critic = LSTMQ.init(gen, obs_dim, act_dim)
            replay = EpisodeBuffer(cfg.episode_capacity, cfg.max_traj_len,
                                   obs_dim, act_dim, self.device)
        else:
            actor = FFActor.init(gen, obs_dim, act_dim,
                                 max_action=cfg.max_action)
            critic = FFQ.init(gen, obs_dim, act_dim)
            replay = ReplayBuffer(cfg.replay_size, obs_dim, act_dim,
                                  self.device)
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
            replay=replay, runner=runner, generator=gen, seed=seed)

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
        if self.config.recurrent:
            return self._train_iteration_rnn(state, random_actions)
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

    # ------------------------------------------------------------------
    # recurrent DPG
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _collect_episodes(self, state: DPGTrainState, random_actions: bool):
        """A fresh fleet, one episode per env for max_traj_len steps
        without resets, acting with U[-max_action, max_action) actions in
        the warm-up, else with the LSTM actor's action plus N(0,
        expl_noise^2), clipped (dpg.py:243-289). Returns the episodes (B,
        T, ...): obs, action, reward, next_obs, mask (1 up to and
        including the first termination) and not_done."""
        cfg = self.config
        env, gen = self.env, state.generator
        B, m = cfg.num_envs, cfg.max_action
        runner = init_runner(env, gen, B)
        env_state, obs = runner.env_state, runner.obs
        carry = state.actor.zero_carry((B,))
        out = []
        for _ in range(cfg.max_traj_len):
            if random_actions:
                action = -m + 2.0 * m * torch.rand(
                    (B, env.action_size), generator=gen, device=self.device)
            else:
                carry, mean = state.actor.step_act(state.norm, carry, obs)
                action = torch.clamp(mean + cfg.expl_noise * torch.randn(
                    mean.shape, generator=gen, device=self.device), -m, m)
            env_state, next_obs, reward, terminated = env.step(
                env_state, action, env.sample_step_noise(gen, B))
            out.append((obs, action, reward, next_obs, terminated))
            obs = next_obs
        obs, action, reward, next_obs, term = (
            torch.stack(x, dim=1) for x in zip(*out))
        return (obs, action, reward, next_obs,
                first_episode_mask(term, dim=1), 1.0 - term.float())

    def _update_rnn(self, state: DPGTrainState,
                    batch: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One RDPG update (dpg.py:296-337) on sampled episodes (obs,
        action, reward, next_obs, mask, not_done), each (n, T, ...): BPTT
        through the sequences, the critic step, the actor step on the
        updated critic, the soft target updates; the losses averaged over
        the masked steps. Returns (critic loss, actor loss)."""
        cfg = self.config
        norm = state.norm
        obs, act, rew, next_obs, mask, nd = (x.transpose(0, 1)
                                             for x in batch)
        with torch.no_grad():
            next_a = state.actor_target.seq_act(norm, next_obs)
            q_next = state.critic_target.seq_q(norm, next_obs,
                                               next_a)[..., 0]
            target = rew + nd * cfg.discount * q_next
        q = state.critic.seq_q(norm, obs, act)[..., 0]
        c_loss = (((q - target) ** 2) * mask).sum() / mask.sum()
        state.critic_opt.step(torch.autograd.grad(c_loss,
                                                  state.critic_opt.params))
        q = state.critic.seq_q(norm, obs, state.actor.seq_act(norm, obs))
        a_loss = -(q[..., 0] * mask).sum() / mask.sum()
        state.actor_opt.step(torch.autograd.grad(a_loss,
                                                 state.actor_opt.params))
        soft_update(state.actor_target, state.actor, cfg.tau)
        soft_update(state.critic_target, state.critic, cfg.tau)
        return c_loss.detach(), a_loss.detach()

    def _train_iteration_rnn(self, state: DPGTrainState,
                             random_actions: bool):
        """An episode per env into the ring, then the full
        `updates_per_iter` budget of BPTT updates (dpg.py:291-362)."""
        cfg = self.config
        eps = self._collect_episodes(state, random_actions)
        state.replay.add_episodes(*eps)
        losses = torch.stack([
            torch.stack(self._update_rnn(state, state.replay.sample(
                state.generator, cfg.traj_batch)))
            for _ in range(max(1, cfg.updates_per_iter))])
        return state, self._rnn_metrics(eps, losses)

    @staticmethod
    def _rnn_metrics(eps, losses: torch.Tensor) -> dict:
        _, _, reward, _, mask, _ = eps
        return {
            "critic_loss": losses[:, 0].mean(),
            "actor_loss": losses[:, 1].mean(),
            "train_ep_return": (reward * mask).sum(dim=1).mean(),
            "train_ep_len": mask.sum(dim=1).mean(),
            "reward_per_step": (reward * mask).sum() / mask.sum(),
        }

    @torch.no_grad()
    def _evaluate(self, state: DPGTrainState, generator: torch.Generator):
        cfg = self.config
        if not cfg.recurrent:
            return evaluate_policy(
                self.env, lambda obs: state.actor.act(state.norm, obs),
                generator, cfg.num_envs, cfg.max_traj_len)
        # a fresh fleet, max_traj_len steps without resets, each env's
        # first episode (dpg.py:364-392)
        env, B = self.env, cfg.num_envs
        runner = init_runner(env, generator, B)
        env_state, obs = runner.env_state, runner.obs
        carry = state.actor.zero_carry((B,))
        rewards, terms = [], []
        for _ in range(cfg.max_traj_len):
            carry, mean = state.actor.step_act(state.norm, carry, obs)
            env_state, obs, reward, terminated = env.step(
                env_state, mean, env.sample_step_noise(generator, B))
            rewards.append(reward)
            terms.append(terminated)
        rewards = torch.stack(rewards)
        mask = first_episode_mask(torch.stack(terms))
        return {"ep_return": (rewards * mask).sum(dim=0).mean(),
                "ep_len": mask.sum(dim=0).mean(),
                "reward_per_step": (rewards * mask).sum() / mask.sum(),
                "num_episodes": torch.tensor(B)}

    def train(self, state: DPGTrainState, max_timesteps: int,
              eval_freq_iters: int = 10, logger=None, save_fn=None,
              verbose: bool = True) -> DPGTrainState:
        """Iterations with the random warm-up and an evaluation every
        `eval_freq_iters` iterations, saving on a new best
        (dpg.py:417-441)."""
        cfg = self.config
        steps_per_iter = (cfg.max_traj_len if cfg.recurrent
                          else cfg.collect_steps) * cfg.num_envs
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
    (None: the GPU); `args` holds apex.py's ddpg or rdpg flags only."""
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
    print(("Recurrent " if recurrent else "") + "Deterministic Policy "
          f"Gradient on {env.device} (run dir {logger.dir})", flush=True)
    state = dpg.train(state, max_timesteps=int(args.max_timesteps),
                      logger=logger,
                      save_fn=lambda st: save_checkpoint(logger.dir, st, env))
    logger.close()
    return state
