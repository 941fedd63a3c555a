"""Recurrent PPO: LSTM actor and critic with BPTT over rollout chunks.

Port of `apex_tpu/agents/ppo_recurrent.py` (reference rl/algos/ppo.py:
411-430, `--recurrent`). Every env of the fleet contributes one
`rollout_len`-step chunk per iteration. The actor's hidden state is carried
in the runner between chunks and zeroed after a done; inside a chunk, BPTT
zeroes the carry before the step of every episode start, so that it sees
the episodes as the rollout did. Minibatches are sets of env chunks. The
JAX package's quirks are kept: the critic's carry in the runner never
advances (each chunk's critic scan starts from the runner's initial
carry), `next_values` scans `next_obs` with the same episode starts, the
first step of a chunk is an episode start only where `traj_len == 0`, and
the KL stop's skipped minibatches count as zeros in the metrics. The
optimisers are `optax.chain(clip_by_global_norm, adam)` by its formulas
(`ClippedAdam`); randomness comes from one `torch.Generator`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.agents.ppo import (
    ClippedAdam,
    PPOConfig,
    mirror_tables,
)
from apex_tpu_torch.agents.rollout import (
    first_episode_mask,
    init_runner,
    tree_where,
)
from apex_tpu_torch.envs.base import Env, mirror_clock
from apex_tpu_torch.models.distributions import DiagGaussian
from apex_tpu_torch.models.nets import (
    Carry,
    GaussianLSTMActor,
    LSTMV,
    NormState,
    carry_where,
    lstm_seq,
    lstm_zero_carry,
)
from apex_tpu_torch.ops.gae import discounted_returns, gae_advantages

METRICS = ("actor_loss", "entropy", "critic_loss", "kl", "mirror_loss")


@dataclasses.dataclass
class RecurrentRunner:
    env_state: Any
    obs: torch.Tensor           # (B, obs_dim)
    traj_len: torch.Tensor      # (B,) int32
    ep_return: torch.Tensor     # (B,)
    actor_carry: Carry
    critic_carry: Carry


class RecurrentRollout(NamedTuple):
    obs: torch.Tensor           # (T, B, obs_dim)
    action: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    next_obs: torch.Tensor
    episode_start: torch.Tensor     # (T, B) 1.0 where a step begins an episode
    done_ep_return: torch.Tensor
    done_ep_len: torch.Tensor


@dataclasses.dataclass
class RecurrentPPOState:
    actor: GaussianLSTMActor
    critic: LSTMV
    norm: NormState
    actor_opt: ClippedAdam
    critic_opt: ClippedAdam
    runner: RecurrentRunner
    generator: torch.Generator
    seed: int
    # the two rng leaves of a JAX checkpoint this state was loaded from
    # (runner, state), written back as read; None: PRNGKey(seed)'s
    jax_keys: Optional[Sequence[np.ndarray]] = None


class RecurrentPPO:
    """Wires an Env and a PPOConfig into the recurrent train and eval
    steps (`RecurrentPPO`, ppo_recurrent.py:80-445)."""

    def __init__(self, env: Env, config: PPOConfig,
                 layers: Sequence[int] = (128, 128)):
        self.env = env
        self.config = config
        self.layers = tuple(layers)
        self.device = env.device
        self.obs_mirror, self.act_mirror = mirror_tables(env, config)

    # ------------------------------------------------------------------
    def init(self, seed: int) -> RecurrentPPOState:
        """The nets (a fixed std of exp(-2), whatever `std_dev` says:
        reference ppo.py:537), a fresh normaliser, the optimisers and a
        fresh fleet (ppo_recurrent.py:104-119)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        actor = GaussianLSTMActor.init(gen, obs_dim, act_dim, self.layers,
                                       fixed_std=float(np.exp(-2)))
        critic = LSTMV.init(gen, obs_dim, self.layers)
        return RecurrentPPOState(
            actor=actor, critic=critic,
            norm=NormState(obs_dim).to(self.device),
            actor_opt=self._optimizer(actor),
            critic_opt=self._optimizer(critic),
            runner=self._init_runner(gen), generator=gen, seed=seed)

    def _optimizer(self, net: torch.nn.Module) -> ClippedAdam:
        cfg = self.config
        return ClippedAdam(net.parameters(), cfg.lr, cfg.max_grad_norm,
                           cfg.eps)

    @torch.no_grad()
    def _init_runner(self, generator: torch.Generator) -> RecurrentRunner:
        B = self.config.num_envs
        r = init_runner(self.env, generator, B)
        return RecurrentRunner(
            env_state=r.env_state, obs=r.obs, traj_len=r.traj_len,
            ep_return=r.ep_return,
            actor_carry=lstm_zero_carry(self.layers, (B,), self.device),
            critic_carry=lstm_zero_carry(self.layers, (B,), self.device))

    @torch.no_grad()
    def prenormalize(self, state: RecurrentPPOState, steps: int = 10000,
                     noise_std: float = 1.0) -> RecurrentPPOState:
        """Obs-normaliser burn-in (ppo_recurrent.py:139-168): steps //
        num_envs steps of the untrained policy's mean plus N(0,
        noise_std^2), carrying the actor's hidden state, without resets;
        their observations set the normaliser; training starts from a
        fresh fleet."""
        T = max(1, steps // self.config.num_envs)
        gen, env, r = state.generator, self.env, state.runner
        B = r.obs.shape[0]
        env_state, obs, carry = r.env_state, r.obs, r.actor_carry
        seen = []
        for _ in range(T):
            carry, (mean, _) = state.actor.step_dist(state.norm, carry, obs)
            action = mean + noise_std * torch.randn(
                mean.shape, generator=gen, device=mean.device)
            seen.append(obs)
            env_state, obs, _, _ = env.step(
                env_state, action, env.sample_step_noise(gen, B))
        norm = NormState(env.observation_size).to(self.device)
        norm.update(torch.stack(seen))
        return dataclasses.replace(state, norm=norm,
                                   runner=self._init_runner(gen))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _rollout(self, state: RecurrentPPOState, runner: RecurrentRunner,
                 anneal: float, deterministic: bool = False):
        """`rollout_len` steps of the fleet with auto-reset
        (ppo_recurrent.py:171-220): (runner, RecurrentRollout)."""
        cfg = self.config
        env, gen = self.env, state.generator
        B = runner.obs.shape[0]
        zero = lstm_zero_carry(self.layers, (B,), self.device)
        r = runner
        ep_start = (r.traj_len == 0).float()
        out = []
        for _ in range(cfg.rollout_len):
            a_carry, (mean, std) = state.actor.step_dist(
                state.norm, r.actor_carry, r.obs)
            action = mean if deterministic else DiagGaussian.sample(
                gen, mean, std * anneal)
            env_state, next_obs, reward, terminated = env.step(
                r.env_state, action, env.sample_step_noise(gen, B))
            traj_len = r.traj_len + 1
            truncated = (traj_len >= cfg.max_traj_len) & ~terminated
            done = terminated | truncated
            ep_return = r.ep_return + reward
            reset_state, reset_obs = env.reset(
                env.sample_reset_noise(gen, B))
            out.append(RecurrentRollout(
                obs=r.obs, action=action, reward=reward,
                terminated=terminated, truncated=truncated,
                next_obs=next_obs, episode_start=ep_start,
                done_ep_return=torch.where(done, ep_return, 0.0),
                done_ep_len=torch.where(done, traj_len, 0)))
            r = RecurrentRunner(
                env_state=tree_where(done, reset_state, env_state),
                obs=torch.where(done[:, None], reset_obs, next_obs),
                traj_len=torch.where(done, 0, traj_len),
                ep_return=torch.where(done, 0.0, ep_return),
                actor_carry=carry_where(done, zero, a_carry),
                # the critic scans at update time; its carry stays
                critic_carry=r.critic_carry)
            ep_start = done.float()
        return r, RecurrentRollout(*(torch.stack(x) for x in zip(*out)))

    # ------------------------------------------------------------------
    def _actor_seq_dist(self, actor: GaussianLSTMActor, norm: NormState,
                        obs_seq, ep_start, init_carry: Carry, anneal):
        """(mean, std) over a chunk (T, B, obs), the carry zeroed before
        each episode start (ppo_recurrent.py:238-244)."""
        tops = lstm_seq(actor.cells, init_carry, norm(obs_seq), ep_start)
        mean = actor.out(tops)
        return mean, torch.full_like(mean, actor.fixed_std) * anneal

    def _critic_seq(self, critic: LSTMV, norm: NormState, obs_seq, ep_start,
                    init_carry: Carry) -> torch.Tensor:
        tops = lstm_seq(critic.cells, init_carry, norm(obs_seq), ep_start)
        return critic.out(tops)[..., 0]

    # ------------------------------------------------------------------
    def _train_iteration(self, state: RecurrentPPOState, anneal: float):
        """One rollout chunk and the update (ppo_recurrent.py:253-384).
        Returns (state, metrics); the nets and optimisers change in
        place."""
        cfg = self.config
        runner0 = state.runner
        runner, traj = self._rollout(state, runner0, anneal)
        B = traj.reward.shape[1]
        perms = [torch.randperm(B, generator=state.generator,
                                device=self.device)
                 for _ in range(cfg.epochs)]
        metrics = self._update(state, traj, runner0.actor_carry,
                               runner0.critic_carry, anneal, perms)
        return dataclasses.replace(state, runner=runner), metrics

    def _update(self, state: RecurrentPPOState, traj: RecurrentRollout,
                actor_carry: Carry, critic_carry: Carry, anneal: float,
                perms: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The update half of `_train_iteration`: values and bootstrap
        values by critic scans, returns and advantages, the old policy's
        statistics, then `epochs` passes over minibatches of env chunks
        cut by `perms` (one permutation of the B envs per epoch), with the
        epoch-mean KL stop. `actor_carry` and `critic_carry` are the
        runner's carries at the chunk's start."""
        cfg = self.config
        T, B = traj.reward.shape
        norm = state.norm
        with torch.no_grad():
            values = self._critic_seq(state.critic, norm, traj.obs,
                                      traj.episode_start, critic_carry)
            # the same segmentation over next_obs (ppo_recurrent.py:266-271)
            next_values = self._critic_seq(state.critic, norm, traj.next_obs,
                                           traj.episode_start, critic_carry)
            if cfg.use_gae:
                advantages, returns = gae_advantages(
                    traj.reward, values, next_values, traj.terminated,
                    traj.truncated, cfg.gamma, cfg.lam)
            else:
                returns = discounted_returns(
                    traj.reward, traj.terminated, traj.truncated,
                    next_values, cfg.gamma)
                advantages = returns - values
            advantages = (advantages - advantages.mean()) / (
                advantages.std(unbiased=False) + cfg.eps)
            old_mean, old_std = self._actor_seq_dist(
                state.actor, norm, traj.obs, traj.episode_start, actor_carry,
                anneal)
            old_log_prob = DiagGaussian.log_prob(old_mean, old_std,
                                                 traj.action).sum(-1)

        mb_envs = max(1, min(cfg.minibatch_size, B))
        n_mb = B // mb_envs
        data = (traj.obs, traj.action, returns, advantages, old_log_prob,
                old_mean, old_std, traj.episode_start)
        stop = False
        epoch_metrics = []
        for epoch in range(cfg.epochs):
            if stop:
                # lax.cond's skip branch: zero metrics
                epoch_metrics.append(torch.zeros(len(METRICS),
                                                 device=self.device))
                continue
            batches = perms[epoch][: n_mb * mb_envs].reshape(n_mb, mb_envs)
            metrics = torch.stack([
                self._minibatch_update(
                    state, [x[:, idx] for x in data],
                    [(h[idx], c[idx]) for h, c in actor_carry],
                    [(h[idx], c[idx]) for h, c in critic_carry], anneal)
                for idx in batches])
            stop = bool(metrics[:, 3].mean() > cfg.kl_max)
            epoch_metrics.append(metrics.mean(dim=0))
        em = torch.stack(epoch_metrics)

        n_done = torch.clamp(torch.sum(traj.done_ep_len > 0), min=1)
        out = {"train_ep_return": torch.sum(traj.done_ep_return) / n_done,
               "train_ep_len": torch.sum(traj.done_ep_len) / n_done,
               "reward_per_step": traj.reward.mean()}
        for i, name in enumerate(METRICS):
            out[name] = em[:, i].mean()
        return out

    def _minibatch_update(self, state: RecurrentPPOState, batch,
                          a_carry0: Carry, c_carry0: Carry, anneal: float
                          ) -> torch.Tensor:
        """One optimiser step of actor and critic on a set of env chunks
        (ppo_recurrent.py:296-357); returns [actor_loss, entropy,
        critic_loss, kl, mirror_loss]."""
        cfg = self.config
        obs, act, ret, adv, old_lp, old_mean, old_std, start = batch
        actor, critic, norm = state.actor, state.critic, state.norm
        mean, std = self._actor_seq_dist(actor, norm, obs, start, a_carry0,
                                         anneal)
        lp = DiagGaussian.log_prob(mean, std, act).sum(-1)
        ratio = torch.exp(lp - old_lp)
        clipped = torch.clamp(ratio, 1.0 - cfg.clip, 1.0 + cfg.clip) * adv
        actor_loss = -torch.minimum(ratio * adv, clipped).mean()
        entropy = DiagGaussian.entropy(std).mean()
        if self.obs_mirror is not None:
            mir_obs = obs @ self.obs_mirror
            if self.env.clock_inds:
                mir_obs = mirror_clock(mir_obs, self.env.clock_inds)
            mir_mean, _ = self._actor_seq_dist(actor, norm, mir_obs, start,
                                               a_carry0, anneal)
            mirror_loss = cfg.mirror_coeff * (
                (mean - mir_mean @ self.act_mirror) ** 2).mean()
        else:
            mirror_loss = torch.zeros((), device=obs.device)
        total = actor_loss - cfg.entropy_coeff * entropy + mirror_loss
        a_grads = torch.autograd.grad(total, state.actor_opt.params)
        v = self._critic_seq(critic, norm, obs, start, c_carry0)
        critic_loss = 0.5 * ((ret - v) ** 2).mean()
        c_grads = torch.autograd.grad(critic_loss, state.critic_opt.params)
        with torch.no_grad():
            kl = DiagGaussian.kl(mean, std, old_mean, old_std).mean()
        state.actor_opt.step(a_grads)
        state.critic_opt.step(c_grads)
        return torch.stack([actor_loss, entropy, critic_loss, kl,
                            mirror_loss]).detach()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _evaluate(self, state: RecurrentPPOState,
                  generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Deterministic evaluation (ppo_recurrent.py:387-413): a fresh
        fleet for max_traj_len steps without resets; the return and
        length of each env's first episode, averaged."""
        cfg = self.config
        env = self.env
        r = self._init_runner(generator)
        B = r.obs.shape[0]
        env_state, obs, carry = r.env_state, r.obs, r.actor_carry
        rewards, terms = [], []
        for _ in range(cfg.max_traj_len):
            carry, (mean, _) = state.actor.step_dist(state.norm, carry, obs)
            env_state, obs, reward, terminated = env.step(
                env_state, mean, env.sample_step_noise(generator, B))
            rewards.append(reward)
            terms.append(terminated)
        rewards = torch.stack(rewards)
        mask = first_episode_mask(torch.stack(terms))
        return {"ep_return": (rewards * mask).sum(dim=0).mean(),
                "ep_len": mask.sum(dim=0).mean()}

    # ------------------------------------------------------------------
    def train(self, state: RecurrentPPOState, n_itr: int, logger=None,
              save_fn: Optional[Callable[[RecurrentPPOState], None]] = None,
              verbose: bool = True) -> RecurrentPPOState:
        """Iterations with the anneal curriculum, an evaluation each, and a
        save on a new best (ppo_recurrent.py:416-445)."""
        cfg = self.config
        highest = -np.inf
        curr_anneal = 1.0
        for itr in range(n_itr):
            t0 = time.time()
            if highest > (2 / 3) * cfg.max_traj_len and curr_anneal > 0.5:
                curr_anneal *= cfg.anneal_rate
            state, metrics = self._train_iteration(state, curr_anneal)
            metrics = {k: float(v) for k, v in metrics.items()}
            gen = torch.Generator(device=self.device)
            gen.manual_seed(itr)
            ret = float(self._evaluate(state, gen)["ep_return"])
            if verbose:
                print(f"itr {itr:4d} | test {ret:8.2f} | "
                      f"train {metrics['train_ep_return']:8.2f} | "
                      f"kl {metrics['kl']:.4f} | {time.time() - t0:.2f}s",
                      flush=True)
            if logger is not None:
                logger.add_scalar("Test/Return", ret, itr)
                logger.add_scalar("Train/Return",
                                  metrics["train_ep_return"], itr)
                logger.add_scalar("Train/Mean KL Div", metrics["kl"], itr)
            if ret > highest:
                highest = ret
                if save_fn is not None:
                    save_fn(state)
        return state
