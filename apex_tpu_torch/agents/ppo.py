"""Proximal Policy Optimization on the env fleet.

Port of `apex_tpu/agents/ppo.py`: a fleet rollout with auto-reset,
Monte-Carlo returns or GAE, normalised advantages, then epochs of shuffled
minibatches with the clipped surrogate, the critic's squared error, the
entropy bonus and the mirror-symmetry loss, stopping further epochs once
an epoch's mean KL passes `kl_max`. The optimiser is
`optax.chain(clip_by_global_norm(0.05), adam(lr, eps))` written out by
hand (`ClippedAdam`). Randomness comes from one `torch.Generator`.

With a `parallel.mesh.Mesh` the iteration is the JAX package's SPMD one
(`_train_iteration(axis=...)`, `train_iter_spmd`): each rank rolls out
its block of the fleet with a generator of its own, and the gradients,
the metrics and the advantage moments are means over the ranks, so the
replicated nets stay in lockstep; the epoch permutations come from the
shared generator, the same draws on every rank.

Hyperparameter defaults match reference apex.py:230-250.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from apex_tpu_torch.agents.rollout import (
    Rollout,
    RunnerState,
    episode_stats,
    evaluate_policy,
    init_runner,
    rollout_scan,
)
from apex_tpu_torch.envs.base import Env, mirror_clock, mirror_matrix
from apex_tpu_torch.models.distributions import DiagGaussian
from apex_tpu_torch.models.nets import FFV, GaussianFFActor, NormState
from apex_tpu_torch.ops.gae import discounted_returns, gae_advantages
from apex_tpu_torch.parallel.mesh import (
    Mesh,
    gather_ppo_state,
    shard_ppo_state,
)
from apex_tpu_torch.physics import fleet_kernel

METRICS = ("actor_loss", "entropy", "critic_loss", "ratio", "kl",
           "mirror_loss")


class ClippedAdam:
    """`optax.chain(clip_by_global_norm(max_norm), adam(lr, eps=eps))`
    (ppo.py:44-48) or, with max_grad_norm None, plain `optax.adam(lr,
    eps=eps)` (td3.py:96-97, dpg.py:125-126), by optax's formulas:

    - g_norm = sqrt(sum of g^2 over all leaves); g is kept when g_norm <
      max_norm, else becomes (g / g_norm) * max_norm (no 1e-6, unlike
      torch.nn.utils.clip_grad_norm_); no clip when max_norm is None;
    - mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count += 1;
    - p += -lr * (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps).

    `lr` may change between steps (`set_lr`), as the injected learning
    rate of the JAX optimiser state."""

    b1, b2 = 0.9, 0.999       # optax.adam's defaults

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 max_grad_norm: Optional[float], eps: float):
        self.params = list(params)
        self.lr, self.max_grad_norm, self.eps = lr, max_grad_norm, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.max_grad_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_grad_norm)
                     for g in grads]
        self.count += 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(self.count))
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1.0 - self.b1) * g + self.b1 * mu)
            nu.copy_((1.0 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(-self.lr * upd)


def set_lr(opt: ClippedAdam, lr: float) -> ClippedAdam:
    """Set the learning rate of an optimiser between steps (ppo.py:51)."""
    opt.lr = float(lr)
    return opt


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Static hyperparameters. Defaults = reference apex.py:230-250."""
    num_envs: int = 64
    num_steps: int = 5096          # timesteps per iteration (apex.py:245)
    max_traj_len: int = 400        # apex.py:249
    gamma: float = 0.99
    lam: float = 0.95
    lr: float = 1e-4
    eps: float = 1e-5
    clip: float = 0.2
    entropy_coeff: float = 0.0
    minibatch_size: int = 64
    epochs: int = 3
    max_grad_norm: float = 0.05
    kl_max: float = 0.02           # early stop (ppo.py:449)
    mirror_coeff: float = 0.4      # fixed in reference (ppo.py:318)
    use_gae: bool = False          # reference PPOBuffer uses MC returns
    use_mirror: bool = True
    anneal_rate: float = 1.0       # apex.py:237
    std_dev: float = -1.5          # exponent (apex.py:240)
    learn_stddev: bool = False
    bounded: bool = False

    @property
    def rollout_len(self) -> int:
        return max(1, self.num_steps // self.num_envs)


def mirror_tables(env: Env, config: PPOConfig):
    """(obs_mirror, act_mirror), the signed permutation matrices of the
    mirror loss on the env's device, or (None, None) without it."""
    if not (config.use_mirror and env.mirrored_obs is not None):
        return None, None
    f32 = lambda m: torch.tensor(m, device=env.device)
    obs_mirror = f32(mirror_matrix(env.mirrored_obs))
    if obs_mirror.shape[0] != env.observation_size:
        # the mirror table covers one frame of a history: JAX's loss
        # fails on the same shapes at its first update
        raise ValueError(
            f"the mirror loss needs the mirror table "
            f"({obs_mirror.shape[0]} entries) to cover the observation "
            f"({env.observation_size}); with history > 0 it covers one "
            "frame only")
    return obs_mirror, f32(mirror_matrix(env.mirrored_acts))


@dataclasses.dataclass
class PPOTrainState:
    actor: GaussianFFActor
    critic: FFV
    norm: NormState
    actor_opt: ClippedAdam
    critic_opt: ClippedAdam
    runner: RunnerState
    generator: torch.Generator     # shared: the same draws on every rank
    seed: int
    # a rank's own rollout draws (`shard_ppo_state`); None single-process
    rank_generator: Optional[torch.Generator] = None


class PPO:
    """Wires an Env and a PPOConfig into the train and eval steps."""

    def __init__(self, env: Env, config: PPOConfig):
        self.env = env
        self.config = config
        self.device = env.device
        self.obs_mirror, self.act_mirror = mirror_tables(env, config)

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def init(self, seed: int) -> PPOTrainState:
        cfg = self.config
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        actor = GaussianFFActor.init(
            gen, obs_dim, act_dim,
            fixed_std=None if cfg.learn_stddev else float(np.exp(cfg.std_dev)),
            bounded=cfg.bounded)
        critic = FFV.init(gen, obs_dim)
        norm = NormState(obs_dim).to(self.device)
        with torch.no_grad():
            runner = init_runner(self.env, gen, cfg.num_envs)
        return PPOTrainState(
            actor=actor, critic=critic, norm=norm,
            actor_opt=self._optimizer(actor),
            critic_opt=self._optimizer(critic), runner=runner,
            generator=gen, seed=seed)

    def _optimizer(self, net: torch.nn.Module) -> ClippedAdam:
        cfg = self.config
        return ClippedAdam(net.parameters(), cfg.lr, cfg.max_grad_norm,
                           cfg.eps)

    @torch.no_grad()
    def prenormalize(self, state: PPOTrainState, steps: int = 10000,
                     noise_std: float = 1.0) -> PPOTrainState:
        """Obs-normalizer burn-in (reference get_normalization_params,
        rl/envs/normalize.py:35-48): one rollout of steps // num_envs
        steps with N(0, noise_std^2) action noise on the untrained policy;
        its observations set the normalizer; training starts from a fresh
        fleet."""
        cfg = self.config
        T = max(1, steps // cfg.num_envs)
        gen = state.generator

        def noisy_policy(obs):
            a = state.actor.act(state.norm, obs, deterministic=True)
            return a + noise_std * torch.randn(
                a.shape, generator=gen, device=a.device)

        _, traj = rollout_scan(self.env, noisy_policy, state.runner, gen, T,
                               cfg.max_traj_len)
        norm = NormState(self.env.observation_size).to(self.device)
        norm.update(traj.obs)
        runner = init_runner(self.env, gen, cfg.num_envs)
        return dataclasses.replace(state, norm=norm, runner=runner)

    # ------------------------------------------------------------------
    # core losses
    # ------------------------------------------------------------------
    def _policy_losses(self, actor: GaussianFFActor, norm: NormState, obs,
                       action, advantage, old_log_prob, anneal):
        cfg = self.config
        mean, std = actor.dist(norm, obs, anneal)
        log_prob = DiagGaussian.log_prob(mean, std, action).sum(-1)
        ratio = torch.exp(log_prob - old_log_prob)
        cpi = ratio * advantage
        clipped = torch.clamp(ratio, 1.0 - cfg.clip, 1.0 + cfg.clip) \
            * advantage
        actor_loss = -torch.minimum(cpi, clipped).mean()
        entropy = DiagGaussian.entropy(std).mean()
        entropy_penalty = -cfg.entropy_coeff * entropy

        if self.obs_mirror is not None:
            # deterministic-action symmetry loss (ppo.py:301-320)
            det_action, _ = actor.dist(norm, obs, anneal)
            mir_obs = obs @ self.obs_mirror
            if self.env.clock_inds:
                mir_obs = mirror_clock(mir_obs, self.env.clock_inds)
            mir_action, _ = actor.dist(norm, mir_obs, anneal)
            mir_action = mir_action @ self.act_mirror
            mirror_loss = cfg.mirror_coeff * (
                (det_action - mir_action) ** 2).mean()
        else:
            mirror_loss = torch.zeros((), device=obs.device)

        total = actor_loss + mirror_loss + entropy_penalty
        aux = {"actor_loss": actor_loss, "mirror_loss": mirror_loss,
               "entropy": entropy, "ratio": ratio.mean(), "mean": mean,
               "std": std}
        return total, aux

    def _minibatch_update(self, state: PPOTrainState, batch, anneal,
                          mesh: Optional[Mesh] = None) -> torch.Tensor:
        """One optimiser step of actor and critic on one minibatch
        (reference update_policy, ppo.py:276-345); returns the (6,)
        metrics [actor_loss, entropy, critic_loss, ratio, kl,
        mirror_loss]. With `mesh` the gradients are averaged over the
        ranks before the clip and step, and the metrics after, so that
        the KL early stop decides the same on every rank (ppo.py:242-261).
        """
        obs, action, ret, adv, old_lp, old_mean, old_std = batch
        actor, critic = state.actor, state.critic
        total, aux = self._policy_losses(actor, state.norm, obs, action, adv,
                                         old_lp, anneal)
        a_grads = torch.autograd.grad(total, state.actor_opt.params)
        v = critic.value(state.norm, obs)[..., 0]
        critic_loss = 0.5 * ((ret - v) ** 2).mean()
        c_grads = torch.autograd.grad(critic_loss, state.critic_opt.params)
        if mesh is not None:
            grads = mesh.all_mean(a_grads + c_grads)
            a_grads, c_grads = grads[:len(a_grads)], grads[len(a_grads):]
        state.actor_opt.step(a_grads)
        state.critic_opt.step(c_grads)
        with torch.no_grad():
            kl = DiagGaussian.kl(aux["mean"], aux["std"], old_mean,
                                 old_std).mean()
            metrics = torch.stack([aux["actor_loss"], aux["entropy"],
                                   critic_loss, aux["ratio"], kl,
                                   aux["mirror_loss"]])
        return metrics if mesh is None else mesh.all_mean([metrics])[0]

    # ------------------------------------------------------------------
    # one training iteration: rollout, then update
    # ------------------------------------------------------------------
    def _train_iteration(self, state: PPOTrainState, anneal: float,
                         mesh: Optional[Mesh] = None):
        """One rollout + update iteration (ppo.py:275-407). Returns
        (state, metrics); the nets and optimisers update in place. With
        `mesh` (the state placed by `shard_ppo_state`) it is the SPMD
        iteration of `train_iter_spmd` (ppo.py:409-454) on this rank: the
        rank's block of the fleet, its own rollout draws, the shared
        permutations."""
        cfg = self.config
        state, traj = self._rollout(state, anneal, mesh)
        N = traj.reward.numel()
        perms = [torch.randperm(N, generator=state.generator,
                                device=self.device)
                 for _ in range(cfg.epochs)]
        return state, self._update(state, traj, anneal, perms, mesh)

    @torch.no_grad()
    def _rollout(self, state: PPOTrainState, anneal: float,
                 mesh: Optional[Mesh] = None):
        """The rollout of `_train_iteration`; with `mesh`, of the rank's
        block, from its own generator, each megakernel substep a K1-part
        launch on the block."""
        cfg = self.config
        gen = state.generator if mesh is None else state.rank_generator

        def policy_fn(obs):
            return state.actor.act(state.norm, obs, generator=gen,
                                   deterministic=False, anneal=anneal)

        def run():
            return rollout_scan(self.env, policy_fn, state.runner, gen,
                                cfg.rollout_len, cfg.max_traj_len)

        if mesh is None:
            runner, traj = run()
        else:
            with fleet_kernel.partitioned(mesh.world, cfg.num_envs):
                runner, traj = run()
        return dataclasses.replace(state, runner=runner), traj

    def _update(self, state: PPOTrainState, traj: Rollout, anneal: float,
                perms: Sequence[torch.Tensor], mesh: Optional[Mesh] = None
                ) -> Dict[str, torch.Tensor]:
        """The update half of `_train_iteration`: returns and advantages,
        old-policy statistics, then `epochs` passes over the minibatches
        that `perms` (one permutation of the T*B samples per epoch) cut,
        with the epoch-mean KL early stop. With `mesh`, `traj` is the
        rank's block: the advantage moments are global (the mean over
        ranks of the local means, then of the local means of (a - m)^2,
        ppo.py:327-330), the local minibatch is minibatch_size // world
        (the single-process count of optimiser steps, ppo.py:338-344), and
        the episode statistics are means over ranks of the ranks' means
        with the episodes summed (ppo.py:384-391)."""
        cfg = self.config
        T, B = traj.reward.shape
        norm = state.norm
        with torch.no_grad():
            values = state.critic.value(norm, traj.obs)[..., 0]       # (T, B)
            next_values = state.critic.value(norm, traj.next_obs)[..., 0]
            if cfg.use_gae:
                advantages, returns = gae_advantages(
                    traj.reward, values, next_values, traj.terminated,
                    traj.truncated, cfg.gamma, cfg.lam)
            else:
                returns = discounted_returns(
                    traj.reward, traj.terminated, traj.truncated,
                    next_values, cfg.gamma)
                advantages = returns - values
            if mesh is None:
                advantages = (advantages - advantages.mean()) / (
                    advantages.std(unbiased=False) + cfg.eps)
            else:
                (m,) = mesh.all_mean([advantages.mean()])
                (var,) = mesh.all_mean([((advantages - m) ** 2).mean()])
                advantages = (advantages - m) / (torch.sqrt(var) + cfg.eps)
            old_mean, old_std = state.actor.dist(norm, traj.obs, anneal)
            old_log_prob = DiagGaussian.log_prob(old_mean, old_std,
                                                 traj.action).sum(-1)

        N = T * B
        world = 1 if mesh is None else mesh.world
        mb = max(1, min(cfg.minibatch_size // world, N))
        n_mb = N // mb
        flat = (traj.obs.reshape(N, -1), traj.action.reshape(N, -1),
                returns.reshape(N), advantages.reshape(N),
                old_log_prob.reshape(N), old_mean.reshape(N, -1),
                old_std.reshape(N, -1))

        stop = False
        epoch_metrics = []
        for epoch in range(cfg.epochs):
            if stop:
                # the KL stop skips the rest: zero metrics, as lax.cond's
                # skip branch gives
                epoch_metrics.append(torch.zeros(6, device=self.device))
                continue
            perm = perms[epoch][: n_mb * mb]
            batches = [x[perm].reshape((n_mb, mb) + x.shape[1:])
                       for x in flat]
            metrics = torch.stack([
                self._minibatch_update(state, [x[i] for x in batches],
                                       anneal, mesh)
                for i in range(n_mb)])
            # KL early stop: epoch-mean KL > kl_max stops later epochs
            # (ppo.py:449-451)
            stop = bool(metrics[:, 4].mean() > cfg.kl_max)
            epoch_metrics.append(metrics.mean(dim=0))
        epoch_metrics = torch.stack(epoch_metrics)

        stats = episode_stats(traj)
        if mesh is not None:
            # logging only: ranks with no finished episode weigh in at 0
            # (the JAX package's "cosmetic bias"); the count is summed
            keys = ("ep_return", "ep_len", "reward_per_step", "num_episodes")
            stats = dict(zip(keys, mesh.all_mean(
                [stats[k].float() for k in keys])))
            stats["num_episodes"] = torch.round(stats["num_episodes"]
                                                * mesh.world)
        out = {"train_ep_return": stats["ep_return"],
               "train_ep_len": stats["ep_len"],
               "reward_per_step": stats["reward_per_step"],
               "num_episodes": stats["num_episodes"]}
        for i, name in enumerate(METRICS):
            out[name] = epoch_metrics[:, i].mean()
        return out

    def _evaluate(self, state: PPOTrainState, generator: torch.Generator):
        """Deterministic eval (reference ppo.py:464): a fresh fleet for
        max_traj_len steps."""
        cfg = self.config
        return evaluate_policy(
            self.env, lambda obs: state.actor.act(state.norm, obs,
                                                  deterministic=True),
            generator, cfg.num_envs, cfg.max_traj_len)

    # ------------------------------------------------------------------
    # host-side driver
    # ------------------------------------------------------------------
    def _eval_return(self, state: PPOTrainState, itr: int,
                     mesh: Optional[Mesh]) -> float:
        """The deterministic eval's mean return: a fresh fleet of num_envs
        (ppo.py:456-467), on rank 0 and broadcast, so that the curriculum
        and the save decision take the same branch on every rank."""
        ret = torch.zeros((), device=self.device)
        if mesh is None or mesh.rank == 0:
            gen_eval = torch.Generator(device=self.device)
            gen_eval.manual_seed(itr)
            ret = self._evaluate(state, gen_eval)["ep_return"].float()
        if mesh is not None:
            ret = ret.reshape(1).contiguous()
            mesh.broadcast_([ret])
        return float(ret)

    def train(self, state: PPOTrainState, n_itr: int, logger=None,
              save_fn: Optional[Callable[[PPOTrainState], None]] = None,
              verbose: bool = True, mesh: Optional[Mesh] = None
              ) -> PPOTrainState:
        """Iterations with the host-side curriculum and logging (reference
        PPO.train, ppo.py:347-505). With `mesh` every rank of the group
        calls it with its whole state, rank 0's after any prenormalisation:
        the state is placed by `shard_ppo_state` (rank 0's nets,
        optimisers and normaliser on every rank, the fleet split), the
        iterations are SPMD ones, and rank 0 evaluates. At a save
        every rank gathers the fleet (`gather_ppo_state`) and rank 0 calls
        `save_fn` with it; pass the logger to rank 0 only."""
        cfg = self.config
        if mesh is not None:
            state = shard_ppo_state(state, mesh)
        highest_reward = -np.inf
        total_steps = 0
        curr_anneal = 1.0
        ep_counter = 0
        do_term = False      # term-threshold curriculum armed (ppo.py:456)
        start_itr = 0
        curr_thresh = 0.0

        for itr in range(n_itr):
            t0 = time.time()
            if highest_reward > (2 / 3) * cfg.max_traj_len \
                    and curr_anneal > 0.5:
                curr_anneal *= cfg.anneal_rate
            if do_term and curr_thresh < 0.35:
                curr_thresh = 0.1 * 1.0006 ** (itr - start_itr)

            state, metrics = self._train_iteration(state, curr_anneal, mesh)
            metrics = {k: float(v) for k, v in metrics.items()}
            total_steps += cfg.rollout_len * cfg.num_envs
            sample_opt_time = time.time() - t0

            eval_ret = self._eval_return(state, itr, mesh)
            eval_time = time.time() - t0 - sample_opt_time

            if metrics["train_ep_len"] >= cfg.max_traj_len * 0.75:
                ep_counter += 1
            if not do_term and ep_counter > 50:
                do_term = True
                start_itr = itr

            if verbose:
                print(f"itr {itr:4d} | test {eval_ret:8.2f} | "
                      f"train {metrics['train_ep_return']:8.2f} | "
                      f"eplen {metrics['train_ep_len']:6.1f} | "
                      f"kl {metrics['kl']:.4f} | "
                      f"t {sample_opt_time:.2f}s | eval {eval_time:.2f}s",
                      flush=True)
            if logger is not None:
                for tag, val in (
                        ("Test/Return", eval_ret),
                        ("Train/Return", metrics["train_ep_return"]),
                        ("Train/Mean Eplen", metrics["train_ep_len"]),
                        ("Train/Mean KL Div", metrics["kl"]),
                        ("Train/Mean Entropy", metrics["entropy"]),
                        ("Misc/Critic Loss", metrics["critic_loss"]),
                        ("Misc/Actor Loss", metrics["actor_loss"]),
                        ("Misc/Mirror Loss", metrics["mirror_loss"]),
                        ("Misc/Timesteps", total_steps),
                        ("Misc/Sample Times", sample_opt_time),
                        ("Misc/Evaluation Times", eval_time),
                        ("Misc/Termination Threshold", curr_thresh)):
                    logger.add_scalar(tag, val, itr)

            if eval_ret > highest_reward:
                highest_reward = eval_ret
                if mesh is not None:
                    full = gather_ppo_state(state, mesh)
                    if mesh.rank == 0 and save_fn is not None:
                        save_fn(full)
                elif save_fn is not None:
                    save_fn(state)
        return state


def run_experiment(args, device=None):
    """CLI entry (reference rl/algos/ppo.py:507-584): env and nets (the
    LSTM ones of `RecurrentPPO` with `args.recurrent`), obs-norm burn-in,
    run directory, training. `device` is where the run goes (None: the
    GPU); `args` holds apex.py's ppo flags only.

    In a process group of several ranks (`parallel.multihost.initialize`)
    the fleet is split over them where the JAX package shards it
    (ppo.py:621-634: feed-forward PPO, num_procs divisible by the world
    size): rank 0 prenormalises, writes the run directory and its
    checkpoints, and prints. Otherwise rank 0 trains alone and the other
    ranks return None."""
    import torch.distributed as dist

    from apex_tpu_torch.envs.registry import env_factory
    from apex_tpu_torch.parallel.mesh import make_mesh
    from apex_tpu_torch.runtime.checkpoint import save_checkpoint
    from apex_tpu_torch.runtime.log import create_logger

    recurrent = getattr(args, "recurrent", False)
    mesh, rank = None, 0
    if dist.is_initialized() and dist.get_world_size() > 1:
        world, rank = dist.get_world_size(), dist.get_rank()
        if not recurrent and args.num_procs % world == 0:
            mesh = make_mesh(device=device)
        elif rank:
            return None
        else:
            print(f"env fleet not sharded over {world} ranks (recurrent, "
                  f"or {args.num_procs} envs do not split evenly): rank 0 "
                  "trains alone", flush=True)
    lead = rank == 0

    env = env_factory(
        args.env_name, device=device, simrate=args.simrate,
        command_profile=args.command_profile,
        input_profile=args.input_profile, learn_gains=args.learn_gains,
        dynamics_randomization=args.dyn_random, reward=args.reward,
        history=args.history, traj=getattr(args, "traj", "walking"),
        no_delta=getattr(args, "no_delta", True),
        ik_baseline=getattr(args, "ik_baseline", False),
        estimator=getattr(args, "estimator", "firmware"),
        min_speed=getattr(args, "min_speed", -0.3),
        max_speed=getattr(args, "max_speed", 4.0),
        orient_jump_prob=getattr(args, "orient_jump_prob", 0.0),
        speed_phase_add=getattr(args, "speed_phase_add", False))

    cfg = PPOConfig(
        num_envs=args.num_procs, num_steps=args.num_steps,
        max_traj_len=args.max_traj_len, gamma=args.gamma, lam=args.lam,
        lr=args.lr, eps=args.eps, clip=args.clip,
        entropy_coeff=args.entropy_coeff,
        minibatch_size=args.minibatch_size, epochs=args.epochs,
        max_grad_norm=args.max_grad_norm, use_gae=args.use_gae,
        use_mirror=args.mirror, anneal_rate=args.anneal,
        std_dev=args.std_dev, learn_stddev=args.learn_stddev,
        bounded=args.bounded)

    if recurrent:
        # the recurrent path uses no mesh (ppo.py:600-603, 625)
        from apex_tpu_torch.agents.ppo_recurrent import RecurrentPPO

        ppo = RecurrentPPO(env, cfg)
    else:
        ppo = PPO(env, cfg)
    state = ppo.init(seed=args.seed)
    if not lead:
        # rank 0's prenormalised state reaches this rank in `train`
        return ppo.train(state, n_itr=args.n_itr, verbose=False, mesh=mesh)
    print(f"obs_dim: {env.observation_size}, action_dim: {env.action_size}")
    if args.input_norm_steps > 0:
        state = ppo.prenormalize(state, steps=args.input_norm_steps)

    logger = create_logger(args)
    print(f"Proximal Policy Optimization on {env.device} (run dir "
          f"{logger.dir}):")
    for k in ("run_name", "seed", "num_procs", "lr", "eps", "lam", "gamma",
              "std_dev", "entropy_coeff", "clip", "minibatch_size", "epochs",
              "num_steps", "max_grad_norm", "max_traj_len"):
        print(f"  {k}: {getattr(args, k, None)}")
    if mesh is not None:
        print(f"env fleet sharded over {mesh.world} ranks ({mesh.backend}, "
              f"this rank on {mesh.device}; manual-SPMD data parallelism)",
              flush=True)

    def save_fn(st):
        save_checkpoint(logger.dir, st, env)

    # RecurrentPPO.train takes no mesh: it trains single-process
    spmd = {} if mesh is None else {"mesh": mesh}
    state = ppo.train(state, n_itr=args.n_itr, logger=logger,
                      save_fn=save_fn, **spmd)
    logger.close()
    return state
