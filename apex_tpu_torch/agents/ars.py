"""Augmented Random Search (v1/v2) with one fleet of antithetic policies.

Port of `apex_tpu/agents/ars.py` (reference rl/algos/ars.py): each
iteration draws `deltas` directions of the flat policy parameters θ, rolls
out the 2·`deltas` candidates θ ± std·δ as ONE fleet of 2·`deltas` envs,
each env acting with its own θ (`LinearActor.act_flat`, a batched affine
map), for `max_traj_len` steps without auto-reset: a dead env keeps
stepping and its alive mask stops its return (ars.py:105-121). The update
ranks the directions by max(r+, r-), keeps the top `deltas_used`, and
steps by lr / (n sigma_R) sum (r+ - r-) δ (reference ARS.step,
ars.py:122-157). v2 also normalises the observations, with every step's
observation of the fleet, dead steps included. With `recurrent` the
policy is a fixed-std `GaussianLSTMActor` of layers (hidden_size,
hidden_size) acting with its mean, θ in the order JAX's `ravel_pytree`
gives its params (`GaussianLSTMActor.flat_sizes`), each candidate's
hidden state carried through its rollout (`GaussianLSTMActor.step_flat`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from apex_tpu_torch.envs.base import Env
from apex_tpu_torch.models.nets import (
    GaussianLSTMActor,
    LinearActor,
    NormState,
    lstm_zero_carry,
)


@dataclasses.dataclass(frozen=True)
class ARSConfig:
    """Defaults mirror reference apex.py:44-69 (ars.py:28-42)."""
    deltas: int = 64
    deltas_used: int = 32
    step_size: float = 0.01           # lr
    delta_std: float = 0.0075         # std
    max_traj_len: int = 400
    hidden_size: int = 32
    algo: str = "v1"                  # v2 adds observation normalization
    recurrent: bool = False


@dataclasses.dataclass
class ARSTrainState:
    theta: torch.Tensor               # (D,) flat policy parameters
    norm: NormState
    generator: torch.Generator
    seed: int
    total_steps: int


class ARS:
    def __init__(self, env: Env, config: ARSConfig):
        self.env = env
        self.config = config
        self.device = env.device
        if config.recurrent:
            self.lstm_layers = (config.hidden_size, config.hidden_size)
            self.dim = sum(int(np.prod(s)) for s in
                           GaussianLSTMActor.flat_sizes(
                               env.observation_size, env.action_size,
                               self.lstm_layers))
        else:
            self.dim = LinearActor.flat_size(
                env.observation_size, env.action_size, config.hidden_size)

    def init(self, seed: int) -> ARSTrainState:
        """Zero θ (the reference Linear_Actor zeroes every parameter,
        actor.py:31-32; the LSTM policy's θ starts at zero too,
        ars.py:67-72)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return ARSTrainState(
            theta=torch.zeros(self.dim, device=self.device),
            norm=NormState(self.env.observation_size).to(self.device),
            generator=gen, seed=seed, total_steps=0)

    @torch.no_grad()
    def _rollout_batch(self, thetas: torch.Tensor, norm: NormState,
                       generator: torch.Generator):
        """Each candidate's undiscounted episode return (n,), its steps
        alive (n,) int32, and the observations the fleet acted on (T, n,
        obs_dim) (reference ARS_process.rollout, ars.py:65-93)."""
        cfg = self.config
        env = self.env
        n = thetas.shape[0]
        state, obs = env.reset(env.sample_reset_noise(generator, n))
        ret = torch.zeros(n, device=self.device)
        steps = torch.zeros(n, dtype=torch.int32, device=self.device)
        alive = torch.ones(n, device=self.device)
        obs_seq = []
        if cfg.recurrent:
            carry = lstm_zero_carry(self.lstm_layers, (n,), self.device)
        for _ in range(cfg.max_traj_len):
            if cfg.recurrent:
                carry, action = GaussianLSTMActor.step_flat(
                    thetas, norm, carry, obs, self.lstm_layers,
                    env.action_size)
            else:
                action = LinearActor.act_flat(thetas, norm, obs,
                                              cfg.hidden_size)
            obs_seq.append(obs)
            state, obs, r, term = env.step(
                state, action, env.sample_step_noise(generator, n))
            ret = ret + r * alive
            steps = steps + alive.to(torch.int32)
            alive = alive * (1.0 - term.float())
        return ret, steps, torch.stack(obs_seq)

    def _iteration(self, state: ARSTrainState):
        cfg = self.config
        deltas = torch.randn((cfg.deltas, self.dim),
                             generator=state.generator, device=self.device)
        cand = torch.cat([state.theta + cfg.delta_std * deltas,
                          state.theta - cfg.delta_std * deltas])
        returns, steps, obs_seq = self._rollout_batch(cand, state.norm,
                                                      state.generator)
        return self._update(state, deltas, returns, steps, obs_seq)

    @torch.no_grad()
    def _update(self, state: ARSTrainState, deltas: torch.Tensor,
                returns: torch.Tensor, steps: torch.Tensor,
                obs_seq: torch.Tensor):
        """θ and (v2) the normaliser from the directions (deltas, D), the
        candidates' returns (2 deltas,) [θ + std δ first], their steps
        alive and the observations of the rollout (..., obs_dim)."""
        cfg = self.config
        r_pos, r_neg = returns[:cfg.deltas], returns[cfg.deltas:]
        # rank by max(r+, r-), keep the top deltas_used (ars.py:137-147)
        scores = torch.maximum(r_pos, r_neg)
        top = torch.argsort(-scores, stable=True)[:cfg.deltas_used]
        r_p, r_n, d = r_pos[top], r_neg[top], deltas[top]
        sigma_r = torch.std(torch.cat([r_p, r_n]), correction=0) + 1e-8
        theta = state.theta + (cfg.step_size / (cfg.deltas_used * sigma_r)) \
            * ((r_p - r_n) @ d)
        if cfg.algo == "v2":
            state.norm.update(obs_seq.reshape(-1, obs_seq.shape[-1]))
        n_steps = steps.sum()
        state = dataclasses.replace(
            state, theta=theta,
            total_steps=state.total_steps + int(n_steps))
        return state, {"mean_return": returns.mean(),
                       "max_return": returns.max(), "sigma_r": sigma_r,
                       "timesteps": n_steps}

    def train(self, state: ARSTrainState, n_itr: int, logger=None,
              save_fn=None, verbose: bool = True) -> ARSTrainState:
        highest = -np.inf
        for it in range(n_itr):
            t0 = time.time()
            state, metrics = self._iteration(state)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            if verbose:
                print(f"itr {it:4d} | mean {metrics['mean_return']:8.2f} | "
                      f"max {metrics['max_return']:8.2f} | {dt:.2f}s "
                      f"({metrics['timesteps'] / dt:,.0f} steps/s)",
                      flush=True)
            if logger is not None:
                logger.add_scalar("Test/Return", metrics["mean_return"], it)
                logger.add_scalar("Misc/Timesteps", state.total_steps, it)
            if metrics["mean_return"] > highest:
                highest = metrics["mean_return"]
                if save_fn is not None:
                    save_fn(state)
        return state


def run_experiment(args, device=None):
    """CLI entry (reference ars.py:159-268): `device` is where the run goes
    (None: the GPU); `args` holds apex.py's ars flags only."""
    from apex_tpu_torch.envs.registry import env_factory
    from apex_tpu_torch.runtime.checkpoint import save_checkpoint
    from apex_tpu_torch.runtime.log import create_logger

    cfg = ARSConfig(
        deltas=args.deltas, deltas_used=args.deltas_used, step_size=args.lr,
        delta_std=args.std, max_traj_len=args.max_traj_len,
        hidden_size=args.hidden_size, algo=args.algo,
        recurrent=getattr(args, "recurrent", False))
    env = env_factory(
        args.env_name, device=device, simrate=args.simrate,
        command_profile=args.command_profile,
        input_profile=args.input_profile, reward=args.reward,
        dynamics_randomization=args.dyn_random, history=args.history)
    ars = ARS(env, cfg)
    state = ars.init(seed=args.seed)
    logger = create_logger(args)
    print(f"Augmented Random Search on {env.device} (run dir {logger.dir}): "
          f"{2 * cfg.deltas} envs", flush=True)
    state = ars.train(state, n_itr=args.n_itr, logger=logger,
                      save_fn=lambda st: save_checkpoint(logger.dir, st, env))
    logger.close()
    return state
