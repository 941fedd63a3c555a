"""Returns and advantages as reverse loops over time.

Port of `apex_tpu/ops/gae.py` (its reverse `lax.scan`s become Python loops
over T): batched (T, B) rollouts with auto-reset, episode boundaries
handled by the terminated / truncated masks.

  * terminated (environment death): no bootstrap, the return restarts.
  * truncated (time limit or rollout end while alive): bootstrap with the
    critic value of the next state.
"""
from __future__ import annotations

import torch


def discounted_returns(rewards: torch.Tensor, terminated: torch.Tensor,
                       truncated: torch.Tensor, next_values: torch.Tensor,
                       gamma: float) -> torch.Tensor:
    """Monte-Carlo discounted returns with bootstrap at truncation, (T, ...)
    like rewards (reference PPOBuffer.finish_path, ppo.py:73-89)."""
    term = terminated.to(rewards.dtype)
    trunc = truncated.to(rewards.dtype)
    out = torch.empty_like(rewards)
    R = torch.zeros_like(rewards[0])
    for t in reversed(range(rewards.shape[0])):
        cont = (1.0 - term[t]) * (1.0 - trunc[t])
        boot = (1.0 - term[t]) * trunc[t] * next_values[t]
        R = rewards[t] + gamma * (cont * R + boot)
        out[t] = R
    return out


def gae_advantages(rewards: torch.Tensor, values: torch.Tensor,
                   next_values: torch.Tensor, terminated: torch.Tensor,
                   truncated: torch.Tensor, gamma: float, lam: float):
    """GAE(lambda) advantages and value targets (advantages + values):
    delta_t = r_t + gamma V_{t+1} (1 - term_t) - V_t,
    A_t = delta_t + gamma lam (1 - done_t) A_{t+1}."""
    term = terminated.to(rewards.dtype)
    trunc = truncated.to(rewards.dtype)
    done = torch.clamp(term + trunc, 0.0, 1.0)
    deltas = rewards + gamma * next_values * (1.0 - term) - values
    adv = torch.empty_like(rewards)
    A = torch.zeros_like(rewards[0])
    for t in reversed(range(rewards.shape[0])):
        A = deltas[t] + gamma * lam * (1.0 - done[t]) * A
        adv[t] = A
    return adv, adv + values
