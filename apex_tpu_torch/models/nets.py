"""Actor, critic and observation normalizer as torch modules.

Port of `NormState`, `GaussianFFActor` and `FFV` from
`apex_tpu/models/nets.py` (reference rl/policies/actor.py:142-215,
critic.py:37-77). The JAX nets keep (in, out) weights and compute
x @ W + b; here they are `nn.Linear` layers with (out, in) weights, and
`runtime/checkpoint.py` transposes when it loads JAX leaves. Initializers
are not ported: the port loads trained weights.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from apex_tpu_torch.models.distributions import DiagGaussian


class NormState(nn.Module):
    """Observation normalizer statistics, folded into the policy forward
    pass ((obs - mean) / std, reference actor.py:181)."""

    def __init__(self, obs_dim: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(obs_dim))
        self.register_buffer("var", torch.ones(obs_dim))
        self.register_buffer("count", torch.tensor(1e-4))

    @property
    def std(self) -> torch.Tensor:
        return torch.sqrt(self.var + 1e-8)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return (obs - self.mean) / self.std

    @torch.no_grad()
    def update(self, batch: torch.Tensor) -> None:
        """Merge a (..., obs_dim) batch with the parallel variance
        algorithm (reference normalize.py:193-208)."""
        batch = batch.reshape(-1, batch.shape[-1])
        b_mean = batch.mean(dim=0)
        b_var = batch.var(dim=0, unbiased=False)
        b_count = torch.tensor(float(batch.shape[0]), dtype=self.count.dtype,
                               device=self.count.device)
        delta = b_mean - self.mean
        tot = self.count + b_count
        m2 = (self.var * self.count + b_var * b_count
              + delta ** 2 * self.count * b_count / tot)
        self.mean += delta * b_count / tot
        self.var.copy_(m2 / tot)
        self.count.copy_(tot)


def _mlp(sizes: Sequence[int]) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes, sizes[1:]))


class GaussianFFActor(nn.Module):
    """Gaussian feed-forward actor (reference Gaussian_FF_Actor,
    actor.py:142-215): relu MLP, linear mean head, fixed std or
    sd = exp(-2 + 0.5 tanh(logstd head)) (actor.py:193)."""

    def __init__(self, obs_dim: int, action_dim: int,
                 layers: Sequence[int] = (256, 256),
                 fixed_std: Optional[float] = None, bounded: bool = False):
        super().__init__()
        self.layers = _mlp((obs_dim, *layers))
        self.mean = nn.Linear(layers[-1], action_dim)
        self.log_std = (nn.Linear(layers[-1], action_dim)
                        if fixed_std is None else None)
        self.fixed_std = fixed_std
        self.bounded = bounded

    def dist(self, norm: NormState, obs: torch.Tensor, anneal: float = 1.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, std) of the policy distribution (actor.py:180-197)."""
        x = norm(obs)
        for layer in self.layers:
            x = torch.relu(layer(x))
        mean = self.mean(x)
        if self.bounded:
            mean = torch.tanh(mean)
        if self.log_std is not None:
            std = torch.exp(-2.0 + 0.5 * torch.tanh(self.log_std(x)))
        else:
            std = torch.full_like(mean, self.fixed_std)
        return mean, std * anneal

    def act(self, norm: NormState, obs: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False, anneal: float = 1.0) -> torch.Tensor:
        """Sample (or take the mean of) the policy (actor.py:199-208)."""
        mean, std = self.dist(norm, obs, anneal)
        if deterministic or generator is None:
            return mean
        return DiagGaussian.sample(generator, mean, std)


class FFV(nn.Module):
    """State-value critic (reference FF_V, critic.py:37-77)."""

    def __init__(self, obs_dim: int, layers: Sequence[int] = (256, 256)):
        super().__init__()
        self.layers = _mlp((obs_dim, *layers))
        self.out = nn.Linear(layers[-1], 1)

    def value(self, norm: NormState, obs: torch.Tensor) -> torch.Tensor:
        x = norm(obs)
        for layer in self.layers:
            x = torch.relu(layer(x))
        return self.out(x)
