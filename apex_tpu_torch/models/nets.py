"""Actor, critic and observation normalizer as torch modules.

Port of `NormState`, `GaussianFFActor` and `FFV` from
`apex_tpu/models/nets.py` (reference rl/policies/actor.py:142-215,
critic.py:37-77). The JAX nets keep (in, out) weights and compute
x @ W + b; here they are `nn.Linear` layers with (out, in) weights, and
`runtime/checkpoint.py` transposes when it loads JAX leaves. `init`
builds a net with the JAX package's initialisers (normc, the mean head
scaled by 0.01, zero biases), drawing from an explicit generator.
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


def normc_init(generator: torch.Generator, in_dim: int, out_dim: int,
               scale: float = 1.0) -> torch.Tensor:
    """normc (reference base.py:7-13, `apex_tpu.models.nets.normc_init`):
    N(0, 1) draws, each output unit's weights scaled to norm `scale`.
    Returns the (in, out) matrix of the JAX layout; an nn.Linear takes
    its transpose."""
    w = torch.randn((in_dim, out_dim), generator=generator,
                    device=generator.device)
    w = w / torch.sqrt(torch.sum(w * w, dim=0, keepdim=True))
    return w * scale


@torch.no_grad()
def _normc_(layer: nn.Linear, generator: torch.Generator,
            scale: float = 1.0) -> None:
    """Set an nn.Linear to normc weights and a zero bias."""
    w = normc_init(generator, layer.in_features, layer.out_features, scale)
    layer.weight.copy_(w.T)
    layer.bias.zero_()


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

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int, action_dim: int,
             layers: Sequence[int] = (256, 256),
             fixed_std: Optional[float] = None,
             bounded: bool = False) -> "GaussianFFActor":
        """`GaussianFFActor.init` (nets.py:145-162): normc hidden layers,
        the mean head scaled by 0.01 (actor.py:175-178), a normc log-std
        head when the std is learned, zero biases; on the generator's
        device."""
        actor = cls(obs_dim, action_dim, layers, fixed_std, bounded).to(
            generator.device)
        for layer in actor.layers:
            _normc_(layer, generator)
        _normc_(actor.mean, generator, scale=0.01)
        if actor.log_std is not None:
            _normc_(actor.log_std, generator)
        return actor

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

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int,
             layers: Sequence[int] = (256, 256)) -> "FFV":
        """`FFV.init` (nets.py:244-251): normc everywhere, zero biases."""
        critic = cls(obs_dim, layers).to(generator.device)
        for layer in (*critic.layers, critic.out):
            _normc_(layer, generator)
        return critic

    def value(self, norm: NormState, obs: torch.Tensor) -> torch.Tensor:
        x = norm(obs)
        for layer in self.layers:
            x = torch.relu(layer(x))
        return self.out(x)
