"""Diagonal-Gaussian action distribution as plain functions.

Port of `DiagGaussian` from `apex_tpu/models/distributions.py` (parity
target: torch.distributions.Normal as the reference actors use it,
rl/policies/actor.py:204,215). Sampling takes an explicit generator.
"""
from __future__ import annotations

import math

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class DiagGaussian:
    """Namespace of diagonal-Gaussian ops over broadcastable (mean, std)."""

    @staticmethod
    def sample(generator: torch.Generator, mean: torch.Tensor,
               std: torch.Tensor) -> torch.Tensor:
        noise = torch.randn(mean.shape, generator=generator,
                            dtype=mean.dtype, device=mean.device)
        return mean + std * noise

    @staticmethod
    def log_prob(mean, std, x):
        """Per-dimension log density, same shape as x."""
        z = (x - mean) / std
        return -0.5 * z * z - torch.log(std) - _LOG_SQRT_2PI

    @staticmethod
    def entropy(std):
        """Per-dimension entropy."""
        return 0.5 + _LOG_SQRT_2PI + torch.log(std)

    @staticmethod
    def kl(mean_p, std_p, mean_q, std_q):
        """KL(p||q) per dimension (torch.distributions.kl_divergence for
        Normal, reference ppo.py:339)."""
        var_ratio = (std_p / std_q) ** 2
        t1 = ((mean_p - mean_q) / std_q) ** 2
        return 0.5 * (var_ratio + t1 - 1.0 - torch.log(var_ratio))
