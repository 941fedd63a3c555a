"""Action distributions as plain functions.

Port of `DiagGaussian` and `BoundedBeta` from
`apex_tpu/models/distributions.py` (parity targets:
torch.distributions.Normal as the reference actors use it,
rl/policies/actor.py:204,215, and rl/distributions/beta.py). Sampling
takes an explicit generator.
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


def _log_beta(alpha, beta):
    return (torch.lgamma(alpha) + torch.lgamma(beta)
            - torch.lgamma(alpha + beta))


class BoundedBeta:
    """Beta distribution scaled to (-1, 1) (`BoundedBeta`,
    apex_tpu/models/distributions.py:47-81; reference
    rl/distributions/beta.py:10-36: x = 2z - 1 with z ~ Beta(a, b))."""

    @staticmethod
    def sample(generator: torch.Generator, alpha: torch.Tensor,
               beta: torch.Tensor) -> torch.Tensor:
        """z = X / (X + Y) with X ~ Gamma(alpha), Y ~ Gamma(beta), drawn
        from the generator (torch's Gamma sampler takes none)."""
        x = torch._standard_gamma(alpha, generator=generator)
        y = torch._standard_gamma(beta, generator=generator)
        return 2.0 * (x / (x + y)) - 1.0

    @staticmethod
    def log_prob(alpha, beta, x):
        z = torch.clamp((x + 1.0) / 2.0, 1e-6, 1.0 - 1e-6)
        # includes the |dz/dx| = 1/2 change of variables
        return ((alpha - 1.0) * torch.log(z) + (beta - 1.0) * torch.log1p(-z)
                - _log_beta(alpha, beta) - math.log(2.0))

    @staticmethod
    def entropy(alpha, beta):
        dg = torch.digamma
        return (_log_beta(alpha, beta) - (alpha - 1.0) * dg(alpha)
                - (beta - 1.0) * dg(beta)
                + (alpha + beta - 2.0) * dg(alpha + beta))

    @staticmethod
    def from_mean_var(mean, var):
        """Beta2 parameterisation (reference beta.py:40-104): mean in (0, 1)
        and variance -> (alpha, beta)."""
        nu = mean * (1.0 - mean) / torch.clamp(var, min=1e-8) - 1.0
        nu = torch.clamp(nu, min=1e-4)
        return mean * nu, (1.0 - mean) * nu
