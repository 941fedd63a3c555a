"""Actors, critics and the observation normalizer as torch modules.

Port of `NormState`, `GaussianFFActor`, `FFActor`, `LinearActor`, `FFV`,
`FFQ`, `DualQCritic` and the LSTM stack (`GaussianLSTMActor`,
`LSTMActor`, `LSTMV`, `LSTMQ`) from `apex_tpu/models/nets.py` (reference
rl/policies/actor.py:22-311, critic.py:37-294). The JAX nets keep (in,
out) weights and compute x @ W + b; here they are `nn.Linear` layers with
(out, in) weights, and `runtime/checkpoint.py` transposes when it reads or
writes JAX leaves. `init` builds a net with the JAX package's initialisers
(normc, the mean head scaled by 0.01, zero biases; torch's default
uniform for `DualQCritic` and the LSTM nets' heads, U(-1/sqrt(H),
1/sqrt(H)) for their cells; zeros for `LinearActor`), drawing from an
explicit generator on its device. The LSTM cells keep nn.LSTMCell's
(4H, in) weights and gate order [i, f, g, o], and are stepped by hand, so
that every sum is JAX's.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
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


def _relu_mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for layer in layers:
        x = torch.relu(layer(x))
    return x


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
def _uniform_(layer: nn.Linear, generator: torch.Generator) -> None:
    """torch.nn.Linear's default distribution, as the JAX package's
    `_linear_init` draws it: weights and bias U(-k, k), k = 1/sqrt(in)."""
    k = 1.0 / float(np.sqrt(np.float32(layer.in_features)))
    for p in (layer.weight, layer.bias):
        p.copy_(-k + 2.0 * k * torch.rand(p.shape, generator=generator,
                                          device=generator.device))


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
        x = _relu_mlp(self.layers, norm(obs))
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
        return self.out(_relu_mlp(self.layers, norm(obs)))


class FFActor(nn.Module):
    """Deterministic actor of TD3 and DDPG (reference FF_Actor,
    actor.py:43-71): relu MLP, max_action * tanh of a linear head."""

    def __init__(self, obs_dim: int, action_dim: int,
                 layers: Sequence[int] = (256, 256), max_action: float = 1.0):
        super().__init__()
        self.layers = _mlp((obs_dim, *layers))
        self.out = nn.Linear(layers[-1], action_dim)
        self.max_action = max_action

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int, action_dim: int,
             layers: Sequence[int] = (256, 256),
             max_action: float = 1.0) -> "FFActor":
        """`FFActor.init` (nets.py:194-202): normc everywhere, zero
        biases."""
        actor = cls(obs_dim, action_dim, layers, max_action).to(
            generator.device)
        for layer in (*actor.layers, actor.out):
            _normc_(layer, generator)
        return actor

    def act(self, norm: NormState, obs: torch.Tensor) -> torch.Tensor:
        x = _relu_mlp(self.layers, norm(obs))
        return torch.tanh(self.out(x)) * self.max_action


class LinearActor(nn.Module):
    """ARS's policy (reference Linear_Actor, actor.py:22-41): two affine
    layers, no nonlinearity, zero-initialised."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_size: int = 32):
        super().__init__()
        self.l1 = nn.Linear(obs_dim, hidden_size)
        self.l2 = nn.Linear(hidden_size, action_dim)

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int, action_dim: int,
             hidden_size: int = 32) -> "LinearActor":
        """`LinearActor.init` (nets.py:220-226): every parameter zero; the
        generator gives the device and draws nothing."""
        actor = cls(obs_dim, action_dim, hidden_size).to(generator.device)
        with torch.no_grad():
            for p in actor.parameters():
                p.zero_()
        return actor

    def act(self, norm: NormState, obs: torch.Tensor) -> torch.Tensor:
        return self.l2(self.l1(norm(obs)))

    @staticmethod
    def flat_size(obs_dim: int, action_dim: int, hidden_size: int) -> int:
        return (hidden_size * (obs_dim + 1)
                + action_dim * (hidden_size + 1))

    @staticmethod
    def act_flat(thetas: torch.Tensor, norm: NormState, obs: torch.Tensor,
                 hidden_size: int) -> torch.Tensor:
        """A fleet of linear actors, one per row: thetas (n, D) in
        `ravel_pytree`'s order of the JAX params (l1.b, l1.w (in, out),
        l2.b, l2.w (in, out)), obs (n, obs_dim) -> actions (n, act)."""
        n, obs_dim = obs.shape
        h = hidden_size
        act_dim = (thetas.shape[1] - h * (obs_dim + 1)) // (h + 1)
        sizes = (h, obs_dim * h, act_dim, h * act_dim)
        b1, w1, b2, w2 = torch.split(thetas, sizes, dim=1)
        x = torch.bmm(norm(obs)[:, None, :], w1.reshape(n, obs_dim, h))
        x = x + b1[:, None, :]
        return (torch.bmm(x, w2.reshape(n, h, act_dim)) + b2[:, None, :]
                )[:, 0]


class FFQ(nn.Module):
    """Q(s, a) of DDPG (reference FF_Q, critic.py:80-116): relu MLP over
    [normalised obs, action], linear head."""

    def __init__(self, obs_dim: int, action_dim: int,
                 layers: Sequence[int] = (256, 256)):
        super().__init__()
        self.layers = _mlp((obs_dim + action_dim, *layers))
        self.out = nn.Linear(layers[-1], 1)

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int, action_dim: int,
             layers: Sequence[int] = (256, 256)) -> "FFQ":
        """`FFQ.init` (nets.py:261-267): normc everywhere, zero biases."""
        critic = cls(obs_dim, action_dim, layers).to(generator.device)
        for layer in (*critic.layers, critic.out):
            _normc_(layer, generator)
        return critic

    def q(self, norm: NormState, obs: torch.Tensor,
          action: torch.Tensor) -> torch.Tensor:
        x = torch.cat([norm(obs), action], dim=-1)
        return self.out(_relu_mlp(self.layers, x))


class _QBranch(nn.Module):
    def __init__(self, sizes: Sequence[int]):
        super().__init__()
        self.layers = _mlp(sizes)
        self.out = nn.Linear(sizes[-1], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(_relu_mlp(self.layers, x))


class DualQCritic(nn.Module):
    """TD3's twin Q networks (reference Dual_Q_Critic, critic.py:118-168):
    two relu MLPs over [normalised obs, action]."""

    def __init__(self, obs_dim: int, action_dim: int, hidden_size: int = 256,
                 hidden_layers: int = 2):
        super().__init__()
        sizes = (obs_dim + action_dim,) + (hidden_size,) * hidden_layers
        self.branches = nn.ModuleList([_QBranch(sizes), _QBranch(sizes)])

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int, action_dim: int,
             hidden_size: int = 256, hidden_layers: int = 2
             ) -> "DualQCritic":
        """`DualQCritic.init` (nets.py:279-293): torch's default uniform
        init, not normc."""
        critic = cls(obs_dim, action_dim, hidden_size, hidden_layers).to(
            generator.device)
        for branch in critic.branches:
            for layer in (*branch.layers, branch.out):
                _uniform_(layer, generator)
        return critic

    def q(self, norm: NormState, obs: torch.Tensor, action: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([norm(obs), action], dim=-1)
        return self.branches[0](x), self.branches[1](x)

    def q1(self, norm: NormState, obs: torch.Tensor,
           action: torch.Tensor) -> torch.Tensor:
        """Q1 alone, for the actor loss (critic.py:154-168)."""
        return self.branches[0](torch.cat([norm(obs), action], dim=-1))


# ---------------------------------------------------------------------------
# LSTM stack (reference nn.LSTMCell chains, actor.py:74-139, 218-311)
# ---------------------------------------------------------------------------

LOG_STD_LO, LOG_STD_HI = -20.0, -1.5    # learned-std clamp (nets.py:40-41)


class LSTMCell(nn.Module):
    """One cell's parameters under nn.LSTMCell's names and shapes:
    weight_ih (4H, in), weight_hh (4H, H), bias_ih and bias_hh (4H,), the
    gates in the order [i, f, g, o]. The JAX package stores the weights
    (in, 4H) and (H, 4H); `runtime/checkpoint.py` transposes."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.weight_ih = nn.Parameter(torch.zeros(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.zeros(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.zeros(4 * hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * hidden))

    def forward(self, h: torch.Tensor, c: torch.Tensor, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """`_lstm_cell_step` (nets.py:507-514), its sums in JAX's order."""
        gates = (x @ self.weight_ih.T + self.bias_ih + h @ self.weight_hh.T
                 + self.bias_hh)
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        return o * torch.tanh(c_new), c_new


Carry = List[Tuple[torch.Tensor, torch.Tensor]]


def lstm_cells(in_dim: int, layers: Sequence[int]) -> nn.ModuleList:
    dims = (in_dim, *layers)
    return nn.ModuleList(LSTMCell(a, b) for a, b in zip(dims, dims[1:]))


@torch.no_grad()
def lstm_init_(cells: nn.ModuleList, generator: torch.Generator) -> None:
    """`lstm_init` (nets.py:478-496): every weight and bias of a cell of
    width H drawn U(-1/sqrt(H), 1/sqrt(H))."""
    for cell in cells:
        k = 1.0 / float(np.sqrt(np.float32(cell.weight_hh.shape[1])))
        for p in (cell.weight_ih, cell.weight_hh, cell.bias_ih,
                  cell.bias_hh):
            p.copy_(-k + 2.0 * k * torch.rand(p.shape, generator=generator,
                                              device=generator.device))


def lstm_zero_carry(layers: Sequence[int], batch_shape=(), device=None
                    ) -> Carry:
    """Zeroed (h, c) per cell (reference init_hidden_state,
    actor.py:104-106)."""
    return [(torch.zeros((*batch_shape, h), device=device),
             torch.zeros((*batch_shape, h), device=device)) for h in layers]


def lstm_step(cells: nn.ModuleList, carry: Carry, x: torch.Tensor
              ) -> Tuple[Carry, torch.Tensor]:
    """One time step through the whole stack: (new carry, top h)."""
    new = []
    for cell, (h, c) in zip(cells, carry):
        h, c = cell(h, c, x)
        new.append((h, c))
        x = h
    return new, x


def carry_where(done: torch.Tensor, zero: Carry, carry: Carry) -> Carry:
    """Per-env reset of a carry where done (B,) holds (`_carry_where`,
    ppo_recurrent.py:39-43)."""
    d = done[:, None]
    return [(torch.where(d, zh, h), torch.where(d, zc, c))
            for (zh, zc), (h, c) in zip(zero, carry)]


def lstm_seq(cells: nn.ModuleList, carry: Carry, xs: torch.Tensor,
             starts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stack scanned over xs (T, ..., in) from `carry`: the top h of
    every step (T, ..., H). Where starts (T, B) > 0.5 the carry is zeroed
    before that step's cell step (`_seq_apply`, ppo_recurrent.py:223-236)."""
    zero = None if starts is None else [
        (torch.zeros_like(h), torch.zeros_like(c)) for h, c in carry]
    tops = []
    for t in range(xs.shape[0]):
        if starts is not None:
            carry = carry_where(starts[t] > 0.5, zero, carry)
        carry, top = lstm_step(cells, carry, xs[t])
        tops.append(top)
    return torch.stack(tops)


class _LSTMNet(nn.Module):
    """An LSTM stack over the normalised observation (and, for LSTMQ, the
    action) with a linear head `out`, initialised as the JAX package does:
    `lstm_init`'s uniform cells, torch's default uniform for the heads."""

    def __init__(self, in_dim: int, out_dim: int, layers: Sequence[int]):
        super().__init__()
        self.layers = tuple(layers)
        self.cells = lstm_cells(in_dim, layers)
        self.out = nn.Linear(layers[-1], out_dim)

    def _init(self, generator: torch.Generator):
        lstm_init_(self.cells, generator)
        _uniform_(self.out, generator)
        return self

    def zero_carry(self, batch_shape=()) -> Carry:
        return lstm_zero_carry(self.layers, batch_shape,
                               self.out.weight.device)

    def _seq(self, xs: torch.Tensor) -> torch.Tensor:
        return lstm_seq(self.cells, self.zero_carry(xs.shape[1:-1]), xs)


class GaussianLSTMActor(_LSTMNet):
    """Reference Gaussian_LSTM_Actor (actor.py:218-311): LSTM stack, linear
    mean head, a fixed std or exp(clip(log-std head, -20, -1.5))."""

    def __init__(self, obs_dim: int, action_dim: int,
                 layers: Sequence[int] = (128, 128),
                 fixed_std: Optional[float] = None):
        super().__init__(obs_dim, action_dim, layers)
        self.log_std = (nn.Linear(layers[-1], action_dim)
                        if fixed_std is None else None)
        self.fixed_std = fixed_std

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int, action_dim: int,
             layers: Sequence[int] = (128, 128),
             fixed_std: Optional[float] = None) -> "GaussianLSTMActor":
        """`GaussianLSTMActor.init` (nets.py:533-546)."""
        actor = cls(obs_dim, action_dim, layers, fixed_std).to(
            generator.device)._init(generator)
        if actor.log_std is not None:
            _uniform_(actor.log_std, generator)
        return actor

    def head(self, top: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        mean = self.out(top)
        if self.log_std is not None:
            std = torch.exp(torch.clamp(self.log_std(top), LOG_STD_LO,
                                        LOG_STD_HI))
        else:
            std = torch.full_like(mean, self.fixed_std)
        return mean, std

    def step_dist(self, norm: NormState, carry: Carry, obs: torch.Tensor):
        """One control step: (carry, obs) -> (carry', (mean, std))."""
        carry, top = lstm_step(self.cells, carry, norm(obs))
        return carry, self.head(top)

    def seq_dist(self, norm: NormState, obs_seq: torch.Tensor):
        """(T, ..., obs_dim) from a zero carry -> (mean, std)."""
        return self.head(self._seq(norm(obs_seq)))

    @staticmethod
    def flat_sizes(obs_dim: int, action_dim: int, layers: Sequence[int]
                   ) -> List[Tuple[int, ...]]:
        """The shapes, in `ravel_pytree`'s order of the JAX params of a
        fixed-std actor (dict keys sorted: cells[i].{b_hh, b_ih, w_hh,
        w_ih}, then out.{b, w}), weights (in, out)."""
        dims = (obs_dim, *layers)
        shapes = []
        for a, h in zip(dims, dims[1:]):
            shapes += [(4 * h,), (4 * h,), (h, 4 * h), (a, 4 * h)]
        return shapes + [(action_dim,), (layers[-1], action_dim)]

    @staticmethod
    def step_flat(thetas: torch.Tensor, norm: NormState, carry: Carry,
                  obs: torch.Tensor, layers: Sequence[int], action_dim: int):
        """A fleet of fixed-std LSTM actors, one per row: thetas (n, D) in
        `ravel_pytree`'s order (`flat_sizes`), carry [(h, c) (n, H)] and
        obs (n, obs_dim) -> (carry', mean (n, action_dim))."""
        n, obs_dim = obs.shape
        shapes = GaussianLSTMActor.flat_sizes(obs_dim, action_dim, layers)
        parts = torch.split(thetas, [int(np.prod(s)) for s in shapes], dim=1)
        parts = [p.reshape(n, *s) for p, s in zip(parts, shapes)]
        x = norm(obs)[:, None, :]
        new = []
        for i, (h, c) in enumerate(carry):
            b_hh, b_ih, w_hh, w_ih = parts[4 * i:4 * i + 4]
            gates = (torch.bmm(x, w_ih) + b_ih[:, None]
                     + torch.bmm(h[:, None], w_hh) + b_hh[:, None])[:, 0]
            gi, gf, gg, go = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(c)
            new.append((h, c))
            x = h[:, None]
        b, w = parts[-2:]
        return new, (torch.bmm(x, w) + b[:, None])[:, 0]


class LSTMActor(_LSTMNet):
    """Deterministic tanh-bounded LSTM actor of RDPG (reference LSTM_Actor,
    actor.py:74-139): LSTM stack, max_action * tanh of a linear head."""

    def __init__(self, obs_dim: int, action_dim: int,
                 layers: Sequence[int] = (128, 128), max_action: float = 1.0):
        super().__init__(obs_dim, action_dim, layers)
        self.max_action = max_action

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int, action_dim: int,
             layers: Sequence[int] = (128, 128),
             max_action: float = 1.0) -> "LSTMActor":
        """`LSTMActor.init` (nets.py:590-599)."""
        return cls(obs_dim, action_dim, layers, max_action).to(
            generator.device)._init(generator)

    def head(self, top: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.out(top)) * self.max_action

    def step_act(self, norm: NormState, carry: Carry, obs: torch.Tensor):
        carry, top = lstm_step(self.cells, carry, norm(obs))
        return carry, self.head(top)

    def seq_act(self, norm: NormState, obs_seq: torch.Tensor):
        return self.head(self._seq(norm(obs_seq)))


class LSTMV(_LSTMNet):
    """Reference LSTM_V (critic.py:236-294)."""

    def __init__(self, obs_dim: int, layers: Sequence[int] = (128, 128)):
        super().__init__(obs_dim, 1, layers)

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int,
             layers: Sequence[int] = (128, 128)) -> "LSTMV":
        return cls(obs_dim, layers).to(generator.device)._init(generator)

    def step_value(self, norm: NormState, carry: Carry, obs: torch.Tensor):
        carry, top = lstm_step(self.cells, carry, norm(obs))
        return carry, self.out(top)

    def seq_value(self, norm: NormState, obs_seq: torch.Tensor):
        return self.out(self._seq(norm(obs_seq)))


class LSTMQ(_LSTMNet):
    """Reference LSTM_Q (critic.py:170-234): the stack over [normalised
    obs, action]."""

    def __init__(self, obs_dim: int, action_dim: int,
                 layers: Sequence[int] = (128, 128)):
        super().__init__(obs_dim + action_dim, 1, layers)

    @classmethod
    def init(cls, generator: torch.Generator, obs_dim: int, action_dim: int,
             layers: Sequence[int] = (128, 128)) -> "LSTMQ":
        return cls(obs_dim, action_dim, layers).to(
            generator.device)._init(generator)

    def step_q(self, norm: NormState, carry: Carry, obs: torch.Tensor,
               action: torch.Tensor):
        x = torch.cat([norm(obs), action], dim=-1)
        carry, top = lstm_step(self.cells, carry, x)
        return carry, self.out(top)

    def seq_q(self, norm: NormState, obs_seq: torch.Tensor,
              action_seq: torch.Tensor):
        return self.out(self._seq(torch.cat([norm(obs_seq), action_seq],
                                            dim=-1)))
