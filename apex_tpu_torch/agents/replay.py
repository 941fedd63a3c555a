"""Replay ring on the device.

Port of `apex_tpu/agents/replay.py` (reference remote_replay.py:18-108):
transitions live in fixed-size tensors on the learner's device; a bulk
add writes its rows with one indexed copy per field, wrapping modulo the
capacity, and a sample is a gather of uniform indices. Unlike the JAX
dataclass, the ring is updated in place; `ptr` and `size` are host ints,
since the number of rows an add writes is known on the host.
"""
from __future__ import annotations

from typing import Tuple

import torch


class ReplayBuffer:
    FIELDS = ("obs", "action", "reward", "next_obs", "not_done")

    def __init__(self, capacity: int, obs_dim: int, act_dim: int,
                 device: torch.device):
        z = lambda *shape: torch.zeros(shape, device=device)
        self.obs = z(capacity, obs_dim)
        self.action = z(capacity, act_dim)
        self.reward = z(capacity)
        self.next_obs = z(capacity, obs_dim)
        self.not_done = z(capacity)    # 1.0 where the episode continued
        self.ptr = 0                   # next write position
        self.size = 0                  # filled entries

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    def add_batch(self, obs, action, reward, next_obs, not_done) -> None:
        """Insert N transitions (reference add_bulk, remote_replay.py:34-44),
        wrapping modulo the capacity."""
        n = obs.shape[0]
        cap = self.capacity
        idx = (self.ptr + torch.arange(n, device=obs.device)) % cap
        for name, rows in zip(self.FIELDS,
                              (obs, action, reward, next_obs, not_done)):
            getattr(self, name).index_copy_(0, idx, rows)
        self.ptr = (self.ptr + n) % cap
        self.size = min(self.size + n, cap)

    def gather(self, idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(obs, action, reward, next_obs, not_done) at the given rows."""
        return tuple(getattr(self, name)[idx] for name in self.FIELDS)

    def sample(self, generator: torch.Generator, batch_size: int):
        """Uniform sample over the filled rows (remote_replay.py:46-62)."""
        idx = torch.randint(0, max(self.size, 1), (batch_size,),
                            generator=generator, device=self.obs.device)
        return self.gather(idx)
