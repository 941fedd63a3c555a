"""The env fleet split over the ranks of a process group.

Counterpart of `apex_tpu/parallel/mesh.py`. The JAX package shards the
fleet over an `env` mesh axis of one program; PyTorch runs one process per
device, so here:

- a rank stands for a mesh device, and `Mesh` describes the group from
  one rank: world size, rank, device and backend;
- a rank's local fleet stands for its shard: `shard_runner` takes the
  rank's contiguous block of envs `[r B / W, (r + 1) B / W)`, as
  `P("env")` splits the leading axis, and `gather_runner` joins the blocks
  in rank order;
- `Mesh.all_mean` (an all-reduce of the sum, over the world size) stands
  for `pmean`.

The JAX package's `mesh_context` has no counterpart: a rank's fleet is its
shard, so nothing has to tell the PD scan that it runs inside a mesh
(`physics/fleet_kernel.partitioned` marks the launches that run on a
shard). Its per-env leaves are found by shape (leading dim == fleet size);
here each leaf's env axis comes from the runner's known layout instead:
the env state is batch-last, obs, traj_len and ep_return are batch-first.
A shape rule would split the wrong axis whenever the fleet size equals a
state width (nv 32, nq 35, an obs width).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.agents.rollout import RunnerState
from apex_tpu_torch.device import resolve_device
from apex_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclasses.dataclass
class Mesh:
    """The process group as one rank sees it. `world` 1 with no group is
    the single-process run. With `timing`, every collective synchronises
    the device before and after, and `reduce_calls` / `reduce_seconds`
    count the all-reduces and the host seconds inside them."""
    world: int
    rank: int
    device: torch.device
    backend: str
    timing: bool = False
    reduce_calls: int = 0
    reduce_seconds: float = 0.0

    def _sync(self) -> None:
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_mean(self, tensors: Sequence[torch.Tensor]
                 ) -> List[torch.Tensor]:
        """The mean over ranks of each tensor (float32), by one all-reduce
        of their concatenation: `jax.lax.pmean`. Every rank receives the
        same bits. A group of one rank reduces too (through its backend);
        only the single process without a group skips it."""
        if self.backend == "none":
            return list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._sync()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        self._sync()
        self.reduce_seconds += time.perf_counter() - t0
        self.reduce_calls += 1
        flat = flat / self.world
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].reshape(t.shape))
            i += t.numel()
        return out

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0
                   ) -> None:
        """Overwrite each tensor with rank `src`'s, in place."""
        if self.world == 1:
            return
        for t in tensors:
            dist.broadcast(t, src)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's `x`, joined along `dim` in rank order. Gloo gathers
        on the host, NCCL on the device."""
        if self.world == 1:
            return x
        stage = x.cpu() if self.backend == "gloo" else x
        stage = torch.movedim(stage, dim, 0).contiguous()
        parts = [torch.empty_like(stage) for _ in range(self.world)]
        dist.all_gather(parts, stage)
        return torch.movedim(torch.cat(parts), 0, dim).to(x.device)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The group this process belongs to, or the single process when no
    group is initialised (`multihost.initialize`). `n_devices`, where
    given, must be the world size: every rank is one mesh device.
    `device` is where this rank runs (None: the current CUDA device)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = str(dist.get_backend())
    else:
        world, rank, backend = 1, 0, "none"
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a mesh of {n_devices} devices needs a group of "
                         f"{n_devices} ranks; this group has {world}")
    return Mesh(world=world, rank=rank, device=dev, backend=backend)


def env_block(num_envs: int, rank: int, world: int) -> slice:
    """Rank `rank`'s envs of a fleet of `num_envs` split over `world`
    ranks: the contiguous block `P("env")` gives a device. The blocks must
    be equal (the global advantage moments are means of the ranks'
    means)."""
    if num_envs % world:
        raise ValueError(f"{num_envs} envs do not split evenly over "
                         f"{world} ranks")
    n = num_envs // world
    return slice(rank * n, (rank + 1) * n)


def map_runner(fn: Callable[[torch.Tensor, int], torch.Tensor],
               runner: RunnerState) -> RunnerState:
    """fn(leaf, env axis) over a RunnerState: the env state's leaves on
    their last axis (batch-last), obs, traj_len and ep_return on their
    first."""
    return RunnerState(
        env_state=tree_map(lambda x: fn(x, -1), runner.env_state),
        obs=fn(runner.obs, 0), traj_len=fn(runner.traj_len, 0),
        ep_return=fn(runner.ep_return, 0))


def runner_leaves(runner: RunnerState) -> List[tuple]:
    """(leaf, env axis) for every leaf of a RunnerState, in `map_runner`'s
    order."""
    return ([(x, -1) for x in tree_leaves(runner.env_state)]
            + [(runner.obs, 0), (runner.traj_len, 0), (runner.ep_return, 0)])


def shard_runner(runner: RunnerState, rank: int, world: int
                 ) -> RunnerState:
    """The rank's block of every per-env leaf of the runner."""
    num_envs = runner.obs.shape[0]
    block = env_block(num_envs, rank, world)

    def take(x, axis):
        if x.shape[axis] != num_envs:
            raise ValueError(f"a runner leaf of shape {tuple(x.shape)} has "
                             f"no env axis of {num_envs} at {axis}")
        return x[block] if axis == 0 else x[..., block].contiguous()

    return map_runner(take, runner)


def gather_runner(runner: RunnerState, mesh: Mesh) -> RunnerState:
    """The whole fleet from every rank's block, in rank order (every rank
    takes part and receives it)."""
    return map_runner(lambda x, axis: mesh.all_gather(x, axis), runner)


def replicated_tensors(state) -> List[torch.Tensor]:
    """The tensors of a PPOTrainState's replicated fields: the nets'
    parameters, the normaliser's statistics and both optimisers'
    moments."""
    out = []
    for net in (state.actor, state.critic, state.norm):
        out += list(net.parameters()) + list(net.buffers())
    for opt in (state.actor_opt, state.critic_opt):
        out += opt.mu + opt.nu
    return out


def _broadcast_generator(gen: torch.Generator, mesh: Mesh) -> None:
    s = gen.get_state().to(mesh.device)
    mesh.broadcast_([s])
    gen.set_state(s.cpu())


def rank_generator(seed: int, mesh: Mesh) -> torch.Generator:
    """The rank's own generator for its rollout draws (action noise,
    resets), as the JAX package folds the device index into the rollout
    key (ppo.py:288-297)."""
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed((seed * 0x5EED + mesh.rank + 1) % (2 ** 63))
    return gen


def shard_ppo_state(state, mesh: Mesh):
    """Rank 0's whole train state on every rank, the runner cut to the
    rank's block (`shard_ppo_state` and `ppo_partition_specs`,
    apex_tpu/parallel/mesh.py:157-192: only the runner is split). The
    replicated fields (nets, optimisers with their step counts,
    normaliser, the shared generator's state) and the full fleet are
    broadcast from rank 0, so that a prenormalisation run on rank 0 alone
    reaches every rank; then each rank keeps its block and a generator of
    its own for its rollouts."""
    counts = torch.tensor([state.actor_opt.count, state.critic_opt.count],
                          device=mesh.device)
    # copies: a leaf may share its storage with a cached constant
    runner = map_runner(
        lambda x, axis: x.clone(memory_format=torch.contiguous_format),
        state.runner)
    mesh.broadcast_(replicated_tensors(state) + [counts]
                    + [x for x, _ in runner_leaves(runner)])
    state.actor_opt.count, state.critic_opt.count = (int(c) for c in counts)
    _broadcast_generator(state.generator, mesh)
    return dataclasses.replace(
        state, runner=shard_runner(runner, mesh.rank, mesh.world),
        rank_generator=rank_generator(state.seed, mesh))


def gather_ppo_state(state, mesh: Mesh):
    """The train state with the whole fleet, as the JAX package's
    checkpoint of a sharded state holds it (`np.asarray` gathers)."""
    return dataclasses.replace(state, runner=gather_runner(state.runner,
                                                           mesh))


_POGO_XML = """
<mujoco model='pogo'>
  <compiler angle='radian'/>
  <option timestep='0.0005' gravity='0 0 -9.81'/>
  <worldbody>
    <geom name='floor' pos='0 0 0' type='plane' condim='3' conaffinity='15'
          contype='0'/>
    <body name='hopper' pos='0 0 0.3'>
      <inertial pos='0 0 0' mass='2' diaginertia='0.02 0.02 0.02'/>
      <joint name='lift' type='slide' axis='0 0 1' damping='0.5'/>
      <geom type='sphere' size='0.1' contype='1'/>
    </body>
  </worldbody>
  <actuator>
    <motor name='lift' joint='lift' gear='10' ctrlrange='-1 1'/>
  </actuator>
</mujoco>
"""


def pogo_fleet(batch: int, device, seed: int = 0):
    """(model, params, phys, cmd): `_POGO_XML`'s hopper with the heightfield
    branch on, `batch` envs batch-last on `device`, every odd env on noise
    terrain of amplitude 0.05, qpos N(0, 0.01^2), a PD hold at 0.05
    (apex_tpu/parallel/mesh.py:96-117). The draws come from a CPU
    generator seeded with `seed`, so every rank builds the same fleet."""
    from apex_tpu_torch.physics.cassie_sim import CassiePhysState, PDCommand
    from apex_tpu_torch.physics.engine import PhysParams
    from apex_tpu_torch.physics.mjcf import parse_mjcf_string
    from apex_tpu_torch.utils.terrain import noise_hfield

    model = dataclasses.replace(parse_mjcf_string(_POGO_XML),
                                enable_hfield=True)
    gen = torch.Generator()
    gen.manual_seed(seed)
    B, nu = batch, model.nu
    params = PhysParams.from_model(model, B, device)
    params.hfield = torch.stack([noise_hfield(gen, amplitude=0.05)
                                 for _ in range(B)], -1).to(device)
    params.hfield_active = (torch.arange(B) % 2).float().to(device)
    full = lambda v: torch.full((nu, B), v, device=device)
    cmd = PDCommand(p_target=full(0.05), d_target=full(0.0),
                    p_gain=full(30.0), d_gain=full(1.0), ff_torque=full(0.0))
    qpos = (0.01 * torch.randn((model.nq, B), generator=gen)).to(device)
    zero = torch.zeros((model.nv, B), device=device)
    return model, params, CassiePhysState(qpos, zero, zero.clone()), cmd


def _scan_leaves(out) -> List[torch.Tensor]:
    """The batch-last tensors of `_megakernel_pd_scan`'s output."""
    phys, diag, qvel_seq, qacc_seq = out
    return [phys.qpos, phys.qvel, phys.qacc, *diag, qvel_seq, qacc_seq]


def sharded_pd_scan(mesh: Mesh, model, params, phys, cmd, length: int
                    ) -> List[torch.Tensor]:
    """The megakernel PD scan of a whole batch-last fleet run as the
    ranks' shards: this rank scans its block under
    `fleet_kernel.partitioned` (K1-part), and the outputs are gathered in
    rank order. Returns `_scan_leaves` of the whole fleet."""
    from apex_tpu_torch.physics import fleet_kernel
    from apex_tpu_torch.physics.cassie_sim import _megakernel_pd_scan

    B = phys.qpos.shape[-1]
    block = env_block(B, mesh.rank, mesh.world)
    take = lambda x: x[..., block].contiguous()
    with fleet_kernel.partitioned(mesh.world, B):
        out = _megakernel_pd_scan(model, tree_map(take, params),
                                  tree_map(take, phys), tree_map(take, cmd),
                                  length)
    return [mesh.all_gather(x, -1) for x in _scan_leaves(out)]


def megakernel_mesh_check(mesh: Mesh, batch: int = 16, length: int = 5):
    """The megakernel PD scan partitions over the group's ranks
    (apex_tpu/parallel/mesh.py:72-154): K1 over the pogo fleet
    (`pogo_fleet`) unsharded, then split over the ranks (`sharded_pd_scan`).
    Returns (per_rank_batch, max_abs_delta): the width of the shard's last
    launch, which callers hold to batch // world, and the largest
    difference from the unsharded run, which K1's lane-wise math keeps at
    0 (callers hold it under 1e-5, as the JAX package does)."""
    from apex_tpu_torch.physics import fleet_kernel
    from apex_tpu_torch.physics.cassie_sim import _megakernel_pd_scan

    model, params, phys, cmd = pogo_fleet(batch, mesh.device)
    ref = _scan_leaves(_megakernel_pd_scan(model, params, phys, cmd, length))
    fleet_kernel.LAST_KERNEL_BATCH = None
    out = sharded_pd_scan(mesh, model, params, phys, cmd, length)
    per_rank = fleet_kernel.LAST_KERNEL_BATCH
    delta = max(float((a - b).abs().max()) for a, b in zip(ref, out))
    return per_rank, delta
