"""Run a function of this module as the ranks of a gloo group on the CPU,
for the multi-rank tests of the port (`test_torch_parallel.py`).

Each rank is a process started with the spawn method, so it imports only
torch and the port (this module imports no JAX), joins the group through
a FileStore under the test's tmp_path (xdist workers never share one),
calls `fn(mesh, *args)` and writes what it returns with `torch.save`.
"""
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 300


def run(fn, world: int, tmp_path, *args) -> list:
    """fn(mesh, *args) on `world` ranks; the ranks' results in rank
    order."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn.__name__, r, world, str(tmp_path), args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank_main(name, rank, world, tmp, args):
    from apex_tpu_torch.parallel import multihost
    from apex_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    multihost.initialize(f"file://{tmp}/store", world, rank, device="cpu")
    try:
        out = globals()[name](make_mesh(world, device="cpu"), *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def _replicated_flat(state) -> torch.Tensor:
    from apex_tpu_torch.parallel.mesh import replicated_tensors

    return torch.cat([x.detach().reshape(-1)
                      for x in replicated_tensors(state)])


def pointmass_update(mesh, cfg, state_dict, traj, perms):
    """The port's distributed `_update` on PointMass-v0: the nets loaded
    from `state_dict`, this rank's block of the (T, B) trajectory `traj`
    (numpy), the epoch permutations `perms`. Returns the metrics, the
    leaves of (actor, critic, norm, actor_opt, critic_opt) in JAX's order
    and the replicated tensors flattened."""
    from apex_tpu_torch.agents.ppo import PPO, PPOConfig
    from apex_tpu_torch.agents.rollout import Rollout
    from apex_tpu_torch.envs.base import PointMassEnv
    from apex_tpu_torch.parallel.mesh import env_block
    from apex_tpu_torch.runtime import checkpoint

    env = PointMassEnv(device="cpu")
    ppo = PPO(env, PPOConfig(**cfg))
    state = ppo.init(seed=0)
    state.actor.load_state_dict(state_dict.actor)
    state.critic.load_state_dict(state_dict.critic)
    state.norm.load_state_dict(state_dict.norm)
    block = env_block(cfg["num_envs"], mesh.rank, mesh.world)
    local = Rollout(**{k: torch.tensor(np.ascontiguousarray(v[:, block]))
                       for k, v in traj.items()})
    metrics = ppo._update(state, local, 1.0,
                          [torch.tensor(p) for p in perms], mesh)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                leaves=checkpoint.to_jax_leaves(state, env)[:15 + 2 * 17],
                flat=_replicated_flat(state),
                steps=state.actor_opt.count)


def pogo_scan(mesh, batch, length):
    """`megakernel_mesh_check` on this group, and the sharded scan's
    gathered outputs of the same fleet."""
    from apex_tpu_torch.parallel.mesh import (megakernel_mesh_check,
                                              pogo_fleet, sharded_pd_scan)

    per_rank, delta = megakernel_mesh_check(mesh, batch, length)
    out = sharded_pd_scan(mesh, *pogo_fleet(batch, mesh.device), length)
    return dict(per_rank=per_rank, delta=delta,
                out=[x.numpy() for x in out])


class Replay:
    """Draws recorded from a single-process fleet, replayed in order, each
    cut to this rank's block of envs (every field batch-last)."""

    def __init__(self, draws, block):
        self.draws, self.block = list(draws), block

    def __call__(self, generator, batch):
        d = self.draws.pop(0)
        return type(d)(*(None if x is None
                         else x[..., self.block].contiguous() for x in d))


# the rollout test's Cassie-v0: dyn-rand, the megakernel tier, 5 substeps
ROLLOUT_ENV = dict(device="cpu", dynamics_randomization=True,
                   pd_tier="megakernel", simrate=5)


def cassie_rollout(mesh, num_envs, steps, max_traj_len, resets, step_noise):
    """A rollout of this rank's block of a Cassie-v0 fleet (ROLLOUT_ENV,
    zero actions) under `fleet_kernel.partitioned`, fed the single-process
    fleet's reset and step draws. Returns the trajectory (T, B / W, ...)
    and the width of the last K1 launch."""
    from apex_tpu_torch.agents.rollout import init_runner, rollout_scan
    from apex_tpu_torch.envs.cassie import CassieEnv
    from apex_tpu_torch.parallel.mesh import env_block
    from apex_tpu_torch.physics import fleet_kernel

    env = CassieEnv(**ROLLOUT_ENV)
    block = env_block(num_envs, mesh.rank, mesh.world)
    env.sample_reset_noise = Replay(resets, block)
    env.sample_step_noise = Replay(step_noise, block)
    runner = init_runner(env, None, num_envs // mesh.world)
    with torch.no_grad(), fleet_kernel.partitioned(mesh.world, num_envs):
        _, traj = rollout_scan(
            env, lambda obs: torch.zeros((obs.shape[0], env.action_size)),
            runner, None, steps, max_traj_len)
    return dict({k: v.numpy() for k, v in traj._asdict().items()},
                kernel_batch=fleet_kernel.LAST_KERNEL_BATCH)


def cassie_shard_and_gather(mesh, num_envs, seed):
    """A single-process Cassie-v0 PPO state of `num_envs` envs, placed by
    `shard_ppo_state` and gathered back by `gather_ppo_state`. Returns the
    shard's leaves beside the layout's slices of the whole fleet, the
    gathered state's checkpoint leaves, and the original's."""
    from apex_tpu_torch.agents.ppo import PPO, PPOConfig
    from apex_tpu_torch.envs.cassie import CassieEnv
    from apex_tpu_torch.parallel.mesh import (env_block, gather_ppo_state,
                                              map_runner, runner_leaves,
                                              shard_ppo_state)
    from apex_tpu_torch.runtime import checkpoint

    env = CassieEnv(device="cpu")
    ppo = PPO(env, PPOConfig(num_envs=num_envs))
    state = ppo.init(seed)
    whole = checkpoint.to_jax_leaves(state, env)
    full = map_runner(lambda x, axis: x.clone(), state.runner)
    shard = shard_ppo_state(state, mesh)
    block = env_block(num_envs, mesh.rank, mesh.world)
    want = [x[block] if axis == 0 else x[..., block]
            for x, axis in runner_leaves(full)]
    mine = [x for x, _ in runner_leaves(shard.runner)]
    gathered = gather_ppo_state(shard, mesh)
    return dict(
        shard_is_block=len(mine) == len(want) and all(
            torch.equal(a, b) for a, b in zip(mine, want)),
        qvel=shard.runner.env_state.phys.qvel.numpy(),
        full_qvel=full.env_state.phys.qvel.numpy(),
        gathered=checkpoint.to_jax_leaves(gathered, env), whole=whole)


def pointmass_train(mesh, cfg, n_itr, out_dir):
    """`PPO.train` of PointMass-v0 over the group (rank 0 prenormalises
    and saves checkpoints to `out_dir`); returns the replicated tensors
    flattened, and the fleet size of the rank's runner."""
    from apex_tpu_torch.agents.ppo import PPO, PPOConfig
    from apex_tpu_torch.envs.base import PointMassEnv
    from apex_tpu_torch.runtime.checkpoint import save_checkpoint

    env = PointMassEnv(device="cpu")
    ppo = PPO(env, PPOConfig(**cfg))
    state = ppo.init(seed=1)
    if mesh.rank == 0:
        state = ppo.prenormalize(state, steps=64)
    state = ppo.train(state, n_itr, verbose=False, mesh=mesh,
                      save_fn=lambda st: save_checkpoint(out_dir, st, env))
    return dict(flat=_replicated_flat(state),
                local_envs=state.runner.obs.shape[0],
                reduce_calls=mesh.reduce_calls)
