"""The port's multi-rank training path against the JAX package's SPMD one,
on the CPU: a rank of a gloo group stands for a device of JAX's mesh
(conftest's 8 virtual CPU devices, `make_mesh(2)`).

- the SPMD update: JAX's `train_iter_spmd` on a 2-device mesh, its rollout
  patched to give each device its block of one numpy-drawn trajectory,
  against the port's `_update` on 2 ranks fed the same blocks and JAX's
  local epoch permutations;
- K1 partitioned: `megakernel_mesh_check` on 2 ranks, and the sharded
  scan against JAX's unsharded megakernel scan;
- a 2-rank Cassie rollout fed the single-process draws against the
  single-process rollout;
- `shard_runner` / `gather_runner` at 32 envs (nv = 32: a shape rule would
  split the wrong axis), checkpoints of a 2-rank run in JAX's leaf order;
- the process-group set-up, and `python -m apex_tpu_torch ppo` as two
  ranks.

The ranks are processes of `torch_ranks.run`, each in a gloo group over a
FileStore under tmp_path.
"""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from apex_tpu.agents import ppo as jax_ppo
from apex_tpu.agents.rollout import Rollout as JaxRollout
from apex_tpu.agents.rollout import init_runner as jax_init_runner
from apex_tpu.envs.base import PointMassEnv as JaxPointMassEnv
from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.parallel import mesh as jax_mesh
from apex_tpu.physics import cassie_sim as jax_cassie_sim
from apex_tpu.physics.engine import PhysParams as JaxPhysParams
from apex_tpu.physics.mjcf import parse_mjcf_string as jax_parse_mjcf
from apex_tpu.runtime import log as jax_log
from apex_tpu.runtime.checkpoint import load_checkpoint as jax_load_ckpt
from apex_tpu_torch.agents.rollout import init_runner, rollout_scan
from apex_tpu_torch.envs.cassie import CassieEnv
from apex_tpu_torch.parallel import mesh, multihost
from apex_tpu_torch.physics.cassie_sim import _megakernel_pd_scan
from apex_tpu_torch.runtime import checkpoint
from test_torch_ppo import (_assert_train_leaves_close, _nets, _traj)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per process, as the port's other test files."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_template(ppo, seed=0):
    """Zeros in the leaf shapes and dtypes of `ppo.init(seed)`, traced but
    not run."""
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  jax.eval_shape(lambda: ppo.init(seed)))


# ---------------------------------------------------------------------------
# the SPMD update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kl_max,use_gae", [(0.02, False), (0.0, True)])
def test_spmd_update_matches_jax_train_iter_spmd(tmp_path, monkeypatch,
                                                 kl_max, use_gae):
    """JAX's `train_iter_spmd` on `make_mesh(2)` and the port's `_update`
    on 2 ranks, each device and rank given its 8-env block of one 16-env
    trajectory, the same weights and JAX's local permutations: metrics
    within `test_update_half_of_the_iteration_matches_jax`'s bounds, the
    parameters and optimiser states by `_assert_train_leaves_close`, and
    the ranks' nets, normalisers and moments bit for bit equal. The local
    minibatch is 32 // 2, so 4 minibatches of 16 per epoch (12 steps, or
    4 where kl_max 0 stops after the first epoch on every rank)."""
    T, B = 8, 16
    cfg = dict(num_envs=B, num_steps=T * B, minibatch_size=32, epochs=3,
               kl_max=kl_max, use_gae=use_gae, lr=3e-4)
    (ja, jc, jn), sd = _nets(4, 2, seed=3)
    traj = _traj(np.random.default_rng(3), T, B, 4, 2)
    jtraj = JaxRollout(**{k: jnp.asarray(v) for k, v in traj.items()})
    local = B // WORLD

    def block_of_traj(env, fn, runner, n, L):
        try:
            start = jax.lax.axis_index("env") * local
        except NameError:
            # train_iter_spmd's eval_shape of the unsharded iteration
            return runner, jtraj
        return runner, jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, start, local, axis=1),
            jtraj)

    monkeypatch.setattr(jax_ppo, "rollout_scan", block_of_traj)
    jenv = JaxPointMassEnv()
    jppo = jax_ppo.PPO(jenv, jax_ppo.PPOConfig(**cfg))
    jstate = jax_ppo.PPOTrainState(
        actor=ja, critic=jc, norm=jn,
        actor_opt=jppo.actor_tx.init(ja.params),
        critic_opt=jppo.critic_tx.init(jc.params),
        runner=jax_init_runner(jenv, jax.random.PRNGKey(1), B),
        rng=jax.random.PRNGKey(9))
    jmesh = jax_mesh.make_mesh(WORLD)
    _, k_perm = jax.random.split(jstate.rng)
    perms = [np.asarray(jax.random.permutation(k, T * local))
             for k in jax.random.split(k_perm, 3)]
    jnew, jm = jppo.train_iter_spmd(jmesh)(
        jax_mesh.shard_ppo_state(jmesh, jstate), jnp.asarray(1.0))
    ref = jax.tree_util.tree_leaves((jnew.actor, jnew.critic, jnew.norm,
                                     jnew.actor_opt, jnew.critic_opt))

    ranks = torch_ranks.run(torch_ranks.pointmass_update, WORLD, tmp_path,
                            cfg, sd, traj, perms)
    for r in ranks:
        for k, v in jm.items():
            np.testing.assert_allclose(r["metrics"][k], float(v), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        assert r["steps"] == (4 if kl_max == 0.0 else 12)
        _assert_train_leaves_close(r["leaves"], ref, lr=3e-4,
                                   steps=r["steps"])
        assert torch.equal(r["flat"], ranks[0]["flat"])


# ---------------------------------------------------------------------------
# K1 partitioned over the ranks
# ---------------------------------------------------------------------------

def _jax_pogo(model, params, phys, cmd):
    """The port's pogo fleet (`mesh.pogo_fleet`) as the JAX package's
    batch-last inputs of `_megakernel_pd_scan`."""
    j = lambda x: jnp.asarray(x.numpy())
    jp = JaxPhysParams(**{f: j(getattr(params, f))
                          for f in JaxPhysParams.__dataclass_fields__})
    jc = jax_cassie_sim.PDCommand(
        p_target=j(cmd.p_target), d_target=j(cmd.d_target),
        p_gain=j(cmd.p_gain), d_gain=j(cmd.d_gain),
        ff_torque=j(cmd.ff_torque))
    return jp, jc, j(phys.qpos), j(phys.qvel)


def test_megakernel_partitions_over_ranks_and_meets_jax(tmp_path):
    """`megakernel_mesh_check` on 2 ranks: the shard's launches are 8 envs
    wide (16 / 2) and the gathered scan equals the unsharded one (under
    1e-5, as `test_megakernel_path_partitions_on_mesh` holds JAX's). The
    gathered outputs meet JAX's unsharded `_megakernel_pd_scan` on the
    same pogo fleet (heightfield on, every odd env on noise terrain) at
    the port's K1-vs-JAX bound (tests/test_torch_megakernel.py): per row,
    four times the spread that 1e-7 relative changes of qpos and qvel
    cause in the port, plus 1e-6 of the row's magnitude."""
    batch, length = 16, 5
    ranks = torch_ranks.run(torch_ranks.pogo_scan, WORLD, tmp_path, batch,
                            length)
    for r in ranks:
        assert r["per_rank"] == batch // WORLD
        assert r["delta"] < 1e-5

    model, params, phys, cmd = mesh.pogo_fleet(batch, torch.device("cpu"))
    jmodel = dataclasses.replace(jax_parse_mjcf(jax_mesh._POGO_XML),
                                 enable_hfield=True)
    jphys, jdiag, jqv, jqa = jax.jit(
        lambda p, c, q, v: jax_cassie_sim._megakernel_pd_scan(
            jmodel, p, c, q, v, length))(*_jax_pogo(model, params, phys,
                                                    cmd))
    # batch-first -> the port's batch-last leaves (mesh._scan_leaves)
    bl = lambda x: np.moveaxis(np.asarray(x), 0, -1)
    ref = [bl(jphys.qpos), bl(jphys.qvel), bl(jphys.qacc),
           *(bl(x) for x in jdiag), bl(jqv), bl(jqa)]

    base = mesh._scan_leaves(_megakernel_pd_scan(model, params, phys, cmd,
                                                 length))
    rng = np.random.default_rng(0)
    spread = [np.zeros(x.reshape(-1, batch).shape[0]) for x in base]
    for _ in range(4):
        jit = lambda x: x * torch.tensor(
            1 + 1e-7 * rng.choice([-1.0, 1.0], tuple(x.shape)),
            dtype=torch.float32)
        moved = type(phys)(jit(phys.qpos), jit(phys.qvel), phys.qacc)
        out = mesh._scan_leaves(_megakernel_pd_scan(model, params, moved,
                                                    cmd, length))
        for i, (a, b) in enumerate(zip(out, base)):
            spread[i] = np.maximum(spread[i], (a - b).abs().reshape(
                -1, batch).amax(1).numpy())
    for i, (got, want) in enumerate(zip(ranks[0]["out"], ref)):
        assert got.shape == want.shape, (i, got.shape, want.shape)
        assert np.isfinite(got).all()
        err = np.abs(got - want).reshape(-1, batch).max(1)
        scale = np.abs(want).reshape(-1, batch).max(1)
        bound = 4 * spread[i] + 1e-6 * (1.0 + scale)
        assert (err <= bound).all(), (i, err.max(), bound[err > bound])


# ---------------------------------------------------------------------------
# a sharded rollout, the runner's layout, checkpoints
# ---------------------------------------------------------------------------

class _Recorder:
    """Wraps an env's draw sampler and keeps every draw it makes."""

    def __init__(self, fn):
        self.fn, self.draws = fn, []

    def __call__(self, generator, batch):
        self.draws.append(self.fn(generator, batch))
        return self.draws[-1]


def test_sharded_cassie_rollout_matches_single_process(tmp_path):
    """A dyn-rand Cassie-v0 fleet of 8 envs on the megakernel tier (K1's
    plain version; 5 substeps a step, zero actions, 3 steps with an
    episode cut at 2, so the auto-reset runs) in one process, and as 2
    ranks of 4 (K1-part) fed the same reset and step draws: every env's
    rewards and observations at `test_sharded_matches_single_device_
    rollout`'s tolerances (tests/test_multihost.py:130-162), the reset
    observations tightly, the done flags exactly.

    The fleet tier is left out: on the CPU its batched products round
    differently at 4 and 8 envs, and 50 stiff contact substeps amplify
    that to 0.05 in a velocity observation (limit (a) of ROADMAP.md's
    queue 3); K1's plain version is lane-wise."""
    B, steps, max_len = 8, 3, 2
    env = CassieEnv(**torch_ranks.ROLLOUT_ENV)
    resets = env.sample_reset_noise = _Recorder(env.sample_reset_noise)
    step_noise = env.sample_step_noise = _Recorder(env.sample_step_noise)
    gen = torch.Generator()
    gen.manual_seed(0)
    with torch.no_grad():
        _, traj = rollout_scan(
            env, lambda obs: torch.zeros((obs.shape[0], env.action_size)),
            init_runner(env, gen, B), gen, steps, max_len)
    ranks = torch_ranks.run(torch_ranks.cassie_rollout, WORLD, tmp_path, B,
                            steps, max_len, resets.draws, step_noise.draws)
    for r in ranks:
        assert r["kernel_batch"] == B // WORLD
    for name in ("reward", "obs", "terminated", "done_ep_len"):
        got = np.concatenate([r[name] for r in ranks], axis=1)
        want = getattr(traj, name).numpy()
        assert got.shape == want.shape
        if name == "reward":
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-3)
        elif name == "obs":
            np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    assert traj.done_ep_len.any()


def test_shard_and_gather_runner_at_32_envs(tmp_path):
    """At 32 envs (Cassie's nv is 32, so qvel is (32, 32)) each rank's
    shard holds exactly the layout's block of every runner leaf (the env
    state's last axis, obs / traj_len / ep_return's first), not the rows
    a leading-dim rule would take; the gathered state's checkpoint equals
    the single-process checkpoint leaf for leaf and loads through the JAX
    package's `load_checkpoint` in its own leaf shapes."""
    B = 32
    ranks = torch_ranks.run(torch_ranks.cassie_shard_and_gather, WORLD,
                            tmp_path, B, 0)
    for rank, r in enumerate(ranks):
        block = mesh.env_block(B, rank, WORLD)
        assert r["shard_is_block"]
        np.testing.assert_array_equal(r["qvel"], r["full_qvel"][:, block])
        assert not np.array_equal(r["qvel"], r["full_qvel"][block])
        assert len(r["gathered"]) == len(r["whole"])
        for a, b in zip(r["gathered"], r["whole"]):
            np.testing.assert_array_equal(a, b)
    with open(tmp_path / "checkpoint.pkl", "wb") as f:
        pickle.dump(ranks[0]["gathered"], f)
    template = _jax_template(jax_ppo.PPO(JaxCassieEnv(),
                                         jax_ppo.PPOConfig(num_envs=B)))
    restored = jax.tree_util.tree_leaves(
        jax_load_ckpt(str(tmp_path), template))
    t_leaves = jax.tree_util.tree_leaves(template)
    assert [np.shape(x) for x in ranks[0]["gathered"]] == [
        np.shape(x) for x in t_leaves]
    for a, b in zip(ranks[0]["gathered"], restored):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_two_rank_training_stays_in_lockstep(tmp_path):
    """`PPO.train` over 2 ranks on PointMass-v0 (16 envs, 3 iterations,
    rank 0 prenormalising alone): every rank ends with the same nets,
    normaliser and moments bit for bit, steps 8 envs, and rank 0's
    checkpoint holds the whole fleet in the JAX package's leaf shapes."""
    cfg = dict(num_envs=16, num_steps=128, max_traj_len=6,
               minibatch_size=32, epochs=2)
    out_dir = tmp_path / "run"
    ranks = torch_ranks.run(torch_ranks.pointmass_train, WORLD, tmp_path,
                            cfg, 3, str(out_dir))
    for r in ranks:
        assert torch.equal(r["flat"], ranks[0]["flat"])
        assert r["local_envs"] == 8
        assert r["reduce_calls"] > 0
    template = _jax_template(jax_ppo.PPO(JaxPointMassEnv(),
                                         jax_ppo.PPOConfig(**cfg)))
    with open(out_dir / "checkpoint.pkl", "rb") as f:
        saved = pickle.load(f)
    assert [np.shape(x) for x in saved] == [
        np.shape(x) for x in jax.tree_util.tree_leaves(template)]
    jax_load_ckpt(str(out_dir), template)


# ---------------------------------------------------------------------------
# the process group and the CLI
# ---------------------------------------------------------------------------

def test_initialize_stays_single_process_without_variables(monkeypatch):
    for name in ("APEX_COORD_ADDR", "APEX_NUM_PROCS", "APEX_PROC_ID",
                 "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert multihost.global_env_count(64) == 64
    m = mesh.make_mesh(device="cpu")
    assert (m.world, m.rank, m.backend) == (1, 0, "none")
    x = [torch.ones(3)]
    assert m.all_mean(x)[0] is x[0]
    with pytest.raises(ValueError, match="group of 2 ranks"):
        mesh.make_mesh(2, device="cpu")


def test_initialize_refuses_an_incomplete_group(monkeypatch):
    """With the coordinator set but no rank, the set-up raises instead of
    running single-process (the JAX package swallows a failure only when
    it auto-detects)."""
    monkeypatch.setenv("APEX_COORD_ADDR", "127.0.0.1:1")
    monkeypatch.setenv("APEX_NUM_PROCS", "2")
    monkeypatch.delenv("APEX_PROC_ID", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="APEX_PROC_ID"):
        multihost.initialize(device="cpu")


@pytest.mark.parametrize("device,local_world,gpus,want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 2, 8, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 8, 4, "gloo")])
def test_backend_follows_ranks_per_gpu(monkeypatch, device, local_world,
                                       gpus, want):
    """NCCL where every rank of the node has a GPU of its own, gloo where
    ranks share one (NCCL refuses a duplicate GPU) or run on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: gpus)
    assert multihost.backend_for(torch.device(device), local_world) == want


def test_env_block_splits_evenly_or_refuses():
    assert [mesh.env_block(1024, r, 4) for r in range(4)] == [
        slice(0, 256), slice(256, 512), slice(512, 768), slice(768, 1024)]
    with pytest.raises(ValueError, match="evenly"):
        mesh.env_block(10, 0, 4)


def test_partitions_do_not_nest():
    """K1-part's width check: a scan inside a partition steps the rank's
    shard; a second partition, or a fleet of another width, raises."""
    from apex_tpu_torch.physics import fleet_kernel

    model, params, phys, cmd = mesh.pogo_fleet(4, torch.device("cpu"))
    with fleet_kernel.partitioned(2, 8) as part:
        assert part.local_batch == 4
        _megakernel_pd_scan(model, params, phys, cmd, 1)
        assert fleet_kernel.LAST_KERNEL_BATCH == 4
        with pytest.raises(RuntimeError, match="already partitioned"):
            with fleet_kernel.partitioned(2, 4):
                pass
    with fleet_kernel.partitioned(2, 16):
        with pytest.raises(ValueError, match="a shard of 4 envs, want 8"):
            _megakernel_pd_scan(model, params, phys, cmd, 1)
    assert fleet_kernel.active_partition() is None


def _ppo_argv(logdir):
    return ["ppo", "--device", "cpu", "--env_name", "PointMass-v0",
            "--num_procs", "8", "--num_steps", "32", "--max_traj_len", "4",
            "--minibatch_size", "8", "--n_itr", "2", "--input_norm_steps",
            "16", "--logdir", str(logdir)]


def _one_run_dir(logdir, n_envs):
    """The run dir: one, named by apex.py's hash of experiment.pkl, its
    checkpoint the whole fleet, loaded back by the port's loader."""
    (run_dir,) = (logdir / "PointMass-v0").iterdir()
    with open(run_dir / "experiment.pkl", "rb") as f:
        args = pickle.load(f)
    assert run_dir.name == f"{jax_log.args_hash(args)}-seed0"
    with open(run_dir / "checkpoint.pkl", "rb") as f:
        leaves = pickle.load(f)
    assert any(np.shape(x) == (n_envs, 4) for x in leaves)     # obs
    assert checkpoint.load_checkpoint(str(run_dir)).norm["mean"].shape == (4,)


@pytest.mark.parametrize("launcher", ["torchrun", "launch_local"])
def test_cli_trains_as_two_ranks(tmp_path, launcher):
    """`python -m apex_tpu_torch ppo` as two gloo ranks on the CPU, started
    by torchrun or by the CLI's own launcher (one rank per GPU on a host
    with several): exit 0 and one run directory."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    if launcher == "torchrun":
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", "2", "-m", "apex_tpu_torch",
               *_ppo_argv(tmp_path)]
    else:
        cmd = [sys.executable, "-c",
               "import sys; from apex_tpu_torch.parallel.multihost import "
               "launch_local; sys.exit(launch_local(sys.argv[1:], 2))",
               *_ppo_argv(tmp_path)]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "env fleet sharded over 2 ranks (gloo" in out.stdout
    _one_run_dir(tmp_path, 8)
