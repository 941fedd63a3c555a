"""Walker2d in the port against the JAX package on the CPU: the model
copy, the reset from the same draws, one fleet substep, three env steps
(the fleet step four times each, as `engine.step` under vmap), the FK's
plain version against the XLA FK and the Pallas kernel in interpret mode,
the checks of tests/test_walker2d.py, and a run of `python -m
apex_tpu_torch ppo --env_name Walker2d-v0` that the JAX package loads.

Fleets are drawn with numpy and handed to both sides. Tolerances are the
JAX package's between its own physics tiers (tests/test_fleet_parity.py):
kinematics to f32 rounding, velocity-level outputs loosely, because they
pass through (M + hD)^-1."""
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs.walker2d import Walker2dEnv as JaxWalker2dEnv
from apex_tpu.envs.walker2d import WalkerState as JaxWalkerState
from apex_tpu.physics import engine as jax_engine
from apex_tpu.physics import fleet as jax_fleet
from apex_tpu.physics.fleet_fk import pallas_fk
from apex_tpu.physics.models.walker2d import make_model as jax_make_model
from apex_tpu.runtime import log as jax_log
from apex_tpu.runtime.evaluate import load_experiment as jax_load_experiment
from apex_tpu_torch.__main__ import main as port_main
from apex_tpu_torch.envs.base import mirror_matrix
from apex_tpu_torch.envs.registry import env_factory
from apex_tpu_torch.envs.walker2d import (
    Walker2dEnv,
    WalkerResetNoise,
    WalkerState,
    walker_model,
)
from apex_tpu_torch.physics import fleet, fleet_fk
from apex_tpu_torch.physics.models.walker2d import make_model

B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: torch's
    default of one thread per core in each of them oversubscribes the
    CPU, and these many small tensors gain nothing from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fleet(seed, drop=0.06):
    """A Walker2d fleet around qpos0 (angles and slides N(0, 0.05^2),
    velocities N(0, 0.5^2)), the odd envs lowered by `drop` so that their
    feet start in the floor, and controls N(0, 0.5^2) (some beyond the
    clamp), batch-last numpy."""
    m = walker_model()
    rng = np.random.default_rng(seed)
    qpos = m.qpos0[:, None] + 0.05 * rng.normal(size=(m.nq, B))
    qpos[1, 1::2] -= drop
    return {k: np.asarray(v, np.float32) for k, v in dict(
        qpos=qpos, qvel=0.5 * rng.normal(size=(m.nv, B)),
        ctrl=0.5 * rng.normal(size=(m.nu, B))).items()}


def test_model_copy_equals_the_jax_model():
    ours, theirs = make_model(), jax_make_model()
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
            assert len(a) == len(b), f.name
            for x, y in zip(a, b):
                for g in dataclasses.fields(y):
                    np.testing.assert_array_equal(
                        getattr(x, g.name), getattr(y, g.name),
                        err_msg=f"{f.name}.{g.name}")
        else:
            assert a == b, f.name


def test_reset_matches_jax():
    """The JAX reset's own U(-1, 1) draws (its key splits repeated here)
    through the port's reset: qpos0 + 5e-3 u, 5e-3 u, and the obs."""
    jenv, env = JaxWalker2dEnv(), Walker2dEnv(device="cpu")
    m = env.model
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jst, jobs = jax.vmap(jenv.reset)(keys)
    u = [jax.vmap(lambda k, n=n: jax.random.uniform(
        jax.random.split(k)[i], (n,), minval=-1.0, maxval=1.0))(keys)
        for i, n in enumerate((m.nq, m.nv))]
    st, obs = env.reset(WalkerResetNoise(
        *(torch.tensor(np.asarray(x).T) for x in u)))
    np.testing.assert_allclose(st.qpos.numpy().T, np.asarray(jst.qpos),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st.qvel.numpy().T, np.asarray(jst.qvel),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=1e-6,
                               atol=1e-7)
    assert env.sample_step_noise(torch.Generator(), B) is None


_jax_fleet_step = jax.jit(lambda q, v, u: jax_fleet.fleet_step(
    JaxWalker2dEnv().model, jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.asarray(x)[..., None],
                                   jnp.shape(x) + (B,)),
        JaxWalker2dEnv().params), q, v, u))


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_step_matches_jax(seed):
    """One substep of the Walker2d fleet (half of it in contact) through
    the port's fleet step and the JAX fleet step, at
    tests/test_fleet_parity.py's per-step tolerances."""
    d = _fleet(seed)
    env = Walker2dEnv(device="cpu")
    dyn_j, con_j, qpos_j, qvel_j, qacc_j, tau_j = _jax_fleet_step(
        d["qpos"], d["qvel"], d["ctrl"])
    dyn, con, qpos, qvel, qacc, tau = fleet.fleet_step(
        env.model, env.params(B), torch.tensor(d["qpos"]),
        torch.tensor(d["qvel"]), torch.tensor(d["ctrl"]))
    assert float(np.max(np.asarray(con_j.force)[:, 2])) > 0

    close = lambda a, b, **tol: np.testing.assert_allclose(
        a.numpy(), np.asarray(b), **tol)
    close(dyn.kin.xpos, dyn_j.kin.xpos, rtol=1e-4, atol=1e-5)
    close(dyn.kin.cdof, dyn_j.kin.cdof, rtol=1e-4, atol=1e-5)
    close(dyn.M, dyn_j.M, rtol=1e-4, atol=1e-4)
    close(qpos, qpos_j, rtol=1e-4, atol=2e-5)
    close(qvel, qvel_j, rtol=5e-2, atol=2e-2)
    close(qacc, qacc_j, rtol=1e-1, atol=50.0)
    close(con.force, con_j.force, rtol=5e-2, atol=1.0)
    close(con.depth, con_j.depth, rtol=1e-4, atol=1e-6)
    close(con.pos, con_j.pos, rtol=1e-4, atol=1e-5)
    close(tau, tau_j, rtol=1e-5, atol=1e-6)


def test_env_steps_match_jax():
    """Three env steps (12 substeps) of `vmap(Walker2dEnv.step)` -- the JAX
    engine's fleet step under vmap -- and of the port's env from the same
    states and actions: the state at the per-substep tolerances of
    tests/test_fleet_parity.py, the reward to the same qpos tolerance
    over the step's 0.008 s, termination exactly."""
    d = _fleet(2, drop=0.04)
    jenv, env = JaxWalker2dEnv(), Walker2dEnv(device="cpu")
    acts = np.random.default_rng(3).normal(
        0.0, 0.7, size=(3, B, env.action_size)).astype(np.float32)
    jstep = jax.jit(jax.vmap(jenv.step))
    jst = JaxWalkerState(qpos=jnp.asarray(d["qpos"].T),
                         qvel=jnp.asarray(d["qvel"].T))
    st = WalkerState(torch.tensor(d["qpos"]), torch.tensor(d["qvel"]))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    for t in range(3):
        jst, jobs, jr, jterm, _ = jstep(jst, jnp.asarray(acts[t]), keys)
        st, obs, r, term = env.step(st, torch.tensor(acts[t]), None)
        np.testing.assert_allclose(st.qpos.numpy().T, np.asarray(jst.qpos),
                                   rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(st.qvel.numpy().T, np.asarray(jst.qvel),
                                   rtol=5e-2, atol=2e-2)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobs),
                                   rtol=5e-2, atol=2e-2)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-4,
                                   atol=2 * 2e-5 / 0.008)
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))


def test_vmapped_engine_step_is_the_fleet_step():
    """What the JAX env calls (`engine.step` under vmap) reroutes to the
    fleet step the port ports: the same numbers on a Walker2d fleet."""
    d = _fleet(4)
    jenv = JaxWalker2dEnv()
    out = jax.jit(jax.vmap(lambda q, v, u: jax_engine.step(
        jenv.model, jenv.params, q, v, u)))(d["qpos"].T, d["qvel"].T,
                                            d["ctrl"].T)
    _, _, qpos, qvel, _, _ = _jax_fleet_step(d["qpos"], d["qvel"],
                                             d["ctrl"])
    np.testing.assert_array_equal(np.asarray(out.qpos), np.asarray(qpos).T)
    np.testing.assert_array_equal(np.asarray(out.qvel), np.asarray(qvel).T)


def test_fk_plain_matches_jax_on_walker2d():
    """K2's plain version on Walker2d's model (slide, slide and hinge
    root, seven capsule bodies) against the XLA batch-last FK and the
    Pallas FK kernel in interpret mode, at tests/test_fleet_parity.py:
    203-213's tolerances."""
    m, jm = walker_model(), JaxWalker2dEnv().model
    rng = np.random.default_rng(11)
    qpos = (m.qpos0[:, None] + 0.05 * rng.normal(size=(m.nq, B))
            ).astype(np.float32)
    ipos = np.broadcast_to(m.body_ipos[:, :, None],
                           (m.nbody, 3, B)).astype(np.float32)
    got = fleet_fk.fleet_fk(m, torch.tensor(ipos), torch.tensor(qpos))
    xla = jax_fleet._fk_bt(jm, jnp.asarray(ipos), jnp.asarray(qpos))
    pal = pallas_fk(jm, jnp.asarray(ipos), jnp.asarray(qpos), block_b=B,
                    interpret=True)
    for name, g, x, p in zip(("xpos", "ximat", "xipos", "cdof", "origin"),
                             got, xla, pal):
        tol = dict(rtol=1e-6, atol=1e-7) if name == "origin" else dict(
            rtol=1e-5, atol=1e-6)
        for ref in (x, p):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref),
                                       err_msg=name, **tol)


# ---------------------------------------------------------------------------
# the checks of tests/test_walker2d.py on the port
# ---------------------------------------------------------------------------

def test_walker_reset_and_step():
    env = Walker2dEnv(device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    state, obs = env.reset(env.sample_reset_noise(gen, 1))
    assert obs.shape == (1, 17)
    for _ in range(5):
        state, obs, reward, term = env.step(
            state, torch.zeros(1, 6), env.sample_step_noise(gen, 1))
        assert torch.isfinite(reward).all()
        assert torch.isfinite(obs).all()
    # with zero torque the walker is still near standing after 5 * 4
    # substeps (0.04 s)
    assert 0.8 < float(state.qpos[1, 0]) < 1.5


def test_walker_mirror_involution():
    env = Walker2dEnv(device="cpu")
    for lst in (env.mirrored_obs, env.mirrored_acts):
        M = mirror_matrix(lst)
        np.testing.assert_allclose(M @ M, np.eye(len(lst)), atol=1e-6)
    assert env.clock_inds is None


def test_walker_total_mass_reasonable():
    m = make_model()
    assert 5.0 < float(np.sum(m.body_mass)) < 100.0
    assert m.nq == 9 and m.nv == 9 and m.nu == 6


def test_nonfinite_state_terminates():
    """NaN evades the range checks; the isfinite guard must fire and the
    reward stay finite."""
    env = Walker2dEnv(device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    st, _ = env.reset(env.sample_reset_noise(gen, 2))
    st.qpos[3, 0] = float("nan")
    _, _, reward, terminated = env.step(st, torch.zeros(2, 6), None)
    assert terminated.tolist() == [True, False]
    assert torch.isfinite(reward).all()


def test_registry_and_ppo_cli_on_walker2d(tmp_path):
    """All three registered names build the env and ignore the Cassie
    settings; `python -m apex_tpu_torch ppo --env_name Walker2d-v0` (CPU,
    4 envs, one iteration) names its run directory by JAX's hash of its
    arguments, and the JAX package's load_experiment restores it."""
    for name in ("Walker2d-v0", "walker2d-v2", "walker2d"):
        env = env_factory(name, device="cpu", simrate=60, reward="clock")
        assert isinstance(env, Walker2dEnv)
    rc = port_main(["ppo", "--device", "cpu", "--env_name", "Walker2d-v0",
                    "--mirror", "--num_procs", "4", "--num_steps", "16",
                    "--max_traj_len", "4", "--minibatch_size", "8",
                    "--n_itr", "1", "--input_norm_steps", "8", "--logdir",
                    str(tmp_path)])
    assert rc == 0
    (run_dir,) = (tmp_path / "Walker2d-v0").iterdir()
    with open(run_dir / "experiment.pkl", "rb") as f:
        args = pickle.load(f)
    assert run_dir.name == f"{jax_log.args_hash(args)}-seed0"
    ppo, jstate, _ = jax_load_experiment(str(run_dir))
    assert isinstance(ppo.env, JaxWalker2dEnv)
    assert jstate.runner.env_state.qpos.shape == (4, 9)
