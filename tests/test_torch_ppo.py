"""The port's training path against the JAX package on the CPU: returns
and advantages, the PPO losses with the mirror term, one optimiser step
against optax, the update half of a training iteration, checkpoints in
both directions and the run directory of `python -m apex_tpu_torch ppo`;
then learning on PointMass-v0 and a short stability run on Cassie-v0.

jax.random and torch draw different numbers, so the parity tests hand both
sides the same numpy-drawn inputs and the JAX-initialised weights
(`runtime.checkpoint.from_jax_leaves`); only the learning runs use the
port's own random draws.
"""
import argparse
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.agents import ppo as jax_ppo
from apex_tpu.agents.rollout import Rollout as JaxRollout
from apex_tpu.envs.base import PointMassEnv as JaxPointMassEnv
from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.models import FFV as JaxFFV
from apex_tpu.models import GaussianFFActor as JaxActor
from apex_tpu.models import NormState as JaxNormState
from apex_tpu.ops.gae import discounted_returns as jax_returns
from apex_tpu.ops.gae import gae_advantages as jax_gae
from apex_tpu.runtime import log as jax_log
from apex_tpu.runtime.checkpoint import load_checkpoint as jax_load_ckpt
from apex_tpu.runtime.evaluate import load_experiment as jax_load_experiment
from apex_tpu_torch.__main__ import main as port_main
from apex_tpu_torch.agents.ppo import ClippedAdam, PPO, PPOConfig, set_lr
from apex_tpu_torch.agents.rollout import Rollout
from apex_tpu_torch.envs.base import PointMassEnv
from apex_tpu_torch.envs.cassie import CassieEnv
from apex_tpu_torch.models.nets import FFV, GaussianFFActor, normc_init
from apex_tpu_torch.ops.gae import discounted_returns, gae_advantages
from apex_tpu_torch.runtime import checkpoint, log
from apex_tpu_torch.runtime.evaluate import load_experiment


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run side by side in several worker processes: torch's
    default of one thread per core in each of them oversubscribes the CPU
    (test_ppo_learns_pointmass took 493 s beside the other files, 20 s on
    one thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


T_, B_ = 7, 5


def _masks(rng, T, B):
    term = rng.random((T, B)) < 0.15
    trunc = (rng.random((T, B)) < 0.15) & ~term
    trunc[-1] = ~term[-1]                      # the rollout end
    return term, trunc


@pytest.mark.parametrize("use_gae", [False, True])
def test_returns_and_advantages_match_jax(use_gae):
    """Reverse loops against the JAX reverse scans, with terminations and
    truncations inside the rollout (f32 rounding of a 7-step sum)."""
    rng = np.random.default_rng(0)
    r, v, nv = (rng.standard_normal((T_, B_)).astype(np.float32)
                for _ in range(3))
    term, trunc = _masks(rng, T_, B_)
    t = lambda x: torch.tensor(x)
    if use_gae:
        got = gae_advantages(t(r), t(v), t(nv), t(term), t(trunc), 0.99, 0.95)
        ref = jax_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(nv),
                      jnp.asarray(term), jnp.asarray(trunc), 0.99, 0.95)
    else:
        got = (discounted_returns(t(r), t(term), t(trunc), t(nv), 0.99),)
        ref = (jax_returns(jnp.asarray(r), jnp.asarray(term),
                           jnp.asarray(trunc), jnp.asarray(nv), 0.99),)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_initialisers_follow_the_jax_package():
    """normc columns have the given norm; the mean head is scaled by 0.01;
    the std head exists only when learned; biases start at zero."""
    gen = torch.Generator()
    gen.manual_seed(0)
    w = normc_init(gen, 50, 7, scale=0.5)
    np.testing.assert_allclose(torch.linalg.norm(w, dim=0).numpy(), 0.5,
                               rtol=1e-6)
    actor = GaussianFFActor.init(gen, 50, 10, fixed_std=None)
    norms = lambda layer: torch.linalg.norm(layer.weight, dim=1).detach()
    np.testing.assert_allclose(norms(actor.layers[0]).numpy(), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(norms(actor.mean).numpy(), 0.01, rtol=1e-6)
    np.testing.assert_allclose(norms(actor.log_std).numpy(), 1.0, rtol=1e-6)
    assert all(float(p.detach().abs().max()) == 0.0 for n, p in
               actor.named_parameters() if n.endswith("bias"))
    assert GaussianFFActor.init(gen, 50, 10, fixed_std=0.2).log_std is None
    critic = FFV.init(gen, 50)
    np.testing.assert_allclose(norms(critic.out).numpy(), 1.0, rtol=1e-6)
    # the JAX initialiser's (in, out) leaves have these modules' shapes
    for learned in (False, True):
        ours = GaussianFFActor.init(gen, 50, 10,
                                    fixed_std=None if learned else 0.2)
        leaves = jax.tree_util.tree_leaves(JaxActor.init(
            jax.random.PRNGKey(0), 50, 10,
            fixed_std=None if learned else 0.2).params)
        assert [np.shape(x) for x in leaves] == [
            tuple(p.T.shape if tr else p.shape)
            for p, tr in checkpoint._jax_params(ours)]


# ---------------------------------------------------------------------------
# the update math on the same weights
# ---------------------------------------------------------------------------

def _nets(obs_dim, act_dim, seed, learn_std=False):
    """JAX actor, critic and normalizer from PRNGKey(seed), and the port's
    modules loaded with the same weights."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    actor = JaxActor.init(k1, obs_dim, act_dim,
                          fixed_std=None if learn_std else float(np.exp(-1.5)))
    critic = JaxFFV.init(k2, obs_dim)
    norm = JaxNormState(
        mean=jnp.asarray(rng.standard_normal(obs_dim), jnp.float32),
        var=jnp.asarray(rng.uniform(0.5, 2.0, obs_dim), jnp.float32),
        count=jnp.asarray(100.0))
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(
        (actor, critic, norm))]
    sd = checkpoint.from_jax_leaves(leaves, learn_stddev=learn_std)
    return (actor, critic, norm), sd


def _port_state(ppo, sd):
    state = ppo.init(seed=0)
    state.actor.load_state_dict(sd.actor)
    state.critic.load_state_dict(sd.critic)
    state.norm.load_state_dict(sd.norm)
    return state


def _batch(rng, n, obs_dim, act_dim):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    obs, act = f(n, obs_dim), 0.3 * f(n, act_dim)
    ret, adv, old_lp = f(n), f(n), f(n) - 5.0
    old_mean, old_std = 0.1 * f(n, act_dim), np.full((n, act_dim), 0.22,
                                                     np.float32)
    return obs, act, ret, adv, old_lp, old_mean, old_std


@pytest.fixture(scope="module")
def cassie_envs():
    return JaxCassieEnv(), CassieEnv(device="cpu")


@pytest.mark.parametrize("anneal", [1.0, 0.8])
def test_policy_losses_match_jax(cassie_envs, anneal):
    """Clipped surrogate, entropy, ratio and the mirror loss (Cassie's
    mirror tables and clock) on the same weights and batch: f32 rounding
    of 256-wide MLPs."""
    jenv, penv = cassie_envs
    cfg = PPOConfig(num_envs=2, entropy_coeff=0.01)
    (ja, _, jn), sd = _nets(50, 10, seed=1)
    ppo = PPO(penv, cfg)
    state = _port_state(ppo, sd)
    obs, act, _, adv, old_lp, _, _ = _batch(np.random.default_rng(1), 64, 50,
                                            10)
    jppo = jax_ppo.PPO(jenv, jax_ppo.PPOConfig(num_envs=2,
                                               entropy_coeff=0.01))
    jt, jaux = jppo._policy_losses(ja, jn, jnp.asarray(obs), jnp.asarray(act),
                                   jnp.asarray(adv), jnp.asarray(old_lp),
                                   anneal)
    t = torch.tensor
    with torch.no_grad():
        pt, paux = ppo._policy_losses(state.actor, state.norm, t(obs), t(act),
                                      t(adv), t(old_lp), anneal)
    np.testing.assert_allclose(float(pt), float(jt), rtol=1e-5, atol=1e-7)
    for k in ("actor_loss", "mirror_loss", "entropy", "ratio", "mean", "std"):
        np.testing.assert_allclose(paux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(paux["mirror_loss"]) > 0


@pytest.mark.parametrize("max_grad_norm", [0.05, 1e3])
def test_minibatch_update_matches_optax(cassie_envs, max_grad_norm):
    """Two `_minibatch_update`s on the same weights and minibatches: the
    actor's gradients (1e-4 relative, 1e-6 of the largest entry), the
    metrics, then the new parameters and Adam moments against optax
    (`_assert_train_leaves_close`). max_grad_norm 0.05 clips (the
    gradient norm of this batch is ~1), 1e3 does not."""
    jenv, penv = cassie_envs
    cfg = dict(num_envs=2, max_grad_norm=max_grad_norm, lr=3e-4)
    (ja, jc, jn), sd = _nets(50, 10, seed=2)
    ppo = PPO(penv, PPOConfig(**cfg))
    state = _port_state(ppo, sd)
    jppo = jax_ppo.PPO(jenv, jax_ppo.PPOConfig(**cfg))
    carry = (ja, jc, jppo.actor_tx.init(ja.params),
             jppo.critic_tx.init(jc.params), jnp.asarray(False))
    rng = np.random.default_rng(2)
    t = torch.tensor

    # gradients of the actor's loss on the first batch
    b = _batch(rng, 128, 50, 10)
    total, _ = ppo._policy_losses(state.actor, state.norm, t(b[0]), t(b[1]),
                                  t(b[3]), t(b[4]), 1.0)
    pg = torch.autograd.grad(total, state.actor_opt.params)
    jg = jax.grad(lambda p: jppo._policy_losses(
        ja.replace(params=p), jn, *(jnp.asarray(x) for x in
                                    (b[0], b[1], b[3], b[4])), 1.0)[0])(
        ja.params)
    jg_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)]
    pg_jax_order = [g for p, tr in checkpoint._jax_params(state.actor)
                    for g in [pg[[id(q) for q in state.actor_opt.params]
                                 .index(id(p))]]]
    for a, (p, tr), r in zip(pg_jax_order, checkpoint._jax_params(
            state.actor), jg_leaves):
        a = a.numpy().T if tr else a.numpy()
        np.testing.assert_allclose(a, r, rtol=1e-4,
                                   atol=1e-6 * np.abs(r).max())
    assert np.sqrt(sum(np.sum(g * g) for g in jg_leaves)) > 0.05

    for batch in (b, _batch(rng, 128, 50, 10)):
        jb = tuple(jnp.asarray(x) for x in batch)
        carry, jm = jppo._minibatch_update(carry, jb, jn, 1.0)
        pm = ppo._minibatch_update(state, [t(x) for x in batch], 1.0)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-7)
    _assert_train_leaves_close(
        checkpoint.to_jax_leaves(state, penv)[:15 + 2 * 17],
        jax.tree_util.tree_leaves((carry[0], carry[1], jn, carry[2],
                                   carry[3])), lr=3e-4, steps=2)


def _assert_train_leaves_close(ours, ref, lr, steps):
    """The leaves of (actor, critic, norm, actor_opt, critic_opt) for an
    actor (6 leaves) and critic (6) of fixed std, after `steps` optimiser
    steps on gradients that the two stacks round differently (~1e-6 of
    the largest gradient entry). Adam divides each gradient entry by its
    own magnitude plus eps, so an entry of order eps carries its rounding
    into a step of size ~lr: parameters within 1e-6 relative plus 2e-3 of
    lr per step; Adam moments within 1e-3 relative plus 1e-5 of the
    leaf's largest entry; the normalizer, counts and hyperparameters
    exactly. With the same gradients the optimisers agree to 1e-6
    (test_clipped_adam_matches_optax)."""
    params = set(range(12))
    moments = set(range(20, 32)) | set(range(37, 49))
    assert len(ours) == len(ref) == 15 + 2 * 17
    for i, (a, r) in enumerate(zip(ours, ref)):
        r = np.asarray(r)
        assert a.shape == r.shape and a.dtype == r.dtype, i
        err = np.abs(a - r)
        if i in params:
            bad = err > 1e-6 * np.abs(r) + 2e-3 * lr * steps
        elif i in moments:
            bad = err > 1e-3 * np.abs(r) + 1e-5 * np.abs(r).max()
        else:
            bad = err > 0
        assert not bad.any(), f"leaf {i}: max err {err.max()}"


@pytest.mark.parametrize("max_grad_norm", [0.05, 1e3])
def test_clipped_adam_matches_optax(max_grad_norm):
    """`ClippedAdam` against the JAX package's optimiser
    (inject_hyperparams(clip_by_global_norm + adam)) on the same
    parameters and the same gradients for three steps: parameters and
    moments within 1e-6 relative (1e-9 absolute for entries near zero).
    The gradient norm is ~8: max_grad_norm 0.05 clips, 1e3 does not."""
    rng = np.random.default_rng(4)
    shapes = [(7,), (5, 7), (3,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-7, 0, s))
              .astype(np.float32) for s in shapes] for _ in range(3)]
    cfg = jax_ppo.PPOConfig(max_grad_norm=max_grad_norm, lr=3e-4)
    tx = jax_ppo.PPO(JaxPointMassEnv(), cfg).actor_tx
    jp = [jnp.asarray(x) for x in p0]
    jstate = tx.init(jp)
    ours = [torch.tensor(x) for x in p0]
    opt = ClippedAdam(ours, cfg.lr, max_grad_norm, cfg.eps)
    for g in grads:
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(x) for x in g])
    adam = jstate.inner_state[1][0]
    assert int(adam.count) == opt.count == 3
    for a, r in zip(ours + opt.mu + opt.nu, jp + list(adam.mu)
                    + list(adam.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-9)


def _traj(rng, T, B, obs_dim, act_dim):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    term, trunc = _masks(rng, T, B)
    done = term | trunc
    lens = np.where(done, rng.integers(1, 50, (T, B)), 0).astype(np.int32)
    return dict(obs=f(T, B, obs_dim), action=0.3 * f(T, B, act_dim),
                reward=f(T, B), terminated=term, truncated=trunc,
                next_obs=f(T, B, obs_dim),
                done_ep_return=np.where(done, f(T, B), 0).astype(np.float32),
                done_ep_len=lens)


@pytest.mark.parametrize("kl_max,use_gae", [(0.02, False), (0.0, True)])
def test_update_half_of_the_iteration_matches_jax(monkeypatch, kl_max,
                                                  use_gae):
    """`_update` given the JAX iteration's rollout and its epoch
    permutations: metrics and parameters after 3 epochs of 4 minibatches
    on PointMass-v0 (mirror loss on). kl_max 0 stops after the first
    epoch, exercising the skip."""
    T, B = 8, 16
    cfg = dict(num_envs=B, num_steps=T * B, minibatch_size=32, epochs=3,
               kl_max=kl_max, use_gae=use_gae, lr=3e-4)
    (ja, jc, jn), sd = _nets(4, 2, seed=3)
    penv = PointMassEnv(device="cpu")
    ppo = PPO(penv, PPOConfig(**cfg))
    state = _port_state(ppo, sd)
    traj = _traj(np.random.default_rng(3), T, B, 4, 2)
    jtraj = JaxRollout(**{k: jnp.asarray(v) for k, v in traj.items()})
    monkeypatch.setattr(jax_ppo, "rollout_scan",
                        lambda env, fn, runner, n, L: (runner, jtraj))
    jppo = jax_ppo.PPO(JaxPointMassEnv(), jax_ppo.PPOConfig(**cfg))
    jstate = jax_ppo.PPOTrainState(
        actor=ja, critic=jc, norm=jn,
        actor_opt=jppo.actor_tx.init(ja.params),
        critic_opt=jppo.critic_tx.init(jc.params), runner=None,
        rng=jax.random.PRNGKey(9))
    jnew, jm = jppo._train_iteration(jstate, jnp.asarray(1.0))
    _, k_perm = jax.random.split(jstate.rng)
    perms = [torch.tensor(np.asarray(jax.random.permutation(k, T * B)))
             for k in jax.random.split(k_perm, 3)]

    pm = ppo._update(state, Rollout(**{k: torch.tensor(v)
                                       for k, v in traj.items()}), 1.0,
                     perms)
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    if kl_max == 0.0:
        assert state.actor_opt.count == 4       # one epoch, then the stop
    else:
        assert state.actor_opt.count == 12
    _assert_train_leaves_close(
        checkpoint.to_jax_leaves(state, penv)[:15 + 2 * 17],
        jax.tree_util.tree_leaves((jnew.actor, jnew.critic, jnew.norm,
                                   jnew.actor_opt, jnew.critic_opt)),
        lr=3e-4, steps=state.actor_opt.count)


def test_set_lr_changes_the_step():
    gen = torch.Generator()
    gen.manual_seed(0)
    ppo = PPO(PointMassEnv(device="cpu"), PPOConfig(num_envs=4))
    opt = ppo.init(0).actor_opt
    set_lr(opt, 0.0)
    before = [p.clone() for p in opt.params]
    opt.step([torch.ones_like(p) for p in opt.params])
    assert all(torch.equal(a, b) for a, b in zip(before, opt.params))
    assert opt.count == 1


# ---------------------------------------------------------------------------
# checkpoints and run directories
# ---------------------------------------------------------------------------

def test_checkpoint_round_trips_through_the_jax_loader(tmp_path):
    """A PointMass train state after one iteration, written by the port,
    restores into a JAX template leaf for leaf; the port reads it back."""
    cfg = dict(num_envs=8, num_steps=32, max_traj_len=10, minibatch_size=16)
    penv = PointMassEnv(device="cpu")
    ppo = PPO(penv, PPOConfig(**cfg))
    state = ppo.prenormalize(ppo.init(seed=3), steps=16)
    state, _ = ppo._train_iteration(state, 1.0)
    checkpoint.save_checkpoint(str(tmp_path), state, penv)
    template = jax_ppo.PPO(JaxPointMassEnv(),
                           jax_ppo.PPOConfig(**cfg)).init(seed=0)
    restored = jax_load_ckpt(str(tmp_path), template)
    ours = checkpoint.to_jax_leaves(state, penv)
    theirs = jax.tree_util.tree_leaves(restored)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(restored.actor_opt.count) == state.actor_opt.count > 0
    back = checkpoint.load_checkpoint(str(tmp_path))
    torch.testing.assert_close(back.actor["mean.weight"],
                               state.actor.mean.weight.detach())
    torch.testing.assert_close(back.norm["var"], state.norm.var)


def test_cli_run_dir_loads_in_both_packages(tmp_path):
    """`python -m apex_tpu_torch ppo` on Cassie-v0 (CPU, 2 envs, 1
    iteration) writes a run directory that the JAX package's
    load_experiment restores (the leaf list of a JAX train state of the
    same configuration) and the port's evaluation loads; the run dir is
    named by the same argument hash as the JAX package's."""
    rc = port_main([
        "ppo", "--device", "cpu", "--env_name", "Cassie-v0", "--dyn_random",
        "--mirror", "--num_procs", "2", "--num_steps", "4",
        "--max_traj_len", "2", "--n_itr", "1", "--input_norm_steps", "2",
        "--logdir", str(tmp_path)])
    assert rc == 0
    (run_dir,) = (tmp_path / "Cassie-v0").iterdir()
    with open(run_dir / "experiment.pkl", "rb") as f:
        args = pickle.load(f)
    assert run_dir.name == f"{jax_log.args_hash(args)}-seed0"
    assert log.args_hash(args) == jax_log.args_hash(args)
    _, jstate, _ = jax_load_experiment(str(run_dir))
    exp = load_experiment(str(run_dir), device="cpu")
    np.testing.assert_array_equal(
        exp.actor.layers[0].weight.detach().numpy().T,
        np.asarray(jstate.actor.params["layers"][0]["w"]))
    np.testing.assert_array_equal(exp.norm.mean.numpy(),
                                  np.asarray(jstate.norm.mean))
    assert jstate.runner.env_state.phys.qpos.shape == (2, 35)
    scalars = (run_dir / "scalars.csv").read_text().splitlines()
    assert any(s.startswith("Test/Return,0,") for s in scalars)
    # a continuation from this run dir inherits its env keys as JAX's does
    # (tests/test_torch_recurrent.py::test_parse_previous_matches_jax)
    ns = lambda: argparse.Namespace(previous=str(run_dir),
                                    env_name="PointMass-v0", mirror=False,
                                    exchange_reward=None)
    cont = log.parse_previous(ns())
    assert (cont.env_name, cont.mirror) == ("Cassie-v0", True)
    assert vars(cont) == vars(jax_log.parse_previous(ns()))


# ---------------------------------------------------------------------------
# learning
# ---------------------------------------------------------------------------

def test_ppo_learns_pointmass():
    """PPO on PointMass-v0 at the verify skill's size (128 envs, 4096
    steps per iteration, max_traj_len 100, minibatch 512, 25 iterations).
    Holding still earns ~46 (exp(-|cmd|) per step); the JAX package's PPO
    at this size climbs from 49.3 to 56.1, mean of the last 5 iterations
    55.2 (scripts/reference_pointmass_ppo.py on the CPU). The port's
    deterministic eval return must climb by more than 3 and end above 52
    (of ~93 at most)."""
    env = PointMassEnv(device="cpu")
    cfg = PPOConfig(num_envs=128, num_steps=4096, max_traj_len=100,
                    minibatch_size=512)
    ppo = PPO(env, cfg)
    state = ppo.prenormalize(ppo.init(seed=0), steps=2000)
    rets = []
    for itr in range(25):
        state, _ = ppo._train_iteration(state, 1.0)
        gen = torch.Generator()
        gen.manual_seed(itr)
        rets.append(float(ppo._evaluate(state, gen)["ep_return"]))
    assert np.mean(rets[-5:]) > np.mean(rets[:5]) + 3.0, rets
    assert np.mean(rets[-5:]) > 52.0, rets


def test_ppo_cassie_stable_and_sane():
    """PPO on Cassie-v0 (dyn-rand, firmware estimator, early_clock) at a
    tiny fleet, as tests/test_learning_smoke.py::
    test_ppo_cassie_stable_and_sane does for JAX: rewards finite and not
    collapsing, KL bounded, mirror loss active (CPU batches this small
    cannot show the reward rising). Each iteration runs 4 envs through one
    whole 8-step episode, so that iterations see the same phases of an
    episode (measured reward per step 0.24-0.30 over two seeds)."""
    env = CassieEnv(device="cpu")
    cfg = PPOConfig(num_envs=4, num_steps=32, max_traj_len=8,
                    minibatch_size=16, epochs=3, lr=2e-4)
    ppo = PPO(env, cfg)
    state = ppo.prenormalize(ppo.init(seed=0), steps=16)
    rps, kls, mirror = [], [], []
    for _ in range(6):
        state, m = ppo._train_iteration(state, 1.0)
        rps.append(float(m["reward_per_step"]))
        kls.append(float(m["kl"]))
        mirror.append(float(m["mirror_loss"]))
    assert np.all(np.isfinite(rps)), "non-finite rewards"
    assert np.mean(rps[-3:]) > np.mean(rps[:3]) - 0.03, rps
    assert max(kls) < 0.5, kls
    assert all(x > 0 for x in mirror), mirror
