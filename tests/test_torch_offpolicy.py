"""The port's off-policy learners and ARS against the JAX package on the
CPU: the four nets (forward and initialisers), Adam without the clip
against optax.adam, the replay ring, one TD3 and one DDPG iteration's
updates from the JAX package's own draws, parameter noise and the async
noise spread, one ARS iteration from JAX's own directions and returns,
checkpoints that the JAX package loads, and learning on PointMass-v0.

jax.random and torch draw different numbers, so the parity tests carry
the JAX-initialised weights across from JAX's numpy leaves and feed the
port's update the replay ring, the sample indices and the noise that the
JAX iteration drew (its key splits repeated here); only the learning runs
use the port's own draws.
"""
import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apex_tpu.agents import ars as jax_ars
from apex_tpu.agents import dpg as jax_dpg
from apex_tpu.agents import td3 as jax_td3
from apex_tpu.agents.replay import ReplayBuffer as JaxReplayBuffer
from apex_tpu.envs.base import PointMassEnv as JaxPointMassEnv
from apex_tpu.models import nets as jax_nets
from apex_tpu.runtime.checkpoint import load_checkpoint as jax_load_ckpt
from apex_tpu_torch.agents import ars, dpg, td3
from apex_tpu_torch.agents.ppo import ClippedAdam
from apex_tpu_torch.agents.replay import ReplayBuffer
from apex_tpu_torch.envs.base import PointMassEnv
from apex_tpu_torch.models.nets import (
    FFQ,
    DualQCritic,
    FFActor,
    LinearActor,
    NormState,
)
from apex_tpu_torch.runtime import checkpoint
from apex_tpu_torch.runtime.log import create_logger

OBS, ACT = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: torch's
    default of one thread per core in each of them oversubscribes the
    CPU, and these many small tensors gain nothing from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _load(net, params):
    """Carry a JAX net's params (numpy leaves, (in, out) weights) into the
    port's module."""
    leaves = jax.tree_util.tree_leaves(params)
    pairs = checkpoint._jax_params(net)
    assert len(pairs) == len(leaves)
    with torch.no_grad():
        for (p, tr), x in zip(pairs, leaves):
            x = np.asarray(x)
            p.copy_(torch.tensor(x.T if tr else x))


def _norm(rng, dim):
    """A normalizer with nonzero mean and var != 1 in both packages."""
    mean = rng.standard_normal(dim).astype(np.float32)
    var = rng.uniform(0.5, 2.0, dim).astype(np.float32)
    jn = jax_nets.NormState(mean=jnp.asarray(mean), var=jnp.asarray(var),
                            count=jnp.asarray(100.0))
    norm = NormState(dim)
    norm.mean.copy_(torch.tensor(mean))
    norm.var.copy_(torch.tensor(var))
    norm.count.fill_(100.0)
    return jn, norm


# ---------------------------------------------------------------------------
# the nets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["ffactor", "linear", "ffq", "dualq"])
def test_nets_forward_match_jax(which):
    """Each net's forward pass on JAX's weights and a numpy batch, with a
    normalizer that is not the identity: f32 rounding of 256-wide MLPs
    (1e-6). LinearActor gets random weights (its init is zero), also as a
    fleet of flat θ (`act_flat`, ravel_pytree's layout), one per row."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(1)
    obs = rng.standard_normal((32, 50)).astype(np.float32)
    act = rng.uniform(-1, 1, (32, 10)).astype(np.float32)
    jn, norm = _norm(rng, 50)
    t = torch.tensor
    # f32 rounding of a sum scales with its terms: 1e-6 of the largest
    # output in absolute terms
    close = lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), np.asarray(b), rtol=1e-6,
        atol=1e-6 * max(1.0, float(np.abs(np.asarray(b)).max())))
    gen = torch.Generator()
    if which == "ffactor":
        jnet = jax_nets.FFActor.init(key, 50, 10, max_action=0.7)
        net = FFActor.init(gen, 50, 10, max_action=0.7)
        _load(net, jnet.params)
        close(net.act(norm, t(obs)), jnet.act(jn, obs))
    elif which == "linear":
        jnet = jax_nets.LinearActor.init(50, 10, 8)
        flat, unravel = jax.flatten_util.ravel_pytree(jnet.params)
        thetas = rng.standard_normal((32, flat.shape[0])).astype(np.float32)
        net = LinearActor.init(gen, 50, 10, 8)
        assert LinearActor.flat_size(50, 10, 8) == flat.shape[0]
        jact = jax.vmap(lambda th, o: jax_nets.LinearActor(
            params=unravel(th)).act(jn, o))(thetas, obs)
        close(LinearActor.act_flat(t(thetas), norm, t(obs), 8), jact)
        _load(net, unravel(jnp.asarray(thetas[0])))
        close(net.act(norm, t(obs[:1])), jact[:1])
    elif which == "ffq":
        jnet = jax_nets.FFQ.init(key, 50, 10)
        net = FFQ.init(gen, 50, 10)
        _load(net, jnet.params)
        close(net.q(norm, t(obs), t(act)), jnet.q(jn, obs, act))
    else:
        jnet = jax_nets.DualQCritic.init(key, 50, 10)
        net = DualQCritic.init(gen, 50, 10)
        _load(net, jnet.params)
        for a, b in zip(net.q(norm, t(obs), t(act)), jnet.q(jn, obs, act)):
            close(a, b)
        close(net.q1(norm, t(obs), t(act)), jnet.q1(jn, obs, act))


def test_initialisers_follow_the_jax_package():
    """FFActor and FFQ: normc columns of norm 1, zero biases; DualQCritic:
    torch's default U(-k, k), k = 1/sqrt(in), weights and biases (mean
    and variance of the draws); LinearActor: zeros. The modules' shapes
    are those of the JAX initialisers' (in, out) leaves."""
    gen = torch.Generator()
    gen.manual_seed(0)
    norms = lambda layer: torch.linalg.norm(layer.weight, dim=1).detach()
    actor = FFActor.init(gen, 50, 10)
    for layer in (*actor.layers, actor.out):
        np.testing.assert_allclose(norms(layer).numpy(), 1.0, rtol=1e-6)
        assert float(layer.bias.detach().abs().max()) == 0.0
    q = FFQ.init(gen, 50, 10)
    for layer in (*q.layers, q.out):
        np.testing.assert_allclose(norms(layer).numpy(), 1.0, rtol=1e-6)
        assert float(layer.bias.detach().abs().max()) == 0.0
    dual = DualQCritic.init(gen, 50, 10)
    for branch in dual.branches:
        for layer in (*branch.layers, branch.out):
            k = 1.0 / np.sqrt(layer.in_features)
            w = layer.weight.detach().numpy().ravel()
            b = layer.bias.detach().numpy()
            assert np.abs(w).max() <= k and np.abs(b).max() <= k
            assert float(np.abs(b).min()) > 0.0
            if w.size > 1000:
                assert abs(w.mean()) < 0.02 * k
                assert abs(w.var() / (k * k / 3.0) - 1.0) < 0.02
    assert not torch.equal(dual.branches[0].out.weight,
                           dual.branches[1].out.weight)
    lin = LinearActor.init(gen, 50, 10, 32)
    assert all(float(p.detach().abs().max()) == 0.0
               for p in lin.parameters())
    key = jax.random.PRNGKey(0)
    for ours, theirs in (
            (actor, jax_nets.FFActor.init(key, 50, 10)),
            (q, jax_nets.FFQ.init(key, 50, 10)),
            (dual, jax_nets.DualQCritic.init(key, 50, 10)),
            (lin, jax_nets.LinearActor.init(50, 10, 32))):
        assert [np.shape(x) for x in jax.tree_util.tree_leaves(
            theirs.params)] == [tuple(p.T.shape if tr else p.shape)
                                for p, tr in checkpoint._jax_params(ours)]


def test_adam_without_clip_matches_optax():
    """`ClippedAdam` with max_grad_norm None against `optax.adam(lr)` (eps
    1e-8) for three steps on the same parameters and gradients, some of
    them below eps: parameters and moments within 1e-6 relative."""
    rng = np.random.default_rng(4)
    shapes = [(7,), (5, 7), (3,)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-9, 0, s))
              .astype(np.float32) for s in shapes] for _ in range(3)]
    tx = optax.adam(3e-4)
    jp = [jnp.asarray(x) for x in p0]
    jstate = tx.init(jp)
    ours = [torch.tensor(x) for x in p0]
    opt = ClippedAdam(ours, 3e-4, None, td3.ADAM_EPS)
    for g in grads:
        upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.tensor(x) for x in g])
    adam = jstate[0]
    assert int(adam.count) == opt.count == 3
    assert len(jax.tree_util.tree_leaves(jstate)) == 1 + 2 * len(shapes)
    for a, r in zip(ours + opt.mu + opt.nu,
                    jp + list(adam.mu) + list(adam.nu)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# the replay ring
# ---------------------------------------------------------------------------

def test_replay_ring_wraps_and_samples():
    """tests/test_agents.py's ring test on the port, then the JAX ring
    after the same adds, gathered at JAX's own sample indices."""
    buf = ReplayBuffer(16, 3, 2, torch.device("cpu"))
    jbuf = JaxReplayBuffer.create(16, 3, 2)
    obs = np.arange(30.0, dtype=np.float32).reshape(10, 3)
    act = np.zeros((10, 2), np.float32)
    r = np.arange(10.0, dtype=np.float32)
    t = torch.tensor
    for add in (0.0, 100.0):
        buf.add_batch(t(obs + add), t(act), t(r + add), t(obs - add),
                      t(np.ones(10, np.float32)))
        jbuf = jbuf.add_batch(obs + add, act, r + add, obs - add,
                              np.ones(10, np.float32))
        assert (buf.ptr, buf.size) == (int(jbuf.ptr), int(jbuf.size))
    assert (buf.size, buf.ptr) == (16, 4)
    gen = torch.Generator()
    o, a, rw, no, nd = buf.sample(gen, 8)
    assert o.shape == (8, 3) and rw.shape == (8,)
    key = jax.random.PRNGKey(0)
    idx = jax.random.randint(key, (8,), 0, jnp.maximum(jbuf.size, 1))
    for x, y in zip(buf.gather(torch.tensor(np.asarray(idx))),
                    jbuf.sample(key, 8)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# one iteration's updates from the JAX package's draws
# ---------------------------------------------------------------------------

def _ring_from_jax(replay, jreplay):
    for name in replay.FIELDS:
        getattr(replay, name).copy_(torch.tensor(np.asarray(
            getattr(jreplay, name))))
    replay.ptr, replay.size = int(jreplay.ptr), int(jreplay.size)


def _assert_leaves_close(ours, ref, what):
    """Parameters and Adam moments after the updates: 1e-5 relative, 1e-5
    of the leaf's largest entry absolute; counts exactly."""
    assert len(ours) == len(ref), what
    for i, (a, r) in enumerate(zip(ours, ref)):
        r = np.asarray(r)
        assert a.shape == r.shape, (what, i)
        if r.dtype.kind == "i":
            np.testing.assert_array_equal(a, r, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_allclose(
                a, r, rtol=1e-5, atol=1e-5 * max(np.abs(r).max(), 1e-30),
                err_msg=f"{what} leaf {i}")


TD3_CFG = dict(num_envs=4, collect_steps=8, batch_size=16, updates_per_iter=2,
               replay_size=256, max_traj_len=20, start_timesteps=32)


def test_td3_updates_match_jax():
    """The JAX package's unjitted `_train_iteration` on PointMass with two
    updates. The port's `_update` gets JAX's ring after its add, JAX's
    sample indices and target-policy noise (td3.py:145, 186, 239: the key
    splits repeated here) and the same initial nets; then the nets, the
    targets, the acting snapshot and both Adam states after a policy step
    (count 0) and a skipped one (count 1) match JAX's at 1e-5, the
    skipped step leaves the actor and the targets as they were, and the
    losses match."""
    jtd3 = jax_td3.TD3(JaxPointMassEnv(), jax_td3.TD3Config(**TD3_CFG))
    js = jtd3.init(seed=0)
    jnew, jm = jtd3._train_iteration(js, random_actions=False)
    _, _, _, k_updates = jax.random.split(js.rng, 4)
    draws = []
    for key in jax.random.split(k_updates, TD3_CFG["updates_per_iter"]):
        k_samp, k_noise = jax.random.split(key)
        idx = jax.random.randint(k_samp, (TD3_CFG["batch_size"],), 0,
                                 jnp.maximum(jnew.replay.size, 1))
        draws.append((torch.tensor(np.asarray(idx)), torch.tensor(
            np.asarray(jax.random.normal(k_noise, (TD3_CFG["batch_size"],
                                                   ACT))))))

    env = PointMassEnv(device="cpu")
    agent = td3.TD3(env, td3.TD3Config(**TD3_CFG))
    state = agent.init(seed=0)
    for net, jnet in ((state.actor, js.actor), (state.actor_target, js.actor),
                      (state.behavior, js.actor), (state.critic, js.critic),
                      (state.critic_target, js.critic)):
        _load(net, jnet.params)
    _ring_from_jax(state.replay, jnew.replay)

    losses, snaps = [], []
    for idx, noise in draws:
        losses.append(agent._update(state, state.replay.gather(idx), noise))
        snaps.append([p.detach().clone() for p in (
            *state.actor.parameters(), *state.actor_target.parameters(),
            *state.critic_target.parameters())])
    assert state.update_count == 2
    assert float(losses[1][1]) == 0.0
    assert all(torch.equal(a, b) for a, b in zip(*snaps))
    np.testing.assert_allclose(
        [float(torch.stack([c for c, _ in losses]).mean()),
         float(torch.stack([a for _, a in losses]).mean())],
        [float(jm["critic_loss"]), float(jm["actor_loss"])], rtol=1e-5)
    n = 18 + 24 + 3 + 13 + 25
    _assert_leaves_close(
        checkpoint.to_jax_leaves(state, env)[:n],
        jax.tree_util.tree_leaves(jnew)[:n], "td3")
    assert int(jnew.update_count) == state.update_count


def test_ddpg_updates_match_jax():
    """As the TD3 test, for DDPG's `_train_iteration_ff` (dpg.py:159-192)
    with three updates: every update steps the critic, then the actor on
    the updated critic, then both targets."""
    cfg = dict(num_envs=4, collect_steps=8, batch_size=16, updates_per_iter=3,
               replay_size=256, max_traj_len=20)
    jdpg = jax_dpg.DPG(JaxPointMassEnv(), jax_dpg.DPGConfig(**cfg))
    js = jdpg.init(seed=1)
    jnew, jm = jdpg._train_iteration_ff(js, random_actions=False)
    _, _, k_updates = jax.random.split(js.rng, 3)
    idxs = [torch.tensor(np.asarray(jax.random.randint(
        key, (cfg["batch_size"],), 0, jnp.maximum(jnew.replay.size, 1))))
        for key in jax.random.split(k_updates, cfg["updates_per_iter"])]

    env = PointMassEnv(device="cpu")
    agent = dpg.DPG(env, dpg.DPGConfig(**cfg))
    state = agent.init(seed=1)
    for net, jnet in ((state.actor, js.actor), (state.actor_target, js.actor),
                      (state.critic, js.critic),
                      (state.critic_target, js.critic)):
        _load(net, jnet.params)
    _ring_from_jax(state.replay, jnew.replay)
    losses = torch.stack([torch.stack(agent._update(
        state, state.replay.gather(idx))) for idx in idxs])
    np.testing.assert_allclose(
        losses.mean(0).numpy(),
        [float(jm["critic_loss"]), float(jm["actor_loss"])], rtol=1e-5)
    n = 24 + 3 + 13 + 13
    _assert_leaves_close(checkpoint.to_jax_leaves(state, env)[:n],
                         jax.tree_util.tree_leaves(jnew)[:n], "ddpg")
    # the recurrent configuration builds RDPG's nets and episode ring
    # (tests/test_torch_rdpg.py holds it to JAX)
    rstate = dpg.DPG(env, dpg.DPGConfig(recurrent=True, episode_capacity=4,
                                        max_traj_len=5)).init(0)
    assert type(rstate.actor).__name__ == "LSTMActor"
    assert rstate.replay.obs.shape == (4, 5, OBS)


def test_param_noise_and_async_noise_scales():
    """Async mode's per-env noise expl_noise * spread^(i/(B-1) - 0.5) and
    sync mode's constant one, as the JAX package's (f32); the parameter
    noise perturbs every weight of the acting snapshot, not the actor,
    and sigma moves by a factor 1.01 against the action distance (up
    when the perturbed actions stay within expl_noise of the plain ones,
    param_noise.py:10-48)."""
    env = PointMassEnv(device="cpu")
    for async_mode in (False, True):
        for B in (1, 5, 64):
            cfg = dict(num_envs=B, async_mode=async_mode, expl_noise=0.3,
                       noise_spread=3.0, replay_size=64)
            ours = td3.TD3(env, td3.TD3Config(**cfg)).noise_scales
            theirs = jax_td3.TD3(JaxPointMassEnv(),
                                 jax_td3.TD3Config(**cfg)).noise_scales
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))

    cfg = td3.TD3Config(num_envs=4, collect_steps=8, batch_size=16,
                        updates_per_iter=1, replay_size=256,
                        max_traj_len=50, param_noise=True)
    agent = td3.TD3(env, cfg)
    state = agent.init(seed=0)
    pert = agent._perturbed_actor(state)
    for p, b, a in zip(pert.parameters(), state.behavior.parameters(),
                       state.actor.parameters()):
        d = (p - b).flatten()
        assert bool((d != 0).all())
        if d.numel() > 1000:
            assert abs(float(d.std()) / 0.05 - 1.0) < 0.05
        assert torch.equal(a, b)
    sigmas = [float(state.param_noise_sigma)]
    for expl in (10.0, 1e-6):       # distance below, then above expl_noise
        agent.config = td3.TD3Config(**{**cfg.__dict__, "expl_noise": expl})
        state, _ = agent._train_iteration(state, random_actions=False)
        sigmas.append(float(state.param_noise_sigma))
    np.testing.assert_allclose(sigmas[1], np.float32(0.05) * np.float32(1.01),
                               rtol=1e-7)
    np.testing.assert_allclose(sigmas[2], sigmas[1] / np.float32(1.01),
                               rtol=1e-7)


@pytest.mark.parametrize("returns", ["rollout", "ties"])
def test_ars_iteration_matches_jax(returns):
    """θ and the v2 normalizer after one JAX `_iteration` on PointMass (8
    directions, top 3) against the port's `_update` fed JAX's own
    directions (its key split repeated here), candidate returns, steps
    and observations: ravel_pytree's layout, the ranking, the population
    std, the norm update, at 1e-6. "ties": JAX's returns rounded to 0.5,
    so that the ranking meets equal scores and must keep the stable
    order."""
    cfg = dict(deltas=8, deltas_used=3, step_size=0.1, delta_std=0.1,
               max_traj_len=12, hidden_size=5, algo="v2")
    jagent = jax_ars.ARS(JaxPointMassEnv(), jax_ars.ARSConfig(**cfg))
    rng = np.random.default_rng(5)
    jn, norm = _norm(rng, OBS)
    js = jagent.init(seed=2).replace(
        theta=jnp.asarray(0.1 * rng.standard_normal(jagent._dim),
                          jnp.float32), norm=jn)
    seen = {}
    rollout = jagent._rollout_batch

    def record(thetas, n, key):
        ret, steps, obs_seq = rollout(thetas, n, key)
        if returns == "ties":
            ret = jnp.round(ret * 2.0) / 2.0
        seen["out"] = (ret, steps, obs_seq)
        return seen["out"]

    jagent._rollout_batch = record
    jnew, jm = jagent._iteration(js)
    _, k_delta, _ = jax.random.split(js.rng, 3)
    deltas = jax.random.normal(k_delta, (cfg["deltas"], jagent._dim))
    ret, steps, obs_seq = seen["out"]
    if returns == "ties":
        scores = np.maximum(*np.split(np.asarray(ret), 2))
        assert len(np.unique(scores)) < len(scores)

    agent = ars.ARS(PointMassEnv(device="cpu"), ars.ARSConfig(**cfg))
    assert agent.dim == jagent._dim
    state = ars.ARSTrainState(theta=torch.tensor(np.asarray(js.theta)),
                              norm=norm, generator=torch.Generator(), seed=2,
                              total_steps=0)
    state, m = agent._update(state, torch.tensor(np.asarray(deltas)),
                             torch.tensor(np.asarray(ret)),
                             torch.tensor(np.asarray(steps)),
                             torch.tensor(np.asarray(obs_seq)))
    np.testing.assert_allclose(state.theta.numpy(), np.asarray(jnew.theta),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip((norm.mean, norm.var, norm.count),
                    (jnew.norm.mean, jnew.norm.var, jnew.norm.count)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    assert state.total_steps == int(jnew.total_steps)
    for k in ("mean_return", "max_return", "sigma_r"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    # the LSTM policy's θ is ravel_pytree's of JAX's GaussianLSTMActor
    # (tests/test_torch_recurrent.py holds its iteration to JAX)
    rcfg = dict(cfg, recurrent=True)
    assert ars.ARS(PointMassEnv(device="cpu"),
                   ars.ARSConfig(**rcfg)).dim == jax_ars.ARS(
        JaxPointMassEnv(), jax_ars.ARSConfig(**rcfg))._dim


def test_ars_rollout_keeps_dead_envs_stepping():
    """The fleet of 2·deltas candidates has no auto-reset: an env's return
    and steps stop at its termination, and it keeps stepping; every
    step's observation is kept, dead steps included. The first three
    candidates push with a constant action of 5 (clipped to 1 per axis),
    so PointMass's |v| passes 10 after ~142 of the 200 steps; the others
    (θ = 0) hold still."""
    h, T = 4, 200
    agent = ars.ARS(PointMassEnv(device="cpu"),
                    ars.ARSConfig(deltas=3, max_traj_len=T, hidden_size=h))
    gen = torch.Generator()
    gen.manual_seed(0)
    thetas = torch.zeros(6, agent.dim)
    b2 = h * (OBS + 1)                   # l1.b, l1.w, then l2.b
    thetas[:3, b2:b2 + ACT] = 5.0
    ret, steps, obs_seq = agent._rollout_batch(thetas, NormState(OBS), gen)
    assert obs_seq.shape == (T, 6, OBS)
    assert bool((steps[:3] > 100).all() & (steps[:3] < T).all())
    assert bool((steps[3:] == T).all())
    speed = torch.linalg.norm(obs_seq[:, :3, :2], dim=-1)   # obs = [vel, cmd]
    assert bool((speed[-1] > speed[steps[:3].long(), torch.arange(3)]).all())
    assert bool(torch.isfinite(ret).all())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ["td3", "ddpg", "ars"])
def test_run_dir_loads_in_the_jax_package(tmp_path, algo):
    """A port run on PointMass (CPU, one iteration, a small ring) writes a
    run directory whose checkpoint restores into a JAX template of the
    same configuration (`init(0)`), leaf for leaf; the restored actor
    gives the port's deterministic action on fixed observations (1e-6),
    and JAX's own evaluation runs on it."""
    env = PointMassEnv(device="cpu")
    logger = create_logger({"env_name": "PointMass-v0", "seed": 0,
                            "logdir": str(tmp_path), "algo": algo})
    save = lambda st: checkpoint.save_checkpoint(logger.dir, st, env)
    obs = np.random.default_rng(6).standard_normal((5, OBS)).astype(
        np.float32)
    if algo == "ars":
        cfg = dict(deltas=4, deltas_used=2, max_traj_len=10, hidden_size=3,
                   algo="v2")
        agent = ars.ARS(env, ars.ARSConfig(**cfg))
        state = agent.train(agent.init(0), n_itr=1, logger=logger,
                            save_fn=save, verbose=False)
        jagent = jax_ars.ARS(JaxPointMassEnv(), jax_ars.ARSConfig(**cfg))
        restored = jax_load_ckpt(logger.dir, jagent.init(0))
        ours = LinearActor.act_flat(state.theta[None].expand(5, -1),
                                    state.norm, torch.tensor(obs), 3)
        theirs = jax_nets.LinearActor(params=jax.flatten_util.ravel_pytree(
            jax_nets.LinearActor.init(OBS, ACT, 3).params)[1](
                restored.theta)).act(restored.norm, obs)
    else:
        cfg = dict(num_envs=4, collect_steps=8, batch_size=16,
                   updates_per_iter=4, replay_size=64, max_traj_len=10,
                   start_timesteps=0)
        mod, jmod = (td3, jax_td3) if algo == "td3" else (dpg, jax_dpg)
        conf = "TD3Config" if algo == "td3" else "DPGConfig"
        cls = "TD3" if algo == "td3" else "DPG"
        agent = getattr(mod, cls)(env, getattr(mod, conf)(**cfg))
        state = agent.train(agent.init(0), max_timesteps=32, logger=logger,
                            save_fn=save, verbose=False)
        jagent = getattr(jmod, cls)(JaxPointMassEnv(),
                                    getattr(jmod, conf)(**cfg))
        restored = jax_load_ckpt(logger.dir, jagent.init(0))
        with torch.no_grad():
            ours = state.actor.act(state.norm, torch.tensor(obs))
        theirs = restored.actor.act(restored.norm, obs)
        ev = jagent._evaluate(restored, jax.random.PRNGKey(0))
        assert np.isfinite(float(ev["ep_return"]))
        assert int(restored.replay.size) == state.replay.size == 32
    leaves = checkpoint.to_jax_leaves(state, env)
    r_leaves = jax.tree_util.tree_leaves(restored)
    assert len(leaves) == len(r_leaves)
    for a, b in zip(leaves, r_leaves):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6,
                               atol=1e-6)


def test_td3_cassie_checkpoint_has_the_jax_leaf_count():
    """The TD3 train state on Cassie-v0 (the CLI's default env, dyn-rand
    off) writes as many leaves as the JAX package's TD3TrainState has, the
    count that chip_smoke.py's td3_cassie phase checks on the card."""
    from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
    from apex_tpu_torch.envs.cassie import CassieEnv
    from chip_smoke import TD3_CASSIE_LEAVES

    cfg = dict(num_envs=1, replay_size=1)
    jagent = jax_td3.TD3(JaxCassieEnv(dynamics_randomization=False),
                         jax_td3.TD3Config(**cfg))
    template = jax.eval_shape(lambda: jagent.init(0))
    env = CassieEnv(device="cpu", dynamics_randomization=False)
    state = td3.TD3(env, td3.TD3Config(**cfg)).init(0)
    ours = checkpoint.to_jax_leaves(state, env)
    theirs = jax.tree_util.tree_leaves(template)
    assert len(ours) == len(theirs) == TD3_CASSIE_LEAVES
    assert [a.shape for a in ours] == [tuple(b.shape) for b in theirs]


# ---------------------------------------------------------------------------
# learning
# ---------------------------------------------------------------------------

def test_td3_improves_on_pointmass():
    """tests/test_learning_smoke.py::test_td3_improves_on_pointmass on the
    port, at its configuration: one random warm-up iteration, then 25
    iterations, the acting snapshot refreshed before each; the
    deterministic eval return must rise by more than 5."""
    env = PointMassEnv(device="cpu")
    cfg = td3.TD3Config(num_envs=8, collect_steps=40, start_timesteps=320,
                        replay_size=20_000, max_traj_len=100,
                        updates_per_iter=40, batch_size=128, a_lr=3e-4,
                        c_lr=3e-4)
    agent = td3.TD3(env, cfg)
    state = agent.init(seed=0)
    state, _ = agent._train_iteration(state, random_actions=True)
    gen = lambda: torch.Generator().manual_seed(0)
    ev0 = float(agent._evaluate(state, gen())["ep_return"])
    for _ in range(25):
        td3.copy_params(state.behavior, state.actor)
        state, _ = agent._train_iteration(state, random_actions=False)
    ev1 = float(agent._evaluate(state, gen())["ep_return"])
    assert ev1 > ev0 + 5.0, f"no learning: {ev0:.1f} -> {ev1:.1f}"


def test_ars_improves_on_pointmass():
    """tests/test_agents.py::test_ars_improves_on_pointmass on the port, at
    its configuration (v2, 32 directions, top 8, θ drawn N(0, 0.01^2) to
    break the zero-init symmetry): the best of the last 5 iterations'
    mean returns beats the first by more than 1."""
    agent = ars.ARS(PointMassEnv(device="cpu"), ars.ARSConfig(
        deltas=32, deltas_used=8, step_size=0.1, delta_std=0.1,
        max_traj_len=60, hidden_size=8, algo="v2"))
    state = agent.init(seed=0)
    state.theta = 0.01 * torch.randn(agent.dim, generator=state.generator)
    state, m0 = agent._iteration(state)
    first = float(m0["mean_return"])
    rets = []
    for _ in range(30):
        state, m = agent._iteration(state)
        rets.append(float(m["mean_return"]))
    assert max(rets[-5:]) > first + 1.0, (
        f"no improvement: {first} -> {rets[-5:]}")
