"""The port's recurrent learners against the JAX package on the CPU: the
LSTM nets (forward and initialisers), `BoundedBeta`, recurrent PPO (the
rollout and evaluation on JAX's draws; one update on JAX's trajectory and
permutations, with an episode boundary inside a chunk, a KL early stop,
and the mirror loss through `mirror_clock`), recurrent ARS (the rollout
on JAX's draws and one iteration on JAX's directions), `parse_previous`,
the committed `curves/recurrent_ppo_walker_seed0_ckpt` (its 80 leaves
round-trip; its evaluation on JAX's draws) and a port run dir that JAX
loads. RDPG is in tests/test_torch_rdpg.py.

jax.random and torch draw different numbers, so the parity tests carry
the JAX-initialised weights across through the checkpoint converter and
feed the port the draws of the JAX run (its key splits repeated here:
`pm_reset_noise` and `pm_step_noise` turn PointMass-v0 keys into the
port's noise), or the trajectory JAX collected.
"""
import pickle

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.agents import ars as jax_ars
from apex_tpu.agents import ppo_recurrent as jax_rppo
from apex_tpu.agents.ppo import PPOConfig as JaxPPOConfig
from apex_tpu.envs.base import PointMassEnv as JaxPointMassEnv
from apex_tpu.envs.walker2d import Walker2dEnv as JaxWalker2dEnv
from apex_tpu.models import distributions as jax_dist
from apex_tpu.models import nets as jax_nets
from apex_tpu.runtime import log as jax_log
from apex_tpu.runtime.checkpoint import load_checkpoint as jax_load_ckpt
from apex_tpu_torch.agents import ars
from apex_tpu_torch.agents.ppo import PPOConfig
from apex_tpu_torch.agents.ppo_recurrent import RecurrentPPO
from apex_tpu_torch.envs.base import (
    PointMassEnv,
    PointMassResetNoise,
    PointMassStepNoise,
)
from apex_tpu_torch.envs.walker2d import Walker2dEnv, WalkerResetNoise
from apex_tpu_torch.models.distributions import BoundedBeta
from apex_tpu_torch.models.nets import (
    LSTMQ,
    LSTMV,
    GaussianLSTMActor,
    LSTMActor,
    NormState,
)
from apex_tpu_torch.runtime import checkpoint, log
from apex_tpu_torch.runtime.log import create_logger

OBS, ACT = 4, 2
LAYERS = (32, 32)
CKPT = "curves/recurrent_ppo_walker_seed0_ckpt"
t = torch.tensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: torch's
    default of one thread per core in each of them oversubscribes the
    CPU, and these many small tensors gain nothing from threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def load_params(net, params):
    """Carry a JAX net's params (numpy leaves, (in, out) weights) into the
    port's module, through the converter's leaf order."""
    leaves = jax.tree_util.tree_leaves(params)
    pairs = checkpoint._jax_params(net)
    assert len(pairs) == len(leaves)
    with torch.no_grad():
        for (p, tr), x in zip(pairs, leaves):
            x = np.asarray(x)
            p.copy_(t(x.T if tr else x))


def norms(rng, dim):
    """A normaliser with nonzero mean and var != 1 in both packages."""
    mean = rng.standard_normal(dim).astype(np.float32)
    var = rng.uniform(0.5, 2.0, dim).astype(np.float32)
    jn = jax_nets.NormState(mean=jnp.asarray(mean), var=jnp.asarray(var),
                            count=jnp.asarray(100.0))
    norm = NormState(dim)
    norm.mean.copy_(t(mean))
    norm.var.copy_(t(var))
    norm.count.fill_(100.0)
    return jn, norm


def close(a, b, rtol):
    """rtol relative, rtol of the largest entry absolute (f32 rounding of
    a sum scales with its terms)."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(b).max())))


def assert_leaves_close(ours, ref, what, rtol=1e-5):
    """Leaf lists: floats at rtol (absolute: rtol of the leaf's largest
    entry), integers and keys exactly."""
    assert len(ours) == len(ref), what
    for i, (a, r) in enumerate(zip(ours, ref)):
        r = np.asarray(r)
        assert a.shape == r.shape, (what, i, a.shape, r.shape)
        if r.dtype.kind in "iub":
            np.testing.assert_array_equal(a, r, err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_allclose(
                a, r, rtol=rtol, atol=rtol * max(np.abs(r).max(), 1e-30),
                err_msg=f"{what} leaf {i}")


def pm_reset_noise(keys, max_cmd=1.0):
    """PointMass-v0's reset draws for each JAX key, as the port's noise
    (apex_tpu/envs/base.py:106-109)."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (2,), minval=-max_cmd,
                                   maxval=max_cmd),
                0.1 * jax.random.normal(k2, (2,)))
    cmd, vel = jax.vmap(one)(keys)
    return PointMassResetNoise(cmd=t(np.asarray(cmd)).T.contiguous(),
                               vel=t(np.asarray(vel)).T.contiguous())


def pm_step_noise(keys, max_cmd=1.0):
    """PointMass-v0's step draws for each JAX key (base.py:117-127)."""
    change = jax.vmap(lambda k: jax.random.bernoulli(k, 0.01))(keys)
    new = jax.vmap(lambda k: jax.random.uniform(
        jax.random.fold_in(k, 1), (2,), minval=-max_cmd,
        maxval=max_cmd))(keys)
    return PointMassStepNoise(change=t(np.asarray(change)),
                              new_cmd=t(np.asarray(new)).T.contiguous())


def script_noise(env, resets, steps):
    """The env takes its draws from the lists, in order, instead of the
    generator."""
    env.sample_reset_noise = lambda gen, batch: resets.pop(0)
    env.sample_step_noise = lambda gen, batch: steps.pop(0)


def unscript(env):
    """The env's own draws again."""
    del env.sample_reset_noise, env.sample_step_noise


# ---------------------------------------------------------------------------
# the nets and the Beta distribution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["gaussian_fixed", "gaussian_learned",
                                   "lstm_actor", "lstmv", "lstmq",
                                   "flat_fleet"])
def test_lstm_nets_forward_match_jax(which):
    """Each LSTM net's step_* (two steps from a random carry) and seq_*
    (8 steps from zero) outputs on JAX's weights, with a normaliser that
    is not the identity, at rtol 1e-6 (the `test_nets_forward_match_jax`
    bound); "flat_fleet": 6 fixed-std actors as flat θ rows in
    ravel_pytree's order (`step_flat`, recurrent ARS's policy) against
    JAX's unravelled params under vmap."""
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(3)
    B, T, D = 6, 8, 11
    obs = rng.standard_normal((T, B, D)).astype(np.float32)
    act = rng.uniform(-1, 1, (T, B, 3)).astype(np.float32)
    carry = [(rng.standard_normal((B, h)).astype(np.float32),
              rng.standard_normal((B, h)).astype(np.float32))
             for h in LAYERS]
    tcarry = [(t(h), t(c)) for h, c in carry]
    jn, norm = norms(rng, D)
    gen = torch.Generator()
    c6 = lambda a, b: close(a, b, 1e-6)

    def carries(ours, theirs):
        for (h, c), (jh, jc) in zip(ours, theirs):
            c6(h, jh)
            c6(c, jc)

    if which.startswith("gaussian"):
        fixed = 0.3 if which == "gaussian_fixed" else None
        jnet = jax_nets.GaussianLSTMActor.init(key, D, 3, LAYERS,
                                               fixed_std=fixed)
        net = GaussianLSTMActor.init(gen, D, 3, LAYERS, fixed_std=fixed)
        load_params(net, jnet.params)
        ours, theirs = tcarry, carry
        for step in range(2):
            ours, (m, s) = net.step_dist(norm, ours, t(obs[step]))
            theirs, (jm, js) = jnet.step_dist(jn, theirs, obs[step])
            carries(ours, theirs)
            c6(m, jm)
            c6(s, js)
        for x, y in zip(net.seq_dist(norm, t(obs)), jnet.seq_dist(jn, obs)):
            c6(x, y)
    elif which == "lstm_actor":
        jnet = jax_nets.LSTMActor.init(key, D, 3, LAYERS, max_action=0.7)
        net = LSTMActor.init(gen, D, 3, LAYERS, max_action=0.7)
        load_params(net, jnet.params)
        ours, a = net.step_act(norm, tcarry, t(obs[0]))
        theirs, ja = jnet.step_act(jn, carry, obs[0])
        carries(ours, theirs)
        c6(a, ja)
        c6(net.seq_act(norm, t(obs)), jnet.seq_act(jn, obs))
    elif which == "lstmv":
        jnet = jax_nets.LSTMV.init(key, D, LAYERS)
        net = LSTMV.init(gen, D, LAYERS)
        load_params(net, jnet.params)
        ours, v = net.step_value(norm, tcarry, t(obs[0]))
        theirs, jv = jnet.step_value(jn, carry, obs[0])
        carries(ours, theirs)
        c6(v, jv)
        c6(net.seq_value(norm, t(obs)), jnet.seq_value(jn, obs))
    elif which == "lstmq":
        jnet = jax_nets.LSTMQ.init(key, D, 3, LAYERS)
        net = LSTMQ.init(gen, D, 3, LAYERS)
        load_params(net, jnet.params)
        ours, q = net.step_q(norm, tcarry, t(obs[0]), t(act[0]))
        theirs, jq = jnet.step_q(jn, carry, obs[0], act[0])
        carries(ours, theirs)
        c6(q, jq)
        c6(net.seq_q(norm, t(obs), t(act)), jnet.seq_q(jn, obs, act))
    else:
        template = jax_nets.GaussianLSTMActor.init(key, D, 3, LAYERS,
                                                   fixed_std=1.0)
        flat, unravel = jax.flatten_util.ravel_pytree(template.params)
        assert sum(int(np.prod(s)) for s in GaussianLSTMActor.flat_sizes(
            D, 3, LAYERS)) == flat.shape[0]
        thetas = (0.3 * rng.standard_normal((B, flat.shape[0]))).astype(
            np.float32)

        def one(theta, h, o):
            a = jax_nets.GaussianLSTMActor(params=unravel(theta),
                                           fixed_std=1.0, layers=LAYERS)
            new, (mean, _) = a.step_dist(jn, h, o)
            return new, mean

        theirs, ours = carry, tcarry
        for step in range(2):
            theirs, jm = jax.vmap(one)(thetas, theirs, obs[step])
            ours, m = GaussianLSTMActor.step_flat(t(thetas), norm, ours,
                                                  t(obs[step]), LAYERS, 3)
            carries(ours, theirs)
            c6(m, jm)


def test_lstm_initialisers_follow_the_jax_package():
    """`lstm_init`'s U(-1/sqrt(H), 1/sqrt(H)) for every cell parameter and
    torch's default uniform for the heads, in distribution (bounds, mean
    and variance k^2/3 at 4 standard errors), and the JAX initialiser's
    leaves have the converter's shapes for each net."""
    gen = torch.Generator()
    gen.manual_seed(0)
    actor = GaussianLSTMActor.init(gen, 40, 6, (64, 48), fixed_std=None)
    for i, cell in enumerate(actor.cells):
        k = 1.0 / np.sqrt((64, 48)[i])
        x = torch.cat([p.detach().flatten() for p in cell.parameters()])
        assert float(x.abs().max()) <= k
        n = x.numel()
        assert abs(float(x.mean())) < 4 * k / np.sqrt(3 * n)
        assert abs(float(x.var()) - k * k / 3) < 4 * k * k * np.sqrt(
            4 / 45 / n)
    for head in (actor.out, actor.log_std):
        k = 1.0 / np.sqrt(48)
        w = head.weight.detach().abs()
        assert 0.9 * k < float(w.max()) <= k
    key = jax.random.PRNGKey(0)
    for ours, theirs in (
            (actor, jax_nets.GaussianLSTMActor.init(key, 40, 6, (64, 48))),
            (GaussianLSTMActor.init(gen, 40, 6, (64, 48), fixed_std=0.2),
             jax_nets.GaussianLSTMActor.init(key, 40, 6, (64, 48),
                                             fixed_std=0.2)),
            (LSTMActor.init(gen, 40, 6, (64, 48)),
             jax_nets.LSTMActor.init(key, 40, 6, (64, 48))),
            (LSTMV.init(gen, 40, (64, 48)),
             jax_nets.LSTMV.init(key, 40, (64, 48))),
            (LSTMQ.init(gen, 40, 6, (64, 48)),
             jax_nets.LSTMQ.init(key, 40, 6, (64, 48)))):
        assert [np.shape(x) for x in jax.tree_util.tree_leaves(
            theirs.params)] == [tuple(p.T.shape if tr else p.shape)
                                for p, tr in checkpoint._jax_params(ours)]


def test_bounded_beta_matches_jax():
    """`BoundedBeta` against JAX's. from_mean_var at rtol 1e-6. log_prob
    (with the 1e-6 clip and the -log 2 change of variables, at x inside
    and at the edges) and entropy go through lgamma: the port's
    torch.lgamma is within 1.2e-7 of the float64 value on these inputs,
    JAX's f32 gammaln within 2.2e-6 only, so the port is held to the
    float64 formula (scipy) at rtol 1e-6 and 1e-6 of the largest term
    absolute (f32 rounding of the sum), and to JAX within that plus
    JAX's own error, 1e-5 (three lgamma terms). Samples lie in (-1, 1)
    with the mean 2a/(a+b) - 1 (4 standard errors)."""
    from scipy import special

    rng = np.random.default_rng(1)
    alpha = rng.uniform(0.5, 5.0, 64).astype(np.float32)
    beta = rng.uniform(0.5, 5.0, 64).astype(np.float32)
    x = rng.uniform(-1, 1, 64).astype(np.float32)
    x[:4] = [-1.0, 1.0, -0.999999, 0.9999999]
    J = jax_dist.BoundedBeta
    a64, b64 = alpha.astype(np.float64), beta.astype(np.float64)
    # the f32 clip of both stacks (1 - 1e-6 rounds to 0.99999899), then
    # float64
    z = np.clip((x + np.float32(1.0)) / np.float32(2.0), np.float32(1e-6),
                np.float32(1.0 - 1e-6)).astype(np.float64)
    log_b = special.gammaln(a64) + special.gammaln(b64) - special.gammaln(
        a64 + b64)
    terms = {
        "log_prob": [(a64 - 1.0) * np.log(z), (b64 - 1.0) * np.log1p(-z),
                     -log_b, np.full_like(z, -np.log(2.0))],
        "entropy": [log_b, -(a64 - 1.0) * special.psi(a64),
                    -(b64 - 1.0) * special.psi(b64),
                    (a64 + b64 - 2.0) * special.psi(a64 + b64)]}
    ours = {"log_prob": BoundedBeta.log_prob(t(alpha), t(beta), t(x)),
            "entropy": BoundedBeta.entropy(t(alpha), t(beta))}
    theirs = {"log_prob": J.log_prob(alpha, beta, x),
              "entropy": J.entropy(alpha, beta)}
    for k, parts in terms.items():
        exact = sum(parts)
        # f32 rounding of a sum: 1e-6 of its largest term
        scale = 1e-6 * max(float(np.abs(p).max()) for p in parts)
        np.testing.assert_allclose(ours[k].numpy(), exact, rtol=1e-6,
                                   atol=scale, err_msg=k)
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-6, atol=scale + 1e-5, err_msg=k)
    mean = rng.uniform(0.05, 0.95, 64).astype(np.float32)
    var = rng.uniform(0.0, 0.1, 64).astype(np.float32)
    var[:2] = 0.0
    for a, b in zip(BoundedBeta.from_mean_var(t(mean), t(var)),
                    J.from_mean_var(mean, var)):
        close(a, b, 1e-6)
    gen = torch.Generator()
    gen.manual_seed(0)
    a, b = torch.full((20000,), 2.0), torch.full((20000,), 5.0)
    s = BoundedBeta.sample(gen, a, b)
    assert bool(((s > -1) & (s < 1)).all())
    sd = 2 * np.sqrt(2 * 5 / (49 * 8)) / np.sqrt(20000)
    assert abs(float(s.mean()) - (2 * 2.0 / 7.0 - 1)) < 4 * sd


# ---------------------------------------------------------------------------
# recurrent PPO
# ---------------------------------------------------------------------------

def rppo_pair(jenv, env, seed=0, **cfg):
    """The JAX and the port's RecurrentPPO on one configuration (layers
    (32, 32)), and JAX's initial state."""
    jrp = jax_rppo.RecurrentPPO(jenv, JaxPPOConfig(**cfg), layers=LAYERS)
    rp = RecurrentPPO(env, PPOConfig(**cfg), layers=LAYERS)
    return jrp, rp, jrp.init(seed)


def to_port(rp, jstate, seed=0):
    """A port state holding JAX's state, through the checkpoint
    converter."""
    return checkpoint.restore_recurrent_ppo(
        rp.init(seed), jax.tree_util.tree_leaves(jstate), rp.env)


def with_norm(jstate, rng, dim):
    jn, _ = norms(rng, dim)
    return jstate.replace(norm=jn)


def test_recurrent_ppo_rollout_and_eval_match_jax():
    """PointMass-v0, 6 envs, chunks of 12 steps, max_traj_len 5 (every
    chunk crosses episode boundaries): the deterministic `_rollout` from a
    runner that one JAX chunk advanced (nonzero carries, traj_len and
    returns), on JAX's step and reset draws, gives JAX's trajectory (the
    episode starts, truncations, done returns and lengths exactly) and
    runner (the actor carry zeroed after each done, the critic carry
    unchanged) at rtol 1e-5; `_evaluate` on JAX's reset draws gives its
    return and length; `prenormalize` on JAX's draws gives its
    normaliser."""
    cfg = dict(num_envs=6, num_steps=72, max_traj_len=5)
    jenv, env = JaxPointMassEnv(), PointMassEnv(device="cpu")
    jrp, rp, js = rppo_pair(jenv, env, **cfg)
    js = with_norm(js, np.random.default_rng(2), OBS)
    roll = jax.jit(jrp._rollout, static_argnums=(3,))
    runner1, _ = roll(js, js.runner, 1.0, True)
    js = js.replace(runner=runner1)
    state = to_port(rp, js)
    rng = runner1.rng
    resets, steps = [], []
    for _ in range(12):
        rng, _, k_step, k_reset = jax.random.split(rng, 4)
        steps.append(pm_step_noise(jax.random.split(k_step, 6)))
        resets.append(pm_reset_noise(jax.random.split(k_reset, 6)))
    script_noise(env, resets, steps)
    jrunner, jtraj = roll(js, js.runner, 1.0, True)
    runner, traj = rp._rollout(state, state.runner, 1.0, deterministic=True)
    assert int(jtraj.truncated.sum()) > 0
    for name in jtraj._fields:
        a, b = getattr(traj, name), np.asarray(getattr(jtraj, name))
        if b.dtype.kind in "iub":
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            close(a, b, 1e-5)
    jr = jax.tree_util.tree_leaves(jrunner)
    ours = (env.checkpoint_leaves(runner.env_state, runner.obs)
            + [runner.obs.numpy(), runner.traj_len.numpy(),
               runner.ep_return.numpy()]
            + checkpoint._carry(runner.actor_carry)
            + checkpoint._carry(runner.critic_carry))
    assert_leaves_close(ours, jr[:-1], "runner")

    # _evaluate: the fresh fleet's reset, then a step draw per step
    erng, key = jax.random.split(jax.random.PRNGKey(7))
    steps = []
    for _ in range(cfg["max_traj_len"]):
        erng, k_step = jax.random.split(erng)
        steps.append(pm_step_noise(jax.random.split(k_step, 6)))
    script_noise(env, [pm_reset_noise(jax.random.split(key, 6))], steps)
    jev = jax.jit(jrp._evaluate)(js, jax.random.PRNGKey(7))
    ev = rp._evaluate(state, torch.Generator())
    for k in ("ep_return", "ep_len"):
        close(ev[k], jev[k], 1e-5)

    # prenormalize without action noise (N(0, 0)): 18 // 6 = 3 steps of
    # the policy mean from JAX's fleet, on JAX's step draws
    js = js.replace(runner=jrp._init_runner(jax.random.PRNGKey(9)))
    jpre = jrp.prenormalize(js, steps=18, noise_std=0.0)
    unscript(env)
    state = to_port(rp, js)
    keys, steps = js.runner.rng, []
    for _ in range(3):
        keys, _, k_step = jax.random.split(keys, 3)
        steps.append(pm_step_noise(jax.random.split(k_step, 6)))
    script_noise(env, [pm_reset_noise(jax.random.split(keys, 6))], steps)
    pre = rp.prenormalize(state, steps=18, noise_std=0.0)
    for name in ("mean", "var", "count"):
        close(getattr(pre.norm, name), getattr(jpre.norm, name), 1e-6)


def synthetic_traj(rng, T, B, obs_dim, act_dim):
    """A chunk with terminations and truncations inside it, its episode
    starts where the previous step ended one (and at step 0)."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    term = rng.random((T, B)) < 0.08
    trunc = (rng.random((T, B)) < 0.08) & ~term
    done = term | trunc
    start = np.ones((T, B), np.float32)
    start[1:] = done[:-1]
    lens = np.where(done, rng.integers(1, 50, (T, B)), 0).astype(np.int32)
    return jax_rppo.RecurrentRollout(
        obs=f(T, B, obs_dim), action=0.3 * f(T, B, act_dim),
        reward=f(T, B), terminated=term, truncated=trunc,
        next_obs=f(T, B, obs_dim), episode_start=start,
        done_ep_return=np.where(done, f(T, B), 0).astype(np.float32),
        done_ep_len=lens)


UPDATE_CASES = {
    # PointMass-v0, episodes of 5 steps in chunks of 12; after one JAX
    # iteration (nonzero carries and Adam state); 3 minibatches of 2 envs
    "boundary": dict(num_envs=6, num_steps=72, max_traj_len=5,
                     minibatch_size=2, epochs=2, lr=3e-4),
    # the same with kl_max 1e-12: epoch 0, then two skipped epochs
    "kl_stop": dict(num_envs=6, num_steps=72, max_traj_len=5,
                    minibatch_size=2, epochs=3, lr=3e-4, kl_max=1e-12),
    # Walker2d's sizes and mirror tables with two clock indices (the
    # mirror loss through mirror_clock), GAE, an entropy bonus, anneal
    # 0.7, a synthetic chunk of 16 steps from random carries; 5 envs in
    # minibatches of 2 (the permutation truncated to 4)
    "walker_mirror_clock": dict(num_envs=5, num_steps=80, max_traj_len=400,
                                minibatch_size=2, epochs=2, use_gae=True,
                                entropy_coeff=0.01, lr=3e-4),
}


@pytest.mark.parametrize("case", list(UPDATE_CASES))
def test_recurrent_ppo_update_matches_jax(case, monkeypatch):
    """One `RecurrentPPO._train_iteration` of the JAX package against the
    port's `_update` fed JAX's trajectory and its epoch permutations
    (`split(state.rng)` then `split(k_perm, epochs)`, as
    ppo_recurrent.py:255, 368 draw them), from the same state carried
    over by the checkpoint converter: the nets, the normaliser and both
    Adam states at rtol 1e-5 (the `test_td3_updates_match_jax` bound;
    absolute: 1e-5 of the leaf's largest entry), and every metric at rtol
    1e-5 and 1e-6 absolute: the actor loss is a mean of ratio x advantage
    terms of order 1 (normalised advantages) that cancel to 1e-3 or less,
    each rounded to ~1e-7 (the absolute floor of
    `test_update_half_of_the_iteration_matches_jax`)."""
    cfg = UPDATE_CASES[case]
    anneal = 0.7 if case.startswith("walker") else 1.0
    rng = np.random.default_rng(4)
    if case.startswith("walker"):
        jenv, env = JaxWalker2dEnv(), Walker2dEnv(device="cpu")
        jenv.clock_inds = env.clock_inds = [2, 9]
    else:
        jenv, env = JaxPointMassEnv(), PointMassEnv(device="cpu")
    jrp, rp, js = rppo_pair(jenv, env, **cfg)
    js = with_norm(js, rng, env.observation_size)
    B, T = cfg["num_envs"], cfg["num_steps"] // cfg["num_envs"]
    step = jax.jit(jrp._train_iteration)
    if case.startswith("walker"):
        jtraj = synthetic_traj(rng, T, B, env.observation_size,
                               env.action_size)
        carry = lambda: [tuple(jnp.asarray(
            0.5 * rng.standard_normal((B, h)).astype(np.float32))
            for _ in range(2)) for h in LAYERS]
        js = js.replace(runner=js.runner.replace(actor_carry=carry(),
                                                 critic_carry=carry()))
        monkeypatch.setattr(jrp, "_rollout", lambda st, runner, an, det: (
            runner, jax.tree_util.tree_map(jnp.asarray, jtraj)))
    else:
        js, _ = step(js, jnp.asarray(anneal))
        jtraj = jax.jit(jrp._rollout, static_argnums=(3,))(
            js, js.runner, jnp.asarray(anneal), False)[1]
        assert int(jtraj.truncated.sum()) > 0
        assert float(jnp.abs(js.runner.actor_carry[0][0]).max()) > 0
    jnew, jm = step(js, jnp.asarray(anneal))
    _, k_perm = jax.random.split(js.rng)
    perms = [t(np.asarray(jax.random.permutation(k, B)))
             for k in jax.random.split(k_perm, cfg["epochs"])]

    state = to_port(rp, js)
    traj = jax_rppo.RecurrentRollout(*(t(np.asarray(x)) for x in jtraj))
    m = rp._update(state, traj, state.runner.actor_carry,
                   state.runner.critic_carry, anneal, perms)
    n_mb = B // min(cfg["minibatch_size"], B)
    done_epochs = 1 if case == "kl_stop" else cfg["epochs"]
    assert state.actor_opt.count == int(jax.tree_util.tree_leaves(
        js.actor_opt)[0]) \
        + n_mb * done_epochs
    for k, v in jm.items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    n = 2 * 10 + 3 + 2 * 21
    assert_leaves_close(checkpoint.to_jax_leaves(state, env)[:n],
                        jax.tree_util.tree_leaves(jnew)[:n], case)


# ---------------------------------------------------------------------------
# recurrent ARS
# ---------------------------------------------------------------------------

def test_recurrent_ars_iteration_matches_jax():
    """One JAX `_iteration` of ARS with the LSTM policy (PointMass-v0,
    hidden 4, 4 directions, top 2, v2, 12 steps) from a nonzero θ: the
    port's `_rollout_batch` of JAX's candidates on JAX's reset and step
    draws (each candidate's key, then split(fold_in(key, 1), T)) gives
    JAX's returns, steps alive and observations, and `_update` on JAX's
    directions gives its θ (ravel_pytree's order) and normaliser, at rtol
    1e-5."""
    cfg = dict(deltas=4, deltas_used=2, step_size=0.1, delta_std=0.1,
               max_traj_len=12, hidden_size=4, algo="v2", recurrent=True)
    jagent = jax_ars.ARS(JaxPointMassEnv(), jax_ars.ARSConfig(**cfg))
    env = PointMassEnv(device="cpu")
    agent = ars.ARS(env, ars.ARSConfig(**cfg))
    assert agent.dim == jagent._dim
    rng = np.random.default_rng(6)
    jn, norm = norms(rng, OBS)
    js = jagent.init(seed=3).replace(
        theta=jnp.asarray(0.5 * rng.standard_normal(jagent._dim),
                          jnp.float32), norm=jn)
    jnew, jm = jax.jit(jagent._iteration)(js)
    _, k_delta, k_roll = jax.random.split(js.rng, 3)
    deltas = jax.random.normal(k_delta, (cfg["deltas"], jagent._dim))
    cand = jnp.concatenate([js.theta + cfg["delta_std"] * deltas,
                            js.theta - cfg["delta_std"] * deltas])
    jret, jsteps, jobs = jax.jit(jagent._rollout_batch)(cand, jn, k_roll)
    keys = jax.random.split(k_roll, 2 * cfg["deltas"])
    step_keys = jax.vmap(lambda k: jax.random.split(
        jax.random.fold_in(k, 1), cfg["max_traj_len"]))(keys)
    script_noise(env, [pm_reset_noise(keys)],
                 [pm_step_noise(step_keys[:, i])
                  for i in range(cfg["max_traj_len"])])
    ret, steps, obs_seq = agent._rollout_batch(t(np.asarray(cand)), norm,
                                               torch.Generator())
    close(ret, jret, 1e-5)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jsteps))
    close(obs_seq, np.swapaxes(np.asarray(jobs), 0, 1), 1e-5)

    state = ars.ARSTrainState(theta=t(np.asarray(js.theta)), norm=norm,
                              generator=torch.Generator(), seed=3,
                              total_steps=0)
    state, m = agent._update(state, t(np.asarray(deltas)), ret, steps,
                             obs_seq)
    close(state.theta, jnew.theta, 1e-5)
    for name in ("mean", "var", "count"):
        close(getattr(norm, name), getattr(jnew.norm, name), 1e-5)
    for k in ("mean_return", "max_return", "sigma_r"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)


# ---------------------------------------------------------------------------
# parse_previous, the committed checkpoint, run dirs JAX loads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exchange", [None, "5k_speed_reward"])
def test_parse_previous_matches_jax(exchange, tmp_path):
    """`parse_previous` against JAX's on a namespace of the ppo flags: the
    previous run's env keys replace the arguments' own (keys it lacks
    stay), and `exchange_reward` swaps the reward and renames the run;
    the same keys in the same order, hence the same args_hash. Without
    `previous` the namespace is returned as it is; with a previous run
    that stored no run name, the rename fails in both (JAX's quirk,
    kept)."""
    import argparse

    prev = {"env_name": "CassieTraj-v0", "traj": "aslip", "simrate": 60,
            "command_profile": "phase", "input_profile": "min",
            "learn_gains": True, "history": 2, "mirror": True,
            "reward": "clock", "run_name": "walk", "lr": 3e-4}
    with open(tmp_path / "experiment.pkl", "wb") as f:
        pickle.dump(prev, f)

    def namespace(previous):
        return argparse.Namespace(
            logdir="x", seed=0, previous=previous, exchange_reward=exchange,
            run_name=None, lr=1e-4, env_name="Cassie-v0", simrate=50,
            command_profile="clock", input_profile="full",
            dyn_random=False, learn_gains=False, reward="early_clock",
            history=0, mirror=False, no_delta=True, ik_baseline=False,
            traj="walking")

    ours = vars(log.parse_previous(namespace(str(tmp_path))))
    theirs = vars(jax_log.parse_previous(namespace(str(tmp_path))))
    assert list(ours) == list(theirs) and ours == theirs
    assert ours["env_name"] == "CassieTraj-v0" and ours["lr"] == 1e-4
    assert ours["reward"] == (exchange or "early_clock")
    assert ours["run_name"] == (None if exchange is None else
                                "walk_NEW-5k_speed_reward")
    assert log.args_hash(ours) == jax_log.args_hash(theirs)
    assert vars(log.parse_previous(namespace(None))) == vars(namespace(None))
    # a previous run without a --run_name stored None: both stacks fail to
    # rename it (None + str), as JAX's apex.py does
    if exchange:
        with open(tmp_path / "experiment.pkl", "wb") as f:
            pickle.dump(dict(prev, run_name=None), f)
        for parse in (log.parse_previous, jax_log.parse_previous):
            with pytest.raises(TypeError):
                parse(namespace(str(tmp_path)))


def test_committed_checkpoint_loads_and_evaluates_as_jax(tmp_path):
    """`curves/recurrent_ppo_walker_seed0_ckpt` (Walker2d, 256 envs) loads
    into the port's RecurrentPPOState and round-trips to its 80 leaves bit
    for bit; the port's save loads back in JAX's template
    (`load_checkpoint(path, RecurrentPPO(...).init(0))`) to the same
    leaves; and the port's deterministic evaluation of it at 8 envs and
    100 steps, on the reset draws of JAX's evaluation at PRNGKey(42),
    gives JAX's return at rtol 1e-4 (they differ by 1.1e-6 relative) and
    its length exactly."""
    from apex_tpu.envs.registry import env_factory as jax_env_factory

    with open(f"{CKPT}/checkpoint.pkl", "rb") as f:
        leaves = pickle.load(f)
    with open(f"{CKPT}/experiment.pkl", "rb") as f:
        exp = pickle.load(f)
    assert len(leaves) == 80 and exp["recurrent"]
    env = Walker2dEnv(device="cpu")
    full = RecurrentPPO(env, PPOConfig(num_envs=exp["num_procs"]))
    state = checkpoint.load_recurrent_ppo(CKPT, full)
    back = checkpoint.to_jax_leaves(state, env)
    for a, b in zip(back, leaves):
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    checkpoint.save_checkpoint(str(tmp_path), state, env)
    jenv = jax_env_factory(exp["env_name"])
    jfull = jax_rppo.RecurrentPPO(jenv, JaxPPOConfig(
        num_envs=exp["num_procs"]))
    restored = jax_load_ckpt(str(tmp_path), jfull.init(0))
    for a, b in zip(jax.tree_util.tree_leaves(restored), leaves):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    B, T = 8, 100
    jrp = jax_rppo.RecurrentPPO(jenv, JaxPPOConfig(num_envs=B,
                                                   max_traj_len=T))
    jev = jrp._eval_iter(restored, jax.random.PRNGKey(42))
    _, key = jax.random.split(jax.random.PRNGKey(42))
    m = jenv.model

    def draws(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (m.nq,), minval=-1.0, maxval=1.0),
                jax.random.uniform(k2, (m.nv,), minval=-1.0, maxval=1.0))

    q, v = jax.vmap(draws)(jax.random.split(key, B))
    env.sample_reset_noise = lambda gen, batch: WalkerResetNoise(
        qpos=t(np.asarray(q)).T.contiguous(),
        qvel=t(np.asarray(v)).T.contiguous())
    ev = RecurrentPPO(env, PPOConfig(num_envs=B, max_traj_len=T))._evaluate(
        state, torch.Generator())
    np.testing.assert_allclose(float(ev["ep_return"]),
                               float(jev["ep_return"]), rtol=1e-4)
    assert float(ev["ep_len"]) == float(jev["ep_len"])


def test_recurrent_run_dir_loads_in_the_jax_package(tmp_path):
    """A port RecurrentPPO run on PointMass-v0 (CPU, layers (32, 32), a
    burn-in and two iterations, saving on each new best) writes a run dir
    whose checkpoint restores into JAX's template of the same
    configuration, leaf for leaf; the restored actor gives the port's
    step_dist on fixed observations from a random carry (1e-6), and
    JAX's own evaluation runs on it."""
    cfg = dict(num_envs=4, num_steps=32, max_traj_len=6, minibatch_size=2)
    env = PointMassEnv(device="cpu")
    rp = RecurrentPPO(env, PPOConfig(**cfg), layers=LAYERS)
    logger = create_logger({"env_name": "PointMass-v0", "seed": 0,
                            "logdir": str(tmp_path), "recurrent": True})
    state = rp.prenormalize(rp.init(0), steps=16)
    state = rp.train(state, n_itr=2, logger=logger, verbose=False,
                     save_fn=lambda st: checkpoint.save_checkpoint(
                         logger.dir, st, env))
    logger.close()
    jrp = jax_rppo.RecurrentPPO(JaxPointMassEnv(), JaxPPOConfig(**cfg),
                                layers=LAYERS)
    restored = jax_load_ckpt(logger.dir, jrp.init(0))
    with open(f"{logger.dir}/checkpoint.pkl", "rb") as f:
        saved = pickle.load(f)
    for a, b in zip(jax.tree_util.tree_leaves(restored), saved):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    rng = np.random.default_rng(8)
    obs = rng.standard_normal((5, OBS)).astype(np.float32)
    carry = [tuple(rng.standard_normal((5, h)).astype(np.float32)
                   for _ in range(2)) for h in LAYERS]
    back = checkpoint.load_recurrent_ppo(logger.dir, rp)
    with torch.no_grad():
        _, (mean, std) = back.actor.step_dist(
            back.norm, [(t(h), t(c)) for h, c in carry], t(obs))
    _, (jmean, jstd) = restored.actor.step_dist(restored.norm, carry, obs)
    close(mean, jmean, 1e-6)
    close(std, jstd, 1e-6)
    ev = jrp._evaluate(restored, jax.random.PRNGKey(0))
    assert np.isfinite(float(ev["ep_return"]))
