"""JAX's draws for the port's tools (`scripts/torch_*.py --jax_draws`), and
JAX's figures of tools/estimator_divergence.py, on the CPU.

jax.random and torch draw different numbers from the same seed, so a
port tool and its JAX tool are compared on the same draws. The analysis
jobs and the estimator evaluation draw per call (seed, n_trials, n_steps)
alike: trial i resets from split(split(PRNGKey(seed), n_trials)[i])[0] and
steps from split(split(...)[1], n_steps) (apex_tpu/runtime/analysis.py,
tools/estimator_divergence.py). A file holds, per call c, "c<c>_call"
(seed, n_trials, n_steps), the reset draws "c<c>_reset_<field>" (trial
first) and the step draws "c<c>_step_<field>" (step, trial, ...) under
the port's field names (`envs/cassie.ResetNoise`, `StepNoise`,
`envs/cassie_traj.TrajResetNoise`, `TrajStepNoise`); `chip_smoke.
file_draws` replays it.

  calls      the draws of the given calls for the env of a run directory,
             built as the JAX package's `load_experiment` builds it (with
             the run's --traj under --keep-traj); no physics is run
  estimator  tools/estimator_divergence.py's evaluation of a run
             directory (its five rows, --episodes envs for --steps steps,
             seed 17) on JAX's CPU: each row's mean return and length and,
             with --spread N, the mean return of N more runs whose reset
             joint positions change by random factors 1 +- 1e-6 (ROADMAP
             limit (f)'s measure); with the draws of call (17, episodes,
             steps), the estimator noise included. --rows runs a subset
             (one process per row runs them side by side), `merge` joins
             the parts.

    JAX_PLATFORMS=cpu python scripts/export_tool_draws.py calls \\
        --path curves/cassie_mk4_hardened_ckpt --calls 0,1,300 --out X.npz
    JAX_PLATFORMS=cpu python scripts/export_tool_draws.py estimator \\
        --path curves/cassie_mk4_hardened_ckpt --spread 2 --rows 0 \\
        --out part0.npz
    python scripts/export_tool_draws.py merge part*.npz --out E.npz
"""
import argparse
import functools
import importlib.util
import os
import pathlib
import pickle
import sys
import time
from types import SimpleNamespace

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# tools/estimator_divergence.py's rows
ROWS = [
    ("exact", {}),
    ("firmware tau=12ms", {"estimator": "firmware"}),
    ("firmware tau=25ms", {"estimator": "firmware",
                           "estimator_tau": 0.025}),
    ("firmware + noise 0.02", {"estimator": "firmware",
                               "estimator_noise": 0.02}),
    ("firmware + noise 0.05", {"estimator": "firmware",
                               "estimator_noise": 0.05}),
]
EST_SEED = 17


@functools.lru_cache(maxsize=None)
def _export_eval_draws():
    """scripts/export_eval_draws.py, whose `reset_draws` this file uses."""
    spec = importlib.util.spec_from_file_location(
        "export_eval_draws", ROOT / "scripts" / "export_eval_draws.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_draws(env, keys, est_noise: bool = False):
    """JAX's step draws per key (CassieEnv.step: the command changes, the
    heading jump, the estimator noise from fold_in(key, 7); CassieTrajEnv:
    the heading change), batch-first numpy under the port's names."""
    traj = type(env).__name__ == "CassieTrajEnv"

    def one(rng):
        u = lambda k, lo, hi: jax.random.uniform(k, (), minval=lo, maxval=hi)
        if traj:
            k1, k2 = jax.random.split(rng)
            return dict(orient_hit=jax.random.randint(k1, (), 0, 300) == 0,
                        orient_delta=u(k2, -env.max_orient_change,
                                       env.max_orient_change))
        k1, k2, k3, k4, k5, k6, k7, k8, k9 = jax.random.split(rng, 9)
        out = dict(
            orient_hit=jax.random.randint(k1, (), 0, 300) == 0,
            orient_delta=u(k2, -env.max_orient_change,
                           env.max_orient_change),
            speed_hit=jax.random.randint(k3, (), 0, 100) == 0,
            new_speed=u(k4, env.min_speed, env.max_speed),
            side_hit=jax.random.randint(k5, (), 0, 300) == 0,
            new_side=u(k6, env.min_side_speed, env.max_side_speed))
        if env.orient_jump_prob > 0:
            out.update(jump_size=u(k7, jnp.pi / 6, jnp.pi / 3),
                       jump_sign=jax.random.bernoulli(k8),
                       jump_u=jax.random.uniform(k9, ()))
        if est_noise or (env.estimator == "firmware"
                         and env.estimator_noise > 0):
            ks = jax.random.split(jax.random.fold_in(rng, 7), 4)
            out["est_noise"] = jnp.concatenate([
                jax.random.normal(ks[0], (3,)),
                jax.random.normal(ks[1], (3,)),
                jax.random.normal(ks[2], (10,)),
                jax.random.normal(ks[3], (6,))])
        return out
    return {k: np.asarray(v) for k, v in jax.vmap(one)(keys).items()}


def call_draws(env, seed: int, n_trials: int, n_steps: int, prefix: str,
               est_noise: bool = False):
    """The draws of one call, keyed as a file holds them."""
    if getattr(env, "terrain", "flat") != "flat" or \
            env.command_profile == "phase":
        raise SystemExit("export_tool_draws: the terrain and phase-profile "
                         "reset draws are not exported")
    keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
    pair = jax.vmap(jax.random.split)(keys)
    step_keys = jax.vmap(lambda k: jax.random.split(k, n_steps))(pair[:, 1])
    out = {f"{prefix}call": np.int64([seed, n_trials, n_steps])}
    for k, v in _export_eval_draws().reset_draws(env, pair[:, 0]).items():
        out[f"{prefix}reset_{k}"] = v
    # every step's draws in one call: keys (n_steps * n_trials, 2)
    flat = jnp.swapaxes(step_keys, 0, 1).reshape(-1, *step_keys.shape[2:])
    for k, v in step_draws(env, flat, est_noise).items():
        out[f"{prefix}step_{k}"] = v.reshape(n_steps, n_trials, *v.shape[1:])
    return out


def jax_env(run_dir: str, keep_traj: bool = False):
    """The env of a run directory as the JAX package's `load_experiment`
    builds it (apex_tpu/runtime/evaluate.py), with --traj under
    `keep_traj`."""
    from apex_tpu.envs.registry import env_factory

    with open(os.path.join(run_dir, "experiment.pkl"), "rb") as f:
        exp = pickle.load(f)
    a = SimpleNamespace(**exp)
    extra = {"traj": exp.get("traj", "walking")} if keep_traj else {}
    return env_factory(
        getattr(a, "env_name", "Cassie-v0"),
        simrate=getattr(a, "simrate", 50),
        command_profile=getattr(a, "command_profile", "clock"),
        input_profile=getattr(a, "input_profile", "full"),
        learn_gains=getattr(a, "learn_gains", False),
        dynamics_randomization=getattr(a, "dyn_random", False),
        reward=getattr(a, "reward", "early_clock"),
        history=getattr(a, "history", 0),
        estimator=getattr(a, "estimator", "exact"),
        terrain=getattr(a, "terrain", "flat"),
        min_speed=getattr(a, "min_speed", -0.3),
        max_speed=getattr(a, "max_speed", 4.0),
        orient_jump_prob=getattr(a, "orient_jump_prob", 0.0),
        speed_phase_add=getattr(a, "speed_phase_add", False), **extra)


def estimator_eval(env, policy_fn, episodes: int, steps: int,
                   scales=None):
    """tools/estimator_divergence.py's `evaluate` (mean return and length);
    with `scales` (episodes, nq - 7) the reset joint positions are
    multiplied by them first."""
    def single(key, scale):
        k_reset, k_run = jax.random.split(key)
        st, ob = env.reset(k_reset)
        if scale is not None:
            st = st.replace(phys=st.phys.replace(
                qpos=st.phys.qpos.at[7:].multiply(scale)))
        # deterministic eval command: walk forward at 1.0 m/s
        st = st.replace(speed=jnp.asarray(1.0), side_speed=jnp.zeros(()))

        def body(carry, key):
            s, o, done, ret, length = carry
            a = policy_fn(o)
            s2, o2, r, term, _ = env.step(s, a, key)
            ret = ret + jnp.where(done, 0.0, r)
            length = length + jnp.where(done, 0, 1)
            return (s2, o2, done | term, ret, length), None

        keys = jax.random.split(k_run, steps)
        (_, _, _, ret, length), _ = jax.lax.scan(
            body, (st, ob, jnp.zeros((), bool), jnp.zeros(()),
                   jnp.zeros((), jnp.int32)), keys)
        return ret, length

    keys = jax.random.split(jax.random.PRNGKey(EST_SEED), episodes)
    if scales is None:
        ret, length = jax.jit(jax.vmap(lambda k: single(k, None)))(keys)
    else:
        ret, length = jax.jit(jax.vmap(single))(
            keys, jnp.asarray(scales, jnp.float32))
    return float(jnp.mean(ret)), float(jnp.mean(length))


def estimator(args):
    from apex_tpu.envs.cassie import CassieEnv
    from apex_tpu.runtime.evaluate import load_experiment

    ppo, state, exp = load_experiment(args.path)

    def policy_fn(obs):
        return state.actor.act(state.norm, obs, deterministic=True)

    base = dict(dynamics_randomization=False,
                reward=exp.reward if hasattr(exp, "reward") else "early_clock")
    rng = np.random.default_rng(0)
    rets, lens, moved = [], [], []
    for i in args.rows:
        label, kw = ROWS[i]
        env = CassieEnv(**base, **kw)
        t0 = time.time()
        ret, length = estimator_eval(env, policy_fn, args.episodes,
                                     args.steps)
        rets.append(ret)
        lens.append(length)
        print(f"{label:24s} return {ret:8.2f}  len {length:6.1f} "
              f"({time.time() - t0:.0f} s)", flush=True)
        moved.append([])
        for _ in range(args.spread):
            scales = 1.0 + 1e-6 * rng.choice(
                [-1.0, 1.0], size=(args.episodes, env.model.nq - 7))
            moved[-1].append(estimator_eval(env, policy_fn, args.episodes,
                                            args.steps, scales)[0])
            print(f"  perturbed 1e-6: return {moved[-1][-1]:.4f}",
                  flush=True)
    out = call_draws(CassieEnv(**base), EST_SEED, args.episodes, args.steps,
                     "c0_", est_noise=True)
    out.update(jax_rows=np.int64(args.rows), jax_return=np.float64(rets),
               jax_len=np.float64(lens),
               jax_perturbed_returns=np.float64(moved).reshape(
                   len(args.rows), args.spread))
    return out


def merge(paths):
    parts = []
    for p in paths:
        with np.load(p) as f:
            parts.append({k: f[k] for k in f})
    out = {k: v for k, v in parts[0].items() if not k.startswith("jax_")}
    for k in ("jax_rows", "jax_return", "jax_len", "jax_perturbed_returns"):
        out[k] = np.concatenate([p[k] for p in parts])
    order = np.argsort(out["jax_rows"])
    for k in ("jax_rows", "jax_return", "jax_len", "jax_perturbed_returns"):
        out[k] = out[k][order]
    if list(out["jax_rows"]) != list(range(len(ROWS))):
        raise SystemExit(f"merge: rows {out['jax_rows']}, want all "
                         f"{len(ROWS)}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("calls")
    c.add_argument("--path", required=True)
    c.add_argument("--calls", nargs="+", required=True,
                   help="seed,n_trials,n_steps of each call")
    c.add_argument("--keep-traj", action="store_true")
    e = sub.add_parser("estimator")
    e.add_argument("--path", required=True)
    e.add_argument("--episodes", type=int, default=32)
    e.add_argument("--steps", type=int, default=300)
    e.add_argument("--spread", type=int, default=0)
    e.add_argument("--rows", type=int, nargs="+",
                   default=list(range(len(ROWS))))
    m = sub.add_parser("merge")
    m.add_argument("parts", nargs="+")
    for q in (c, e, m):
        q.add_argument("--out", required=True)
    args = p.parse_args(argv)

    if args.mode == "calls":
        env = jax_env(args.path, args.keep_traj)
        out = {}
        for i, spec in enumerate(args.calls):
            seed, n, steps = (int(x) for x in spec.split(","))
            out.update(call_draws(env, seed, n, steps, f"c{i}_"))
    elif args.mode == "estimator":
        out = estimator(args)
    else:
        out = merge(args.parts)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({pathlib.Path(args.out).stat().st_size} B)")
    return out


if __name__ == "__main__":
    main()
