"""The reset draws of JAX's deterministic evaluation of a recurrent PPO
Walker2d run directory, saved for the port's evaluation on the card
(`chip_smoke.py` recurrent_ppo_walker), with JAX's returns at seeds 42, 0
and 1.

JAX's `RecurrentPPO._evaluate(state, PRNGKey(seed))` resets a fresh fleet
and steps it `max_traj_len` times without resets; Walker2d's step draws
nothing, so the reset's uniform draws (qpos and qvel, U[-1, 1) before the
5e-3 scale) are all the randomness of the run. This script loads the run
dir into a JAX template (`RecurrentPPO(env_factory(env_name),
PPOConfig(num_envs, max_traj_len)).init(0)`), evaluates it on the CPU at
each seed, and saves the first seed's draws batch-first with the returns.

    JAX_PLATFORMS=cpu python scripts/export_recurrent_draws.py \\
        --path curves/recurrent_ppo_walker_seed0_ckpt \\
        --out curves/jax_eval_draws/recurrent_ppo_walker.npz
"""
import argparse
import pathlib
import pickle
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from apex_tpu.agents.ppo import PPOConfig  # noqa: E402
from apex_tpu.agents.ppo_recurrent import RecurrentPPO  # noqa: E402
from apex_tpu.envs.registry import env_factory  # noqa: E402
from apex_tpu.runtime.checkpoint import load_checkpoint  # noqa: E402


def reset_draws(env, seed: int, B: int):
    """The uniform draws of `_init_runner(PRNGKey(seed))`'s fleet reset
    (ppo_recurrent.py:121-137, walker2d.py:59-67): (qpos (B, nq), qvel
    (B, nv))."""
    _, key = jax.random.split(jax.random.PRNGKey(seed))
    m = env.model

    def one(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.uniform(k1, (m.nq,), minval=-1.0, maxval=1.0),
                jax.random.uniform(k2, (m.nv,), minval=-1.0, maxval=1.0))

    qpos, qvel = jax.vmap(one)(jax.random.split(key, B))
    return np.asarray(qpos), np.asarray(qvel)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 0, 1])
    p.add_argument("--traj_len", type=int, default=400)
    args = p.parse_args(argv)
    with open(pathlib.Path(args.path) / "experiment.pkl", "rb") as f:
        exp = pickle.load(f)
    if exp["env_name"].lower() not in ("walker2d", "walker2d-v0"):
        raise SystemExit("export_recurrent_draws: Walker2d run dirs only "
                         "(other envs draw at their steps)")
    env = env_factory(exp["env_name"])
    B = int(exp["num_procs"])
    rp = RecurrentPPO(env, PPOConfig(num_envs=B, max_traj_len=args.traj_len))
    state = load_checkpoint(args.path, rp.init(0))
    rets, lens = [], []
    for seed in args.seeds:
        t0 = time.time()
        ev = rp._eval_iter(state, jax.random.PRNGKey(seed))
        rets.append(float(ev["ep_return"]))
        lens.append(float(ev["ep_len"]))
        print(f"{args.path} seed {seed}: return {rets[-1]:.4f}, length "
              f"{lens[-1]:.2f} ({time.time() - t0:.0f} s)", flush=True)
    qpos, qvel = reset_draws(env, args.seeds[0], B)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        args.out, reset0_qpos=qpos, reset0_qvel=qvel, batch=np.int64(B),
        steps=np.int64(args.traj_len), seed=np.int64(args.seeds[0]),
        seeds=np.int64(args.seeds), jax_return=np.float64(rets[0]),
        jax_length=np.float64(lens[0]), jax_seed_returns=np.float64(rets),
        jax_seed_lengths=np.float64(lens))
    print(f"wrote {args.out} ({pathlib.Path(args.out).stat().st_size} B)")


if __name__ == "__main__":
    main()
