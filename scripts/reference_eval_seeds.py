"""The JAX package's deterministic evaluation of a run directory at several
seeds: `apex.py eval`'s protocol (`apex_tpu/runtime/evaluate.py`
eval_checkpoint: `init_runner` and then `rollout_scan` with the
deterministic policy) with `jax.random.PRNGKey(seed)` in place of its fixed
PRNGKey(42). These are the JAX figures the port's evaluation is compared
with. Runs on the CPU:

    JAX_PLATFORMS=cpu python scripts/reference_eval_seeds.py \
        --path curves/cassie_mk5c_ckpt --seeds 42 0 1 \
        --n_episodes 64 --traj_len 300
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from apex_tpu.agents.rollout import init_runner, rollout_scan  # noqa: E402
from apex_tpu.runtime.evaluate import load_experiment  # noqa: E402


def eval_seed(ppo, state, seed: int, n_episodes: int, traj_len: int):
    """eval_checkpoint's body with PRNGKey(seed): (mean return, mean
    length) of the episodes that finished."""
    env = ppo.env

    def policy_fn(_, obs):
        return state.actor.act(state.norm, obs, deterministic=True)

    runner = init_runner(env, jax.random.PRNGKey(seed), n_episodes)
    _, traj = jax.jit(
        lambda r: rollout_scan(env, policy_fn, r, traj_len, traj_len))(runner)
    n_done = int(jnp.sum(traj.done_ep_len > 0))
    return (float(jnp.sum(traj.done_ep_return) / max(n_done, 1)),
            float(jnp.sum(traj.done_ep_len) / max(n_done, 1)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 0, 1])
    p.add_argument("--n_episodes", type=int, default=64)
    p.add_argument("--traj_len", type=int, default=300)
    args = p.parse_args(argv)
    ppo, state, _ = load_experiment(args.path)
    rets = []
    for seed in args.seeds:
        t0 = time.time()
        ret, ln = eval_seed(ppo, state, seed, args.n_episodes, args.traj_len)
        rets.append(ret)
        print(f"{args.path} seed {seed}: mean return {ret:.4f}, mean length "
              f"{ln:.2f} ({time.time() - t0:.0f} s)", flush=True)
    print(f"{args.path}: mean over seeds {args.seeds}: "
          f"{sum(rets) / len(rets):.4f}", flush=True)


if __name__ == "__main__":
    main()
