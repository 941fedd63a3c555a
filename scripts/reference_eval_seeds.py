"""The JAX package's deterministic evaluation of a run directory at several
seeds: `apex.py eval`'s protocol (`apex_tpu/runtime/evaluate.py`
eval_checkpoint: `init_runner` and then `rollout_scan` with the
deterministic policy) with `jax.random.PRNGKey(seed)` in place of its fixed
PRNGKey(42). These are the JAX figures the port's evaluation is compared
with. Runs on the CPU:

    JAX_PLATFORMS=cpu python scripts/reference_eval_seeds.py \
        --path curves/cassie_mk5c_ckpt --seeds 42 0 1 \
        --n_episodes 64 --traj_len 300

Checkpoints saved before the env state gained its phase_add leaf
(`curves/cassie_main_ckpt`, `cassie_main2_ckpt`, `cassie_mk3_ckpt`: 87
leaves against the template's 88) load through `load_experiment_lenient`:
the leading leaves that agree with the template in shape (the policy, the
value net, the normalizer, the optimizer states) come from the
checkpoint, the rest (the runner's env state, which the evaluation
replaces with a fresh fleet) from the template.
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from apex_tpu.agents.rollout import init_runner, rollout_scan  # noqa: E402
from apex_tpu.runtime import checkpoint  # noqa: E402
from apex_tpu.runtime.evaluate import load_experiment  # noqa: E402


def load_experiment_lenient(path: str):
    """`load_experiment`, and for a checkpoint whose leaf count differs
    from the template's, its leading leaves of the template's shapes over
    the template (see the module docstring)."""
    import pickle

    real = checkpoint.load_checkpoint

    def lenient(ckpt_path, template, name="checkpoint.pkl"):
        with open(pathlib.Path(ckpt_path) / name, "rb") as f:
            leaves = pickle.load(f)
        t_leaves, treedef = jax.tree_util.tree_flatten(template)
        if len(leaves) == len(t_leaves):
            return real(ckpt_path, template, name)
        n = next(i for i, (a, b) in enumerate(zip(leaves, t_leaves))
                 if np.shape(a) != np.shape(b))
        merged = [np.asarray(x, np.asarray(t).dtype)
                  for x, t in zip(leaves[:n], t_leaves)] + t_leaves[n:]
        return jax.tree_util.tree_unflatten(treedef, merged)

    checkpoint.load_checkpoint = lenient
    try:
        return load_experiment(path)
    finally:
        checkpoint.load_checkpoint = real


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
    ppo, state, _ = load_experiment_lenient(args.path)
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
