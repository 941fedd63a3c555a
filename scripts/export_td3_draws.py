"""JAX's deterministic evaluation of a TD3 actor on Walker2d, on the CPU, and
the draws it used, saved beside the actor and normaliser for the port's
evaluation (`scripts/torch_eval_td3.py`).

The actor comes from a JAX `TD3TrainState` checkpoint (a run dir or a
.pkl: the JAX package's `curves/td3_async_walker_ckpt`, or a port run's,
whose leaves are the same) or from an .npz of this script or of
`torch_eval_td3.py --export`. The evaluation is `TD3._evaluate`'s protocol
(`init_runner` with PRNGKey(seed), then `rollout_scan` of the
deterministic actor, 64 envs for 400 steps, auto-reset) and its figure the
mean return of the episodes that ended. The file holds the actor's six
leaves (`actor_0` .. `actor_5`, (in, out) weights), the normaliser
(`norm_mean`, `norm_var`, `norm_count`), and, sparsely, the reset draws
the run used: the first fleet's (`reset0_qpos`, `reset0_qvel`, U(-1, 1) per
env, batch-first) and each auto-reset's rows of the envs that ended at
that step (`reset_step`, `reset_env`, `reset_qpos`, `reset_qvel`;
`scripts/export_eval_draws.eval_draws`); Walker2d's step draws nothing.
`chip_smoke.jax_draws` replays them. The leaves are read by the port's
`runtime.checkpoint.td3_actor_leaves` (numpy and pickle only).

With --spread N it runs the same evaluation N more times with the first
fleet's qpos (all but the x slide) changed by random factors 1 +- 1e-6
(the repo's measure of chaotic divergence, ROADMAP limit (a)) and saves
those returns as `jax_perturbed_returns`.

    JAX_PLATFORMS=cpu python scripts/export_td3_draws.py \\
        --path curves/td3_async_walker_ckpt \\
        --out curves/jax_eval_draws/td3_async_walker.npz --spread 4
"""
import argparse
import importlib.util
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from apex_tpu.agents.rollout import init_runner, rollout_scan  # noqa: E402
from apex_tpu.envs.walker2d import Walker2dEnv  # noqa: E402
from apex_tpu.models.nets import FFActor, NormState  # noqa: E402
from apex_tpu_torch.runtime.checkpoint import (  # noqa: E402
    TD3_ACTOR_LEAVES,
    TD3_NPZ_KEYS,
    td3_actor_leaves,
)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_actor(leaves, env):
    """(FFActor, NormState) of the JAX package from the actor's leaves and
    the normaliser's."""
    template = FFActor.init(jax.random.PRNGKey(0), env.observation_size,
                            env.action_size)
    treedef = jax.tree_util.tree_structure(template.params)
    actor = FFActor(params=jax.tree_util.tree_unflatten(
        treedef, [np.asarray(x) for x in leaves[:TD3_ACTOR_LEAVES]]))
    norm = NormState(*(np.asarray(x) for x in leaves[TD3_ACTOR_LEAVES:]))
    return actor, norm


def stats(traj):
    done_len = np.asarray(traj.done_ep_len)
    n = max(int((done_len > 0).sum()), 1)
    return (float(np.asarray(traj.done_ep_return).sum() / n),
            float(done_len.sum() / n), done_len > 0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path", required=True,
                   help="a TD3 run dir, checkpoint.pkl or actor .npz")
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n_episodes", type=int, default=64)
    p.add_argument("--traj_len", type=int, default=400)
    p.add_argument("--spread", type=int, default=0)
    args = p.parse_args(argv)
    env = Walker2dEnv()
    leaves = td3_actor_leaves(args.path)
    actor, norm = jax_actor(leaves, env)
    B, T = args.n_episodes, args.traj_len

    def policy_fn(_, obs):
        return actor.act(norm, obs)

    t0 = time.time()
    runner0 = init_runner(env, jax.random.PRNGKey(args.seed), B)
    rollout = jax.jit(lambda r: rollout_scan(env, policy_fn, r, T, T))
    ret, length, done = stats(rollout(runner0)[1])
    print(f"{args.path} seed {args.seed}: mean return {ret:.4f}, mean "
          f"length {length:.2f} ({time.time() - t0:.0f} s)", flush=True)
    out = _load("export_eval_draws").eval_draws(env, done, args.seed)
    out.update({k: np.asarray(x, np.float32)
                for k, x in zip(TD3_NPZ_KEYS, leaves)})
    out.update(jax_return=np.float64(ret), jax_length=np.float64(length))
    if args.spread:
        rng_np = np.random.default_rng(0)
        moved = []
        for _ in range(args.spread):
            q = runner0.env_state.qpos
            scale = np.ones(q.shape, np.float32)
            scale[:, 1:] += 1e-6 * rng_np.choice([-1.0, 1.0],
                                                 size=q[:, 1:].shape)
            r = runner0.replace(env_state=runner0.env_state.replace(
                qpos=q * scale))
            moved.append(stats(rollout(r)[1])[0])
            print(f"  perturbed 1e-6: mean return {moved[-1]:.4f}",
                  flush=True)
        out["jax_perturbed_returns"] = np.float64(moved)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({pathlib.Path(args.out).stat().st_size} B)")


if __name__ == "__main__":
    main()
