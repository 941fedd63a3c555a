"""Mirror-symmetry consistency of a trained policy: the counterpart of
tools/mirror_policy_check.py, with the same arguments and printed line.

Over the observations of a deterministic 16-env rollout (`init_runner`
with seed 0, then `rollout_scan` for --steps steps, auto-resetting), the
distance ||M_act pi(M_obs s) - pi(s)|| between the action and the
mirrored action of the mirrored observation (the clock advanced half a
period where the env has one), from `envs/base.py`'s `mirror_matrix` and
`mirror_clock`: its mean, 95th percentile and largest value.

With --jax_draws FILE the rollout runs on the draws of JAX's (a file of
`scripts/export_eval_draws.py --seed 0 --n_episodes 16 --traj_len STEPS`;
`chip_smoke.jax_draws` replays it).

Usage: python scripts/torch_mirror_policy_check.py <run_dir> [--steps 200]
           [--jax_draws FILE] [--device cpu]
It runs on the card unless --device cpu is given.
"""
import argparse
import contextlib
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import resolve_device  # noqa: E402

N_ENVS = 16


def mirror_err(exp, obs: torch.Tensor) -> np.ndarray:
    """||M_act pi(M_obs s) - pi(s)|| per observation (B, obs_dim)."""
    from apex_tpu_torch.envs.base import mirror_clock, mirror_matrix

    env = exp.env
    M_obs = torch.as_tensor(mirror_matrix(env.mirrored_obs),
                            device=obs.device)
    M_act = torch.as_tensor(mirror_matrix(env.mirrored_acts),
                            device=obs.device)
    with torch.no_grad():
        a = exp.actor.act(exp.norm, obs, deterministic=True)
        mo = obs @ M_obs
        if env.clock_inds:
            mo = mirror_clock(mo, env.clock_inds)
        am = exp.actor.act(exp.norm, mo, deterministic=True) @ M_act
        return torch.linalg.vector_norm(a - am, dim=-1).cpu().numpy()


def rollout_obs(exp, steps: int, jax_draws=None) -> torch.Tensor:
    """The observations (steps * 16, obs_dim) of the 16-env rollout."""
    from apex_tpu_torch.agents.rollout import init_runner, rollout_scan

    env = exp.env

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    ctx = contextlib.nullcontext()
    if jax_draws:
        from chip_smoke import jax_draws as replay

        ctx = replay(jax_draws)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(0)
    with torch.no_grad(), ctx:
        runner = init_runner(env, gen, N_ENVS)
        _, traj = rollout_scan(env, policy_fn, runner, gen, steps, steps)
    return traj.obs.reshape(-1, env.observation_size)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--jax_draws", default=None,
                    help="npz of scripts/export_eval_draws.py (seed 0, 16 "
                    "envs, --steps steps)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from apex_tpu_torch.runtime.evaluate import load_experiment

    args = parse_args(argv)
    device = resolve_device(args.device)
    exp = load_experiment(args.path, device=device)
    if exp.env.mirrored_obs is None:
        print("env has no mirror tables")
        sys.exit(1)
    err = mirror_err(exp, rollout_obs(exp, args.steps, args.jax_draws))
    print(f"mirror consistency over {len(err)} states: "
          f"mean {err.mean():.4f}  p95 {np.percentile(err, 95):.4f}  "
          f"max {err.max():.4f}")
    return err


if __name__ == "__main__":
    main()
