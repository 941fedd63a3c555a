"""Policy-level divergence between the port's three physics tiers: the
counterpart of tools/megakernel_divergence.py, with the same arguments,
printed lines and closing JSON line.

The deterministic eval return / episode length of one checkpoint under the
same seed (`init_runner` with seed 42, then `rollout_scan` for --steps
steps, auto-resetting), on each PD tier of `physics/cassie_sim.py`
(`PD_TIERS`, picked through `load_experiment(path, physics=...)` where the
JAX tool sets its APEX_TPU_* variables):

  megakernel  the whole-substep kernel K1 (K2 for the foot positions and
              the resets)
  fleet       the batch-last fleet step (K2 and K3 every substep)
  per-env     the per-env engine (the inverse of M + hD through K3-bf)

With --jax_draws FILE every tier runs on the draws of JAX's own
evaluation (a file of `scripts/export_eval_draws.py` for this protocol:
--seed 42, --n_episodes ENVS, --traj_len STEPS; `chip_smoke.jax_draws`
replays it), and JAX's return on them is printed beside the megakernel
tier's. On the card each tier's kernel launches are printed after its
line (`device.count_launches`).

Usage: python scripts/torch_megakernel_divergence.py <ckpt_dir>
           [--envs 64] [--steps 300] [--skip-per-env]
           [--jax_draws FILE] [--device cpu]
It runs on the card unless --device cpu is given.
"""
import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import (card_line, count_launches,  # noqa: E402
                                   resolve_device)

# the JAX tool's mode names and the port's PD tiers
TIERS = {"megakernel": "megakernel", "fleet": "fleet", "per-env": "per_env"}


def run_mode(path, mode, n_envs, steps, device, jax_draws=None):
    """The deterministic evaluation of `path` on one tier: JAX's summary
    (episodes finished, their mean return and length, rounded as the JAX
    tool rounds them)."""
    from apex_tpu_torch.agents.rollout import init_runner, rollout_scan
    from apex_tpu_torch.runtime.evaluate import load_experiment

    exp = load_experiment(path, device=device, physics=TIERS[mode])
    env = exp.env

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    ctx = contextlib.nullcontext()
    if jax_draws:
        from chip_smoke import jax_draws as replay

        ctx = replay(jax_draws)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(42)
    with torch.no_grad(), ctx:
        runner = init_runner(env, gen, n_envs)
        _, traj = rollout_scan(env, policy_fn, runner, gen, steps, steps)
    n_done = int(torch.sum(traj.done_ep_len > 0))
    ep_ret = float(torch.sum(traj.done_ep_return) / max(n_done, 1))
    ep_len = float(torch.sum(traj.done_ep_len) / max(n_done, 1))
    return {"episodes": n_done, "return": round(ep_ret, 3),
            "ep_len": round(ep_len, 2)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--skip-per-env", action="store_true",
                    help="the per-env tier is slow; skip for quick runs")
    ap.add_argument("--jax_draws", default=None,
                    help="npz of scripts/export_eval_draws.py (seed 42, "
                    "--envs envs, --steps steps)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    jax_ret = None
    if args.jax_draws:
        with np.load(args.jax_draws) as f:
            batch, steps, seed = (int(f[k]) for k in ("batch", "steps",
                                                       "seed"))
            jax_ret = float(f["jax_return"])
        if (batch, steps, seed) != (args.envs, args.steps, 42):
            raise SystemExit(f"{args.jax_draws} holds the draws of {batch} "
                             f"envs x {steps} steps, not of --envs "
                             f"{args.envs} x --steps {args.steps} at seed 42")
    if device.type == "cuda":
        print("card:", card_line(), flush=True)

    modes = ["megakernel", "fleet"]
    if not args.skip_per_env:
        modes.append("per-env")
    out, launches = {}, {}
    for mode in modes:
        run = lambda: run_mode(args.ckpt, mode, args.envs, args.steps,
                               device, args.jax_draws)
        if device.type == "cuda":
            out[mode], secs, launches[mode] = count_launches(run)
        else:
            t0 = time.time()
            out[mode] = run()
            secs = time.time() - t0
        print(f"{mode:11s}: {out[mode]}", flush=True)
        print(f"  {secs:.1f} s" + (f", launches {launches[mode]}"
                                   if mode in launches else ""), flush=True)

    base = out["megakernel"]["return"]
    deltas = {
        m: round(abs(out[m]["return"] - base) / max(abs(base), 1e-9), 4)
        for m in modes if m != "megakernel"}
    if jax_ret is not None:
        print(f"JAX on the same draws: return {jax_ret:.4f}; megakernel "
              f"tier {100 * (base - jax_ret) / abs(jax_ret):+.2f} %",
              flush=True)
    result = {"ckpt": args.ckpt, "envs": args.envs, "steps": args.steps,
              "results": out, "return_rel_delta_vs_megakernel": deltas}
    print(json.dumps(result))
    return result, launches


if __name__ == "__main__":
    main()
