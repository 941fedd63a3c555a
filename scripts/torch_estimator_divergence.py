"""Sensitivity of a trained policy to the state estimator: the counterpart
of tools/estimator_divergence.py, with the same arguments, rows, printed
lines and closing JSON line.

A checkpoint's policy is evaluated on CassieEnv (dynamics randomization
off, the run's reward) under five estimator settings, the JAX tool's rows:

  "exact"                  CassieEnv() with the env's defaults
  "firmware tau=12ms"      estimator="firmware"
  "firmware tau=25ms"      estimator_tau=0.025
  "firmware + noise 0.02"  estimator_noise=0.02
  "firmware + noise 0.05"  estimator_noise=0.05

Each row: --episodes envs reset once, commanded to walk forward at 1.0 m/s
(side speed 0; the reset's observation kept), --steps steps of the
deterministic policy with no auto-reset; an env's return and length stop
growing after the step it falls at. The rows print their mean return and
length, the JSON line each row's delta from the first.

The env's default estimator is the firmware one with tau 12 ms
(`envs/cassie.py`, as the JAX package's), so the JAX tool's "exact" row is
the same configuration as its "firmware tau=12ms" row and every delta is
taken against the firmware estimator; this script keeps the JAX tool's
rows and labels (ROADMAP limit (k)).

Each row draws from seed 17 as the JAX tool's does, on a torch.Generator;
with --jax_draws FILE every row runs on the draws of JAX's run (a file of
`scripts/export_tool_draws.py estimator`; `chip_smoke.file_draws` replays
it), and JAX's rows, where the file holds them, are printed beside.

Usage: python scripts/torch_estimator_divergence.py <run_dir>
           [--episodes 32] [--steps 300] [--jax_draws FILE] [--device cpu]
It runs on the card unless --device cpu is given.
"""
import argparse
import dataclasses
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import card_line, resolve_device  # noqa: E402
from apex_tpu_torch.envs import cassie  # noqa: E402

# the JAX tool's rows (tools/estimator_divergence.py)
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
SEED = 17


@torch.no_grad()
def evaluate(env, policy_fn, episodes: int, steps: int, draws):
    """Mean return and length of `episodes` envs over `steps` steps at 1.0
    m/s, no auto-reset (the JAX tool's `evaluate`)."""
    reset_noise, step_noise = draws(SEED, episodes, steps)
    state, obs = env.reset(reset_noise)
    state = dataclasses.replace(
        state, speed=torch.full_like(state.speed, 1.0),
        side_speed=torch.zeros_like(state.side_speed))
    done = torch.zeros((episodes,), dtype=torch.bool, device=obs.device)
    ret = torch.zeros((episodes,), device=obs.device)
    length = torch.zeros((episodes,), dtype=torch.int32, device=obs.device)
    for t in range(steps):
        state, obs, r, term = env.step(state, policy_fn(obs), step_noise[t])
        ret = ret + torch.where(done, 0.0, r)
        length = length + torch.where(done, 0, 1).to(torch.int32)
        done = done | term
    return float(torch.mean(ret)), float(torch.mean(length.float()))


def rows(exp, episodes: int, steps: int, device, jax_draws=None):
    """The five rows, [{"estimator", "eval_return", "eval_len",
    "return_delta_pct" (all but the first)}], and their unrounded mean
    returns."""
    from apex_tpu_torch.runtime.analysis import generator_draws

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    base = dict(dynamics_randomization=False,
                reward=getattr(exp.args, "reward", "early_clock"))
    out, raw = [], []
    for label, kw in ROWS:
        env = cassie.CassieEnv(device=device, **base, **kw)
        if jax_draws:
            from chip_smoke import file_draws

            draws = file_draws(jax_draws, env)
        else:
            draws = generator_draws(env)
        ret, length = evaluate(env, policy_fn, episodes, steps, draws)
        raw.append(ret)
        out.append({"estimator": label, "eval_return": round(ret, 2),
                    "eval_len": round(length, 1)})
        print(f"{label:24s} return {ret:8.2f}  len {length:6.1f}",
              flush=True)
    ref = out[0]["eval_return"]
    for r in out[1:]:
        r["return_delta_pct"] = round(
            100.0 * (r["eval_return"] - ref) / max(abs(ref), 1e-9), 1)
    return out, raw


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--episodes", type=int, default=32)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--jax_draws", default=None,
                    help="npz of scripts/export_tool_draws.py estimator")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from apex_tpu_torch.runtime.evaluate import load_experiment

    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print("card:", card_line(), flush=True)
    exp = load_experiment(args.run_dir, device=device)
    out, raw = rows(exp, args.episodes, args.steps, device, args.jax_draws)
    if args.jax_draws:
        with np.load(args.jax_draws) as f:
            jax_rows = {k: f[k] for k in f if k.startswith("jax_")}
        for i, ret, ln in zip(jax_rows.get("jax_rows", ()),
                              jax_rows.get("jax_return", ()),
                              jax_rows.get("jax_len", ())):
            print(f"JAX {ROWS[i][0]:24s} return {ret:8.2f}  len {ln:6.1f};"
                  f" port {100 * (raw[i] - ret) / abs(ret):+.2f} %",
                  flush=True)
    print(json.dumps(out))
    return out, raw


if __name__ == "__main__":
    main()
