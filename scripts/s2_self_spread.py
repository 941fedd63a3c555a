"""How far a 5k cell of the port moves against itself under rounding-level
changes of its start: the cell run as it is, then again with every env's
reset qpos scaled by 1 + 1e-6 s (s = +-1, one draw per element and seed),
the way ROADMAP.md's limit (a) measures the JAX fleet against itself.

    python3 scripts/s2_self_spread.py --ckpt curves/cassie_mk5c_ckpt \\
        --mission 90_left --speed 0.5 --seeds 1 2 3 4 \\
        --out chiprun_out/s2_self_spread.json

With --subset TERRAIN..., each run's rate over those terrains' trials
too, and their self-spread.

Prints each run's pass rate and its flips against the unperturbed run,
beside the committed pass tensors of the JAX battery
(`curves/cassie_mk5c_eval/eval_5k.pkl`) and the port's
(`curves/torch_cassie_mk5c_eval/eval_5k.pkl`) for the same cell, and the
card's name and power limit. Runs on the GPU (about a minute a run at
3,971 envs).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from apex_tpu_torch.device import card_line  # noqa: E402
from apex_tpu_torch.runtime import eval_suites  # noqa: E402
from apex_tpu_torch.runtime.evaluate import load_experiment  # noqa: E402


def committed_cell(path: str, mission: str, speed: float):
    """The cell's pass flags (terrain, friction, foot mass order,
    flattened) in a committed eval_5k.pkl, or None."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        res = pickle.load(f)
    grid = res["grid"]
    mi = [str(m) for m in grid["missions"]].index(mission)
    si = [float(s) for s in grid["mission_speeds"]].index(speed)
    return np.asarray(res["passed"])[mi, si].ravel()


def perturbed_resets(env, rel: float, seed: int):
    """Wrap env.reset_for_test: the reset qpos scaled elementwise by
    1 + rel * s, s = +-1 drawn from a generator seeded with `seed`."""
    reset = env.reset_for_test

    def wrapped(*args, **kw):
        state, obs = reset(*args, **kw)
        gen = torch.Generator()
        gen.manual_seed(seed)
        q = state.phys.qpos
        s = torch.randint(0, 2, tuple(q.shape), generator=gen) * 2.0 - 1.0
        phys = dataclasses.replace(state.phys,
                                   qpos=q * (1.0 + rel * s.to(q.device)))
        return dataclasses.replace(state, phys=phys), obs

    env.reset_for_test = wrapped


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default="curves/cassie_mk5c_ckpt")
    ap.add_argument("--mission", default="90_left")
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--rel", type=float, default=1e-6)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3, 4])
    ap.add_argument("--jax", default="curves/cassie_mk5c_eval/eval_5k.pkl")
    ap.add_argument("--port",
                    default="curves/torch_cassie_mk5c_eval/eval_5k.pkl")
    ap.add_argument("--subset", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("s2_self_spread: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, flush=True)

    jax_cell = committed_cell(args.jax, args.mission, args.speed)
    port_cell = committed_cell(args.port, args.mission, args.speed)
    rows = [list(eval_suites.DEFAULT_5K_TERRAINS).index(t)
            for t in args.subset]
    # the cell flattened terrain-major: 361 trials a terrain
    per = 19 * 19
    sub = np.zeros(len(eval_suites.DEFAULT_5K_TERRAINS) * per, bool)
    for r in rows:
        sub[r * per:(r + 1) * per] = True
    runs = []
    base = None
    for seed in [None] + list(args.seeds):
        exp = load_experiment(args.ckpt)
        if not exp.env.model.enable_hfield:
            raise ValueError("the 5k cells need a heightfield env")
        if seed is not None:
            perturbed_resets(exp.env, args.rel, seed)

        def policy_fn(obs):
            return exp.actor.act(exp.norm, obs, deterministic=True)

        t0 = time.time()
        res = eval_suites.eval_5k_matrix(
            policy_fn, exp.env, missions=(args.mission,),
            mission_speeds=(args.speed,))
        secs = time.time() - t0
        passed = res["passed"][0, 0].ravel()
        if base is None:
            base = passed
        run = dict(seed=seed, pass_rate=float(passed.mean()),
                   only_here=int((passed & ~base).sum()),
                   only_unperturbed=int((base & ~passed).sum()),
                   n_nonfinite=res["n_nonfinite"], seconds=round(secs, 1))
        if jax_cell is not None:
            run.update(only_here_vs_jax=int((passed & ~jax_cell).sum()),
                       only_jax=int((jax_cell & ~passed).sum()))
        if rows:
            run["subset_pass_rate"] = float(passed[sub].mean())
        runs.append(run)
        print(json.dumps(run), flush=True)

    rates = [r["pass_rate"] for r in runs]
    rate = lambda c: None if c is None else float(c.mean())
    jax_rate, port_rate = rate(jax_cell), rate(port_cell)
    summary = dict(
        card=card, ckpt=args.ckpt, cell=f"{args.mission}_{args.speed}",
        envs=int(base.size), rel=args.rel, runs=runs,
        self_spread=max(rates) - min(rates),
        largest_move=max(abs(r - rates[0]) for r in rates),
        committed_jax=jax_rate, committed_port=port_rate,
        committed_gap=(None if jax_rate is None or port_rate is None
                       else port_rate - jax_rate),
        unperturbed_is_committed_port=(
            None if port_cell is None else bool(np.array_equal(base,
                                                               port_cell))))
    if rows:
        sub_rates = [r["subset_pass_rate"] for r in runs]
        summary.update(
            subset=args.subset, subset_envs=int(sub.sum()),
            subset_self_spread=max(sub_rates) - min(sub_rates),
            subset_committed_jax=(None if jax_cell is None
                                  else float(jax_cell[sub].mean())),
            subset_committed_port=(None if port_cell is None
                                   else float(port_cell[sub].mean())))
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
