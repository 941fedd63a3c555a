"""Settle where an eval battery's state went non-finite: replay each such
trial on the card, in its battery fleet and alone, and hold its blow-up to
each physics path of the port.

`scripts/torch_eval_battery.py` records which trials went non-finite: the
command suite's trial indices (`nonfinite_trials` of eval_commands.npz)
and the 5k matrix's (mission, speed, terrain, friction, foot mass) cells
(`nonfinite_trials` of eval_5k.pkl). For each:

  fleet run  the suite again as the battery ran it (the command suite's
             10,000 trials, or the trial's whole 5k cell), on the
             megakernel tier (K1), recording each step's state, actions
             and draws: the step at which the trial's state first left
             the finite numbers;
  snapshot   from the trial's state SNAPSHOT steps before that, its column
             alone stepped again with the fleet run's actions and draws
             through K1, through K1's plain PyTorch version on the card,
             and through the fleet tier (K2 + K3): the replayed step at
             which each path goes non-finite, and its largest |qvel|;
  alone      the trial as a fleet of one env on K1 (a command trial with
             its column of the whole fleet's draws), its own policy
             evaluations: whether it goes non-finite at all.

Writes the outcomes, and each command trial's draws (for the JAX side,
`scripts/jax_trial.py`), to a JSON file; with --snapshots, each blow-up's
snapshot state and actions, which `scripts/jax_trial.py --snapshot` steps
through the JAX env.

    python3 scripts/torch_eval_battery.py curves/cassie_mk5c_ckpt \\
        --skip perturb,mission --out out_mk5c
    python3 scripts/replay_nonfinite.py curves/cassie_mk5c_ckpt out_mk5c \\
        --out s1_mk5c.json --snapshots s1_snapshots
"""
import argparse
import collections
import contextlib
import dataclasses
import json
import pathlib
import pickle
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import card_line  # noqa: E402
from apex_tpu_torch.envs.cassie import CassieEnv  # noqa: E402
from apex_tpu_torch.physics import fleet_kernel  # noqa: E402
from apex_tpu_torch.runtime import eval_suites  # noqa: E402
from apex_tpu_torch.runtime.evaluate import load_experiment  # noqa: E402
from apex_tpu_torch.utils.tree import tree_map  # noqa: E402

SNAPSHOT = 5      # steps before the first non-finite state replayed


@contextlib.contextmanager
def plain_k1():
    """The megakernel tier with K1's plain version in place of the kernel."""
    saved = fleet_kernel.pd_substep
    fleet_kernel.pd_substep = (
        lambda m, p, q, v, rows, static=None:
        fleet_kernel.pd_substep_plain(m, p, q, v, rows))
    try:
        yield
    finally:
        fleet_kernel.pd_substep = saved


@contextlib.contextmanager
def column(env, trial: int, n_trials: int):
    """The command suite at one trial: the suite's command draws and every
    step's draws are taken for the whole fleet of `n_trials`, as in the
    battery, and only column `trial` is handed on."""
    draws_fn = eval_suites.sample_command_draws
    step_fn = env.sample_step_noise
    pick = lambda nt: type(nt)(*(None if x is None else x[..., [trial]]
                                 for x in nt))
    eval_suites.sample_command_draws = (
        lambda g, n, k, device=None: eval_suites.CommandDraws(
            *(x[[trial]] for x in draws_fn(g, n_trials, k, device))))
    env.sample_step_noise = lambda g, b: pick(step_fn(g, n_trials))
    try:
        yield
    finally:
        eval_suites.sample_command_draws = draws_fn
        del env.sample_step_noise


@contextlib.contextmanager
def recorder(method: str, column: int):
    """Wrap CassieEnv.<method> (step or step_basic): counts the steps, and
    at the first step where env `column`'s qpos leaves the finite numbers
    keeps the last SNAPSHOT + 1 calls' (env, state, action, draws) of that
    column, and which envs of the fleet were non-finite then."""
    rec = dict(t=0, first_bad=None, snapshot=None, bad_envs=None)
    ring = collections.deque(maxlen=SNAPSHOT + 1)
    orig = getattr(CassieEnv, method)
    col = lambda x: x[..., [column]]

    def wrapped(self, state, action, *rest):
        if rec["first_bad"] is None:
            ring.append((self, tree_map(col, state), action[[column]],
                         tuple(type(r)(*(None if x is None else col(x)
                                         for x in r)) for r in rest)))
        out = orig(self, state, action, *rest)
        if rec["first_bad"] is None:
            bad = ~torch.isfinite(out[0].phys.qpos).all(dim=0)
            if bool(bad[column]):
                rec["first_bad"], rec["snapshot"] = rec["t"], list(ring)
                rec["bad_envs"] = torch.nonzero(bad).flatten().tolist()
        rec["t"] += 1
        return out

    setattr(CassieEnv, method, wrapped)
    try:
        yield rec
    finally:
        setattr(CassieEnv, method, orig)


@torch.no_grad()
def replay_snapshot(snapshot, method: str):
    """The snapshot's steps again from its first state with its actions and
    draws, through K1, K1's plain version and the fleet tier: per path, the
    replayed step at which qpos went non-finite (None: stayed finite) and
    the largest |qvel| after each step."""
    env, state0 = snapshot[0][0], snapshot[0][1]
    envs = {"k1": env, "plain": env,
            "fleet": dataclasses.replace(env, pd_tier="fleet")}
    out = {}
    for path, e in envs.items():
        ctx = plain_k1() if path == "plain" else contextlib.nullcontext()
        state, bad, vmax = state0, None, []
        with ctx:
            for i, (_, _, action, rest) in enumerate(snapshot):
                state = getattr(e, method)(state, action, *rest)[0]
                vmax.append(float(state.phys.qvel.abs().max()))
                if bad is None and not bool(
                        torch.isfinite(state.phys.qpos).all()):
                    bad = i
        out[path] = {"nonfinite_at_step": bad, "max_abs_qvel": vmax}
    return out


def save_snapshot(snapshot, method: str, path: str):
    """The snapshot's first state (batch-first numpy, the JAX state's
    fields) and its steps' actions, pickled for `scripts/jax_trial.py
    --snapshot`."""
    def arrays(x):
        if dataclasses.is_dataclass(x):
            return {f.name: arrays(getattr(x, f.name))
                    for f in dataclasses.fields(x)}
        return np.moveaxis(x.detach().cpu().numpy(), -1, 0)
    with open(path, "wb") as f:
        pickle.dump({"method": method, "state": arrays(snapshot[0][1]),
                     "actions": [a.cpu().numpy() for _, _, a, _ in
                                 snapshot]}, f)


def run_trial(ckpt, method, fleet_suite, column, alone_suite,
              snapshot_path=None):
    """The fleet run (recorded at `column`, its snapshot replayed on the
    three paths, and saved to snapshot_path) and the trial alone, on the
    megakernel tier."""
    exp = load_experiment(ckpt, device="cuda")

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    out = {}
    with recorder(method, column) as rec:
        fleet_suite(exp.env, policy_fn)
    out["fleet_run"] = dict(steps=rec["t"], first_nonfinite_step=rec[
        "first_bad"], nonfinite_envs_then=rec["bad_envs"])
    if rec["snapshot"] is not None:
        out["snapshot"] = dict(
            from_step=rec["first_bad"] - len(rec["snapshot"]) + 1,
            paths=replay_snapshot(rec["snapshot"], method))
        if snapshot_path:
            save_snapshot(rec["snapshot"], method, snapshot_path)
    with recorder(method, 0) as rec:
        res = alone_suite(exp.env, policy_fn)
    out["alone"] = dict(res, steps=rec["t"],
                        first_nonfinite_step=rec["first_bad"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("battery", help="the battery's output directory")
    ap.add_argument("--out", default=None)
    ap.add_argument("--snapshots", default=None,
                    help="directory for each blow-up's snapshot (state and "
                         "actions) for scripts/jax_trial.py --snapshot")
    args = ap.parse_args(argv)
    snap = lambda name: (None if args.snapshots is None else
                         str(pathlib.Path(args.snapshots) / f"{name}.pkl"))
    if args.snapshots:
        pathlib.Path(args.snapshots).mkdir(parents=True, exist_ok=True)
    if not torch.cuda.is_available():
        raise SystemExit("replay_nonfinite: needs a CUDA device")
    battery = pathlib.Path(args.battery)
    report = {"ckpt": args.ckpt, "card": card_line(), "commands": [],
              "5k": []}
    print("card:", report["card"], flush=True)

    trials, n_trials = [], 0
    if (battery / "eval_commands.npz").exists():
        with np.load(battery / "eval_commands.npz") as f:
            n_trials = len(f["passed"])
            if "nonfinite_trials" in f:
                trials = [int(t) for t in f["nonfinite_trials"]]
    for t in trials:
        def fleet_suite(env, policy_fn):
            return eval_suites.eval_commands(env, policy_fn,
                                             n_trials=n_trials)

        def alone_suite(env, policy_fn, t=t):
            with column(env, t, n_trials):
                res = eval_suites.eval_commands(env, policy_fn, n_trials=1)
            return {"finite": res["n_nonfinite"] == 0,
                    "passed": bool(res["passed"][0])}

        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        draws = eval_suites.sample_command_draws(gen, n_trials, 4, "cuda")
        rec = {"trial": t, "n_trials": n_trials,
               "draws": {k: getattr(draws, k)[t].tolist()
                         for k in draws._fields},
               **run_trial(args.ckpt, "step", fleet_suite, t, alone_suite,
                          snap(f"commands_{t}"))}
        report["commands"].append(rec)
        print("commands trial", json.dumps(rec), flush=True)

    cells = []
    if (battery / "eval_5k.pkl").exists():
        with open(battery / "eval_5k.pkl", "rb") as f:
            res5k = pickle.load(f)
        cells = res5k.get("nonfinite_trials", [])
        grid = res5k["grid"]
    for cell in cells:
        mission, speed, terrain, fric, fmass = cell
        # the trial's env in its cell's fleet: terrain-major, then
        # friction, then foot mass (eval_5k_matrix)
        b = ((list(grid["terrains"]).index(terrain)
              * len(grid["frictions"]) + list(grid["frictions"]).index(fric))
             * len(grid["foot_mass_scales"])
             + list(grid["foot_mass_scales"]).index(fmass))

        def fleet_suite(env, policy_fn, cell=cell):
            return eval_suites.eval_5k_matrix(
                policy_fn, env, missions=(cell[0],),
                mission_speeds=(cell[1],), terrains=grid["terrains"],
                frictions=grid["frictions"],
                foot_mass_scales=grid["foot_mass_scales"])

        def alone_suite(env, policy_fn, cell=cell):
            res = eval_suites.eval_5k_matrix(
                policy_fn, env, missions=(cell[0],),
                mission_speeds=(cell[1],), terrains=(cell[2],),
                frictions=(cell[3],), foot_mass_scales=(cell[4],))
            return {"finite": res["n_nonfinite"] == 0,
                    "passed": bool(res["pass_rate"] == 1.0)}

        rec = {"cell": [mission, float(speed), terrain, float(fric),
                        float(fmass)], "env_in_cell": b,
               **run_trial(args.ckpt, "step_basic", fleet_suite, b,
                           alone_suite, snap(f"5k_{b}"))}
        report["5k"].append(rec)
        print("5k trial", json.dumps(rec), flush=True)

    if not trials and not cells:
        print("no non-finite trial recorded", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
