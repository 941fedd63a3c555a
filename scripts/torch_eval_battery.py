"""Run the behavioral eval battery on a trained checkpoint with the PyTorch
port, on the GPU: the counterpart of tools/run_eval_battery.py, with the
same suites, grids and arguments, writing summary.json in the same layout
so that the two files compare key by key.

Usage: python scripts/torch_eval_battery.py <ckpt_dir> [--out DIR]
           [--skip 5k,mission,...] [--quick]

Writes into <out> (default curves/torch_<ckpt-name>_eval/):
  eval_perturbs.npz (+ perturb.pdf)  push survival matrix (max_force 350)
  eval_commands.npz                  10,000 command trials, pass/fail
  eval_mission_<m>.npz               the five missions' error traces
  eval_5k.pkl (+ 5k.pdf)             the full robustness matrix
  summary.json                       headline numbers, as the JAX file's,
                                     plus the card, the launches of each
                                     kernel per suite and the envs that
                                     went non-finite (which ones:
                                     scripts/replay_nonfinite.py replays
                                     them)
The PDFs need matplotlib and are skipped without it. Every suite is one
fleet on the card (commands 10,000 envs, a 5k cell 3,971); wall_s is the
port's time on this run's card. It needs a CUDA device.
"""
import argparse
import json
import pathlib
import pickle
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import card_line, count_launches  # noqa: E402
from apex_tpu_torch.runtime import eval_suites, report  # noqa: E402
from apex_tpu_torch.runtime.evaluate import load_experiment  # noqa: E402


def try_pdf(write, *args):
    try:
        write(*args)
    except ImportError as e:
        print("pdf skipped:", e)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip", default="",
                    help="comma list of suites to skip (perturb,commands,"
                    "5k,mission)")
    ap.add_argument("--quick", action="store_true",
                    help="smaller grids (smoke-scale)")
    args = ap.parse_args()
    skip = set(s for s in args.skip.split(",") if s)

    ckpt = pathlib.Path(args.ckpt)
    out = pathlib.Path(args.out) if args.out else (
        ckpt.parent / ("torch_" + ckpt.name.replace("_ckpt", "") + "_eval"))
    out.mkdir(parents=True, exist_ok=True)

    exp = load_experiment(str(ckpt), device="cuda")
    env = exp.env

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    summary = {"ckpt": str(ckpt), "card": card_line(),
               "torch": torch.__version__}
    print("card:", summary["card"], flush=True)

    if "perturb" not in skip:
        kw = (dict(num_angles=4, num_phases=2) if args.quick
              else dict(max_force=350.0))
        res, secs, n = count_launches(
            lambda: eval_suites.eval_perturbation(env, policy_fn, **kw))
        np.savez(out / "eval_perturbs.npz", angles=res["angles"],
                 forces=res["forces"], survival=res["survival"],
                 max_force_per_angle=res["max_force_per_angle"])
        try_pdf(report.report_perturbation, res, str(out / "perturb.pdf"))
        summary["perturb"] = {
            "max_force_per_angle":
                [float(v) for v in res["max_force_per_angle"]],
            "mean_max_force": float(np.mean(res["max_force_per_angle"])),
            "n_nonfinite": res["n_nonfinite"], "launches": n,
            "wall_s": round(secs, 1)}
        print("perturb:", summary["perturb"], flush=True)

    if "commands" not in skip:
        kw = (dict(n_trials=8, n_commands=2) if args.quick
              else dict(n_trials=10000))
        res, secs, n = count_launches(
            lambda: eval_suites.eval_commands(env, policy_fn, **kw))
        np.savez(out / "eval_commands.npz",
                 **{k: v for k, v in res.items()
                    if isinstance(v, np.ndarray)})
        summary["commands"] = {k: float(v) for k, v in res.items()
                               if np.ndim(v) == 0}
        nt = len(res["passed"])
        p = float(res["passed"].mean())
        summary["commands"]["n_trials"] = nt
        summary["commands"]["ci95"] = round(
            1.96 * (p * (1 - p) / max(nt, 1)) ** 0.5, 4)
        summary["commands"]["nonfinite_trials"] = [
            int(t) for t in res["nonfinite_trials"]]
        summary["commands"]["launches"] = n
        summary["commands"]["wall_s"] = round(secs, 1)
        print("commands:", summary["commands"], flush=True)

    if "mission" not in skip:
        missions = (("default",) if args.quick
                    else eval_suites.BATTERY_MISSIONS)
        res, secs, n = count_launches(lambda: eval_suites.eval_missions(
            eval_suites.playground_policy(exp), missions,
            simrate=env.simrate))
        mres = {}
        for m in missions:
            np.savez(out / f"eval_mission_{m}.npz",
                     **{k: v for k, v in res[m].items()
                        if isinstance(v, np.ndarray)})
            mres[m] = {k: float(v) for k, v in res[m].items()
                       if np.ndim(v) == 0}
            print(f"mission {m}:", mres[m], flush=True)
        summary["missions"] = mres
        summary["missions_launches"] = n
        summary["missions_wall_s"] = round(secs, 1)

    if "5k" not in skip:
        kw = {}
        if args.quick:
            kw = dict(missions=("straight",), mission_speeds=(1.4,),
                      terrains=("flat", "noise1"), frictions=(1.0,),
                      foot_mass_scales=(1.0,), max_steps=60)
        t_start = time.time()

        def on_cell(mission, speed, passed, secs):
            print(f"5k cell {mission}_{speed}: pass rate "
                  f"{float(passed.mean()):.4f}, {secs:.1f} s, "
                  f"{time.time() - t_start:.0f} s so far", flush=True)

        res, secs, n = count_launches(lambda: eval_suites.eval_5k_matrix(
            policy_fn, env, on_cell=on_cell, **kw))
        with open(out / "eval_5k.pkl", "wb") as f:
            pickle.dump(res, f)
        try_pdf(report.report_5k, res, str(out / "5k.pdf"))
        summary["5k"] = {"pass_rate": float(res["pass_rate"])}
        if "pass_rate_ref_subset" in res:
            summary["5k"]["pass_rate_ref_subset"] = float(
                res["pass_rate_ref_subset"])
        for ax in ("by_mission", "by_speed", "by_terrain", "by_friction",
                   "by_foot_mass"):
            summary["5k"][ax] = {str(k): round(float(v), 3)
                                 for k, v in res[ax].items()}
        summary["5k"]["n_nonfinite"] = res["n_nonfinite"]
        summary["5k"]["nonfinite_trials"] = [
            [m, float(sp), t, float(fr), float(fm)]
            for m, sp, t, fr, fm in res["nonfinite_trials"]]
        summary["5k"]["policy_steps"] = res["policy_steps"]
        summary["5k"]["launches"] = n
        summary["5k"]["wall_s"] = round(secs, 1)
        print("5k:", summary["5k"], flush=True)

    with open(out / "summary.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    print(f"artifacts in {out}")


if __name__ == "__main__":
    main()
