"""Compare the port's eval battery results with the JAX package's, key by
key: the summary.json files that scripts/torch_eval_battery.py and
tools/run_eval_battery.py write, and the 5k matrices' pass tensors trial
by trial. Needs numpy only.

    python scripts/compare_battery.py curves/cassie_mk5c_eval \
        curves/torch_cassie_mk5c_eval

Prints, per figure, JAX's value, the port's and their difference, and
for the command suite the ci95 of the difference of two independent
rates, 1.96 sqrt(p (1 - p) (1/n_jax + 1/n_port)). With --cells, the 5k
rate of every (mission, speed) cell, JAX's beside the port's; with
--before DIR, an earlier port battery's too, and whether the cell's pass
tensor repeats it trial for trial.

    python scripts/compare_battery.py curves/cassie_mk5c_eval \
        curves/torch_cassie_mk5c_eval --cells --before OLD_DIR
"""
import argparse
import json
import pathlib
import pickle

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("jax_dir")
    ap.add_argument("port_dir")
    ap.add_argument("--cells", action="store_true")
    ap.add_argument("--before", default=None)
    args = ap.parse_args()
    jdir, pdir = pathlib.Path(args.jax_dir), pathlib.Path(args.port_dir)
    js = json.loads((jdir / "summary.json").read_text())
    ps = json.loads((pdir / "summary.json").read_text())
    print(f"port card: {ps.get('card', 'not recorded')}")

    if "perturb" in js and "perturb" in ps:
        a = np.asarray(js["perturb"]["max_force_per_angle"])
        b = np.asarray(ps["perturb"]["max_force_per_angle"])
        print(f"perturb max force per angle: jax {a.tolist()} port "
              f"{b.tolist()} diff {(b - a).tolist()} (mean {a.mean()} vs "
              f"{b.mean()}; within 25 N at {int((abs(b - a) <= 25).sum())}"
              f" of {len(a)})")
    if "commands" in js and "commands" in ps:
        pj, pp = js["commands"]["pass_rate"], ps["commands"]["pass_rate"]
        nj, np_ = js["commands"]["n_trials"], ps["commands"]["n_trials"]
        tol = 1.96 * (pj * (1 - pj) * (1 / nj + 1 / np_)) ** 0.5
        print(f"commands pass rate: jax {pj} port {pp} diff {pp - pj:+.4f}"
              f" (ci95 of the difference {tol:.4f})")
        for k in ("n_speed_fails", "n_orient_fails", "avg_failing_speed",
                  "avg_failing_orient_delta"):
            print(f"  {k}: jax {js['commands'][k]} port {ps['commands'][k]}")
    for m, r in js.get("missions", {}).items():
        q = ps.get("missions", {}).get(m)
        if q is None:
            continue
        print(f"mission {m}: " + ", ".join(
            f"{k} jax {r[k]:.4g} port {q[k]:.4g}" for k in (
                "success", "progress", "total", "avg_pos_error",
                "avg_speed_error", "avg_orient_error")))
    if "5k" in js and "5k" in ps:
        for k in ("pass_rate", "pass_rate_ref_subset"):
            print(f"5k {k}: jax {js['5k'][k]:.6g} port {ps['5k'][k]:.6g} "
                  f"diff {ps['5k'][k] - js['5k'][k]:+.6g}")
        for ax in ("by_mission", "by_speed", "by_terrain"):
            print(f"5k {ax}: " + ", ".join(
                f"{k} {v} / {ps['5k'][ax].get(k)}"
                for k, v in js["5k"][ax].items()) + " (jax / port)")
        with open(jdir / "eval_5k.pkl", "rb") as f:
            jp = np.asarray(pickle.load(f)["passed"])
        with open(pdir / "eval_5k.pkl", "rb") as f:
            pp = np.asarray(pickle.load(f)["passed"])
        if jp.shape == pp.shape:
            agree = (jp == pp)
            print(f"5k trials agreeing: {agree.mean():.4f} of {agree.size};"
                  f" per mission " + ", ".join(
                      f"{x:.4f}" for x in agree.mean(axis=(1, 2, 3, 4))))
        if args.cells:
            print_cells(js["5k"], jp, pp, args.before)


def print_cells(grid_summary, jp, pp, before_dir=None):
    """The 5k rate per (mission, speed) cell: JAX, the port, and an
    earlier port battery with whether the cell repeats it bit for bit."""
    bp = None
    if before_dir:
        with open(pathlib.Path(before_dir) / "eval_5k.pkl", "rb") as f:
            bp = np.asarray(pickle.load(f)["passed"])
    missions = list(grid_summary["by_mission"])
    speeds = list(grid_summary["by_speed"])
    for mi, m in enumerate(missions):
        for si, v in enumerate(speeds):
            line = (f"5k cell {m}_{v}: jax {jp[mi, si].mean():.5f} port "
                    f"{pp[mi, si].mean():.5f} diff "
                    f"{pp[mi, si].mean() - jp[mi, si].mean():+.5f}")
            if bp is not None:
                same = bool((bp[mi, si] == pp[mi, si]).all())
                line += (f" before {bp[mi, si].mean():.5f} "
                         f"{'same trials' if same else 'moved'}")
            print(line)
    for mi, m in enumerate(missions):
        print(f"5k mission {m}: jax {jp[mi].mean():.5f} port "
              f"{pp[mi].mean():.5f} diff {pp[mi].mean() - jp[mi].mean():+.5f}"
              + (f" before {bp[mi].mean():.5f}" if bp is not None else ""))


if __name__ == "__main__":
    main()
