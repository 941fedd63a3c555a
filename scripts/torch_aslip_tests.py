"""ASLIP policy analysis suite: the counterpart of tools/aslip_tests.py, with
the same subcommands, arguments, printed lines and npz files.

  grf        `runtime/analysis.grf_profile`: the per-substep vertical
             ground-reaction force folded into gait cycles (--cycles after
             3 to settle), its mean and spread over three seeds' envs;
             prints the peaks, writes <out>.npz and, where matplotlib
             imports, the figure <out>
  footplace  `foot_placement_error`: landing-position error against the
             gait library's strides, per speed (trajectory index)
  taskspace  `taskspace_tracking`: RMS task-space error of the feet per
             speed, one env per speed

The run is loaded as the JAX tool loads it (`runtime/evaluate.
load_experiment`), which does not pass the run's --traj on: an aslip run
of CassieTraj-v0 loads with the walking gait library, so footplace and
taskspace stop at "requires an aslip run" in both stacks (ROADMAP limit
(l)). --keep-traj builds the env with the run's own gait library, which
the JAX tool cannot.

With --jax_draws FILE the jobs run on JAX's draws (a file of
`scripts/export_tool_draws.py calls` holding each of the job's calls;
`chip_smoke.file_draws` replays it; a call it lacks raises).

Usage:
  python scripts/torch_aslip_tests.py grf <run_dir> [--speed 1.0]
      [--cycles 10] [--out grf.png]
  python scripts/torch_aslip_tests.py footplace <run_dir> [--traj-idx 10]
      [--steps 12] [--trials 8]
  python scripts/torch_aslip_tests.py taskspace <run_dir>
      [--speeds 0,5,10,15,20] [--out rows.npz]
each with [--keep-traj] [--jax_draws FILE] [--device cpu]; it runs on the
card unless --device cpu is given.
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from apex_tpu_torch.device import resolve_device  # noqa: E402


def _load(args):
    """(env, deterministic policy, the jobs' draws) of the run directory."""
    from apex_tpu_torch.runtime.evaluate import load_experiment

    exp = load_experiment(args.run_dir, device=resolve_device(args.device),
                          keep_traj=args.keep_traj)
    env = exp.env

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    draws = None
    if args.jax_draws:
        from chip_smoke import file_draws

        draws = file_draws(args.jax_draws, env)
    return env, policy_fn, draws


def cmd_grf(args):
    from apex_tpu_torch.runtime.analysis import grf_profile

    env, policy_fn, draws = _load(args)
    traj_idx = (int(round(args.speed * 10))
                if getattr(env, "aslip", False) else None)
    prof = grf_profile(env, policy_fn, speed=args.speed, traj_idx=traj_idx,
                       n_cycles=args.cycles, draws=draws)
    print(f"cycles used: {prof['cycles_used']}")
    print(f"peak GRF  left {prof['mean'][:, 0].max():7.1f} N   "
          f"right {prof['mean'][:, 1].max():7.1f} N")
    out = args.out or "grf_profile.png"
    np.savez(out.replace(".png", ".npz"), **prof)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        t = np.arange(prof["mean"].shape[0]) * 5e-4
        fig, ax = plt.subplots(figsize=(10, 4))
        for i, side in enumerate(("left", "right")):
            m, s = prof["mean"][:, i], prof["std"][:, i]
            ax.plot(t, m, label=side)
            ax.fill_between(t, m - s, m + s, alpha=0.25)
        ax.set_xlabel("gait-cycle time [s]")
        ax.set_ylabel("vertical GRF [N]")
        ax.legend()
        ax.set_title(f"phase-averaged GRF, speed {args.speed} m/s "
                     f"({prof['cycles_used']} cycles)")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {out}")
    except Exception as e:  # matplotlib optional
        print(f"(plot skipped: {e})")
    return prof


def cmd_footplace(args):
    from apex_tpu_torch.runtime.analysis import foot_placement_error

    env, policy_fn, draws = _load(args)
    assert getattr(env, "aslip", False), "footplace requires an aslip run"
    idxs = ([args.traj_idx] if args.traj_idx is not None
            else range(int(env.num_speeds)))
    print(f"{'speed':>6} {'footsteps':>10} {'mean err [m]':>13} "
          f"{'std [m]':>9}")
    rows = []
    for t in idxs:
        r = foot_placement_error(env, policy_fn, t,
                                 num_steps=args.steps,
                                 n_trials=args.trials, draws=draws)
        print(f"{0.1 * t:6.1f} {r['n_footsteps']:10d} "
              f"{r['mean_error']:13.4f} {r['std_error']:9.4f}")
        rows.append(r)
    return rows


def cmd_taskspace(args):
    from apex_tpu_torch.runtime.analysis import taskspace_tracking

    env, policy_fn, draws = _load(args)
    assert getattr(env, "aslip", False), "taskspace requires an aslip run"
    idxs = ([int(s) for s in args.speeds.split(",")]
            if args.speeds else None)
    rows = taskspace_tracking(env, policy_fn, traj_indices=idxs, draws=draws)
    print(f"{'speed':>6} {'survived':>9} {'lfoot RMS [m]':>14} "
          f"{'rfoot RMS [m]':>14}")
    for r in rows:
        print(f"{r['speed']:6.1f} {str(r['survived']):>9} "
              f"{r['lfoot_rms']:14.4f} {r['rfoot_rms']:14.4f}")
    if args.out:
        np.savez(args.out, rows=np.asarray(
            [(r["speed"], r["survived"], r["lfoot_rms"], r["rfoot_rms"])
             for r in rows]))
        print(f"wrote {args.out}")
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("grf")
    g.add_argument("run_dir")
    g.add_argument("--speed", type=float, default=1.0)
    g.add_argument("--cycles", type=int, default=10)
    g.add_argument("--out", default=None)
    g.set_defaults(fn=cmd_grf)

    f = sub.add_parser("footplace")
    f.add_argument("run_dir")
    f.add_argument("--traj-idx", type=int, default=None)
    f.add_argument("--steps", type=int, default=12)
    f.add_argument("--trials", type=int, default=8)
    f.set_defaults(fn=cmd_footplace)

    t = sub.add_parser("taskspace")
    t.add_argument("run_dir")
    t.add_argument("--speeds", default=None,
                   help="comma-separated traj indices (default: all 21)")
    t.add_argument("--out", default=None)
    t.set_defaults(fn=cmd_taskspace)

    for p in (g, f, t):
        p.add_argument("--keep-traj", action="store_true",
                       help="build the env with the run's --traj (the JAX "
                       "tool's load drops it)")
        p.add_argument("--jax_draws", default=None,
                       help="npz of scripts/export_tool_draws.py calls")
        p.add_argument("--device", default=None,
                       help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
