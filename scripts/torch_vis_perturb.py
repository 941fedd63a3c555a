"""Offline push-response visualizer: the counterpart of tools/vis_perturb.py,
with the same arguments, printed lines, npz keys and figure.

A pelvis push of --force N from each of --angles directions at each
--phases gait phase (`runtime/analysis.perturb_response`: 80 steps of
walking at --speed, an 8-step push, 120 steps of recovery), the pelvis
trajectory recorded; prints the survival grid, writes the record as
<out>.npz and, where matplotlib imports, the figure (per-angle pelvis x/y
paths and the survival grid) as <out>; otherwise it prints "(plot
skipped: ...)".

With --jax_draws FILE the job runs on JAX's draws (a file of
`scripts/export_tool_draws.py calls` holding the call (0, angles x phases,
208); `chip_smoke.file_draws` replays it).

Usage: python scripts/torch_vis_perturb.py <run_dir> [--force 170]
           [--angles 4] [--phases 0,8,16,24] [--speed 0.5]
           [--out vis_perturb.png] [--jax_draws FILE] [--device cpu]
It runs on the card unless --device cpu is given.
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from apex_tpu_torch.device import resolve_device  # noqa: E402


def load_policy(run_dir, device):
    """(env, deterministic policy) of a run directory."""
    from apex_tpu_torch.runtime.evaluate import load_experiment

    exp = load_experiment(run_dir, device=device)

    def policy_fn(obs):
        return exp.actor.act(exp.norm, obs, deterministic=True)

    return exp.env, policy_fn


def job_draws(path, env):
    """The jobs' draws: JAX's from `path` (`chip_smoke.file_draws`), or
    None for the env's own samplers."""
    if not path:
        return None
    from chip_smoke import file_draws

    return file_draws(path, env)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--force", type=float, default=170.0)
    ap.add_argument("--angles", type=int, default=4)
    ap.add_argument("--phases", default="0")
    ap.add_argument("--speed", type=float, default=0.5)
    ap.add_argument("--out", default="vis_perturb.png")
    ap.add_argument("--jax_draws", default=None,
                    help="npz of scripts/export_tool_draws.py calls")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from apex_tpu_torch.runtime.analysis import perturb_response

    args = parse_args(argv)
    env, policy_fn = load_policy(args.run_dir, resolve_device(args.device))

    phases = [int(p) for p in args.phases.split(",")]
    angles = np.linspace(0, 2 * np.pi, args.angles, endpoint=False)
    res = perturb_response(env, policy_fn, force=args.force, angles=angles,
                           phases=phases, speed=args.speed,
                           draws=job_draws(args.jax_draws, env))

    print(f"force {args.force:.0f} N, speed {args.speed} m/s")
    print("survival grid (rows=angle, cols=phase):")
    for i, a in enumerate(res["angles"]):
        row = " ".join("pass" if s else "FALL"
                       for s in res["survived"][i])
        print(f"  {np.degrees(a):6.1f} deg : {row}")

    np.savez(args.out.replace(".png", ".npz"), **res)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        nA, nP = res["survived"].shape
        fig, axs = plt.subplots(1, 2, figsize=(12, 5))
        for i in range(nA):
            for j in range(nP):
                xy = res["pelvis"][i, j, :, :2]
                ok = ~res["fallen_seq"][i, j]
                axs[0].plot(xy[ok, 0], xy[ok, 1],
                            alpha=0.7,
                            label=(f"{np.degrees(res['angles'][i]):.0f} deg"
                                   if j == 0 else None))
        axs[0].set_xlabel("pelvis x [m]")
        axs[0].set_ylabel("pelvis y [m]")
        axs[0].legend(fontsize=7)
        axs[0].set_title(f"pelvis paths, {args.force:.0f} N push")
        im = axs[1].imshow(res["survived"].astype(float), cmap="RdYlGn",
                           vmin=0, vmax=1, aspect="auto")
        axs[1].set_xticks(range(nP), [str(p) for p in phases])
        axs[1].set_yticks(range(nA),
                          [f"{np.degrees(a):.0f}" for a in res["angles"]])
        axs[1].set_xlabel("push phase")
        axs[1].set_ylabel("push angle [deg]")
        axs[1].set_title("survival")
        fig.colorbar(im, ax=axs[1])
        fig.savefig(args.out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {args.out}")
    except Exception as e:
        print(f"(plot skipped: {e})")
    return res


if __name__ == "__main__":
    main()
