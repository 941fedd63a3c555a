"""Estimator-input vs true-state recorder: the counterpart of
tools/vis_input_and_state.py, with the same arguments, printed lines, npz
keys and figure.

Runs the policy deterministically at --speed for --steps steps
(`runtime/analysis.input_and_state_record`), records the pelvis-relative
foot positions the state estimator feeds the policy beside the true ones,
prints their largest difference and the step of the first fall, writes the
record as <out>.npz and, where matplotlib imports, the figure as <out>;
otherwise it prints "(plot skipped: ...)".

With --jax_draws FILE the job runs on JAX's draws (a file of
`scripts/export_tool_draws.py calls` holding the call (0, 1, STEPS);
`chip_smoke.file_draws` replays it).

Usage: python scripts/torch_vis_input_and_state.py <run_dir> [--speed 2.0]
           [--steps 300] [--out vis_state.png] [--jax_draws FILE]
           [--device cpu]
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
    """The job's draws: JAX's from `path` (`chip_smoke.file_draws`), or
    None for the env's own samplers."""
    if not path:
        return None
    from chip_smoke import file_draws

    return file_draws(path, env)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run_dir")
    ap.add_argument("--speed", type=float, default=2.0)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", default="vis_state.png")
    ap.add_argument("--jax_draws", default=None,
                    help="npz of scripts/export_tool_draws.py calls")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    from apex_tpu_torch.runtime.analysis import input_and_state_record

    args = parse_args(argv)
    env, policy_fn = load_policy(args.run_dir, resolve_device(args.device))

    rec = input_and_state_record(env, policy_fn, n_steps=args.steps,
                                 speed=args.speed,
                                 draws=job_draws(args.jax_draws, env))
    print(f"estimator-vs-truth max |foot position| error: "
          f"left {rec['est_lfoot_err']:.2e} m, "
          f"right {rec['est_rfoot_err']:.2e} m")
    fell = np.where(rec["fallen"])[0]
    print("fell at step", fell[0] if len(fell) else "never")

    np.savez(args.out.replace(".png", ".npz"), **rec)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        T = rec["qpos"].shape[0]
        t = np.arange(T)
        fig, axs = plt.subplots(4, 1, figsize=(12, 12), sharex=True)
        axs[0].plot(t, rec["qpos"][:, 2], label="pelvis z (true)")
        axs[0].plot(t, rec["qpos"][:, 0], label="pelvis x (true)")
        axs[0].legend(fontsize=8)
        axs[0].set_ylabel("pelvis [m]")
        for i, lab in enumerate("xyz"):
            axs[1].plot(t, rec["est_lfoot"][:, i], f"C{i}-",
                        label=f"est l {lab}")
            axs[1].plot(t, rec["true_lfoot"][:, i], f"C{i}--",
                        label=f"true l {lab}")
        axs[1].legend(fontsize=7, ncol=3)
        axs[1].set_ylabel("left foot rel pelvis [m]")
        err_l = np.abs(rec["est_lfoot"] - rec["true_lfoot"]).max(axis=1)
        err_r = np.abs(rec["est_rfoot"] - rec["true_rfoot"]).max(axis=1)
        axs[2].semilogy(t, np.maximum(err_l, 1e-12), label="left")
        axs[2].semilogy(t, np.maximum(err_r, 1e-12), label="right")
        axs[2].legend(fontsize=8)
        axs[2].set_ylabel("est-vs-true |err| [m]")
        axs[3].plot(t, rec["reward"])
        axs[3].set_ylabel("reward")
        axs[3].set_xlabel("policy step")
        if len(fell):
            for ax in axs:
                ax.axvline(fell[0], color="r", ls="--", alpha=0.5)
        fig.savefig(args.out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {args.out}")
    except Exception as e:
        print(f"(plot skipped: {e})")
    return rec


if __name__ == "__main__":
    main()
