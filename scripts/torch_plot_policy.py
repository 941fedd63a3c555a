"""Offline policy trajectory plots: the counterpart of tools/plot_policy.py,
with the same arguments, figures and printed line.

Reads either
  * a channel record of `runtime/evaluate.record_policy` (keys
    pd_target/motor_pos/torque/grf/...): commanded PD target against
    measured motor position per motor, applied torques, ground-reaction
    forces, pelvis and foot states; or
  * a fleet trajectory dump of `python -m apex_tpu_torch eval --out`
    (obs/action/reward/terminated, (T, B, ...)): one env's actions, reward
    and observations.
The figures need matplotlib; where it does not import, the script prints
"(plot skipped: ...)" and writes nothing. A host job on numpy: it uses no
card.

Usage: python scripts/torch_plot_policy.py record.npz [--out plots.png]
           [--env 0]
"""
import argparse

import numpy as np

MOTOR_NAMES = ["hip-roll", "hip-yaw", "hip-pitch", "knee", "foot"]


def plot_channels(f, out):
    """PD-target-vs-measured / torque / GRF figure set (the reference's
    recorded channels, plot_policy.py:1-326)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pd, mpos = f["pd_target"], f["motor_pos"]
    tau, grf = f["torque"], f["grf"]
    qpos = f["qpos"]
    T = pd.shape[0]
    t = np.arange(T) * 0.025                       # 40 Hz policy steps

    fig, axs = plt.subplots(5, 3, figsize=(16, 14), sharex=True)
    for j in range(5):
        ax = axs[j, 0]
        for side, ofs, ls in (("L", 0, "-"), ("R", 5, "--")):
            ax.plot(t, pd[:, j + ofs], ls, lw=0.8,
                    label=f"{side} target")
            ax.plot(t, mpos[:, j + ofs], ls, lw=1.4, alpha=0.6,
                    label=f"{side} measured")
        ax.set_ylabel(f"{MOTOR_NAMES[j]} (rad)")
        if j == 0:
            ax.legend(fontsize=6, ncol=2)
            ax.set_title("PD target vs measured motor position")
        ax = axs[j, 1]
        ax.plot(t, tau[:, j], lw=0.9, label="L")
        ax.plot(t, tau[:, j + 5], lw=0.9, label="R")
        ax.set_ylabel(f"{MOTOR_NAMES[j]} torque (Nm)")
        if j == 0:
            ax.legend(fontsize=6)
            ax.set_title("applied motor torque")
    axs[0, 2].plot(t, grf[:, 0], label="left")
    axs[0, 2].plot(t, grf[:, 1], label="right")
    axs[0, 2].set_ylabel("GRF z (N)")
    axs[0, 2].legend(fontsize=6)
    axs[0, 2].set_title("ground reaction forces")
    axs[1, 2].plot(t, qpos[:, 2])
    axs[1, 2].set_ylabel("pelvis height (m)")
    axs[2, 2].plot(t, qpos[:, 0], label="x")
    axs[2, 2].plot(t, qpos[:, 1], label="y")
    axs[2, 2].set_ylabel("pelvis xy (m)")
    axs[2, 2].legend(fontsize=6)
    if "foot_pos" in f:
        fp = f["foot_pos"]
        axs[3, 2].plot(t, fp[:, 0, 2], label="left z")
        axs[3, 2].plot(t, fp[:, 1, 2], label="right z")
        axs[3, 2].set_ylabel("foot height (m)")
        axs[3, 2].legend(fontsize=6)
    axs[4, 2].plot(t, f["reward"])
    axs[4, 2].set_ylabel("reward")
    for ax in axs[-1]:
        ax.set_xlabel("time (s)")
    fig.suptitle(f"policy channel record (speed "
                 f"{float(f['speed']) if 'speed' in f else '?'} m/s)")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}")


def plot_trajectory(f, out, e, title):
    """One env's actions, reward and observations of a fleet dump."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    obs, action, reward = f["obs"], f["action"], f["reward"]
    term = f["terminated"]
    T = obs.shape[0]
    t = np.arange(T)

    fig, axs = plt.subplots(4, 1, figsize=(12, 12), sharex=True)
    axs[0].plot(t, action[:, e])
    axs[0].set_ylabel("actions (PD target deltas)")
    axs[1].plot(t, reward[:, e])
    axs[1].set_ylabel("reward")
    # first termination
    dead = np.where(term[:, e])[0]
    for ax in axs:
        if len(dead):
            ax.axvline(dead[0], color="r", ls="--", alpha=0.5)
    # a few interesting obs dims: pelvis height (0), orientation (1:5)
    axs[2].plot(t, obs[:, e, 0], label="pelvis z")
    axs[2].plot(t, obs[:, e, 1:5])
    axs[2].set_ylabel("pelvis height / orient")
    axs[2].legend(loc="upper right", fontsize=7)
    axs[3].plot(t, obs[:, e, 5:15])
    axs[3].set_ylabel("motor positions")
    axs[3].set_xlabel("policy step")
    fig.suptitle(f"{title} (env {e})")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("traj", help="npz from record_policy or "
                    "python -m apex_tpu_torch eval --out")
    ap.add_argument("--out", default="policy_plots.png")
    ap.add_argument("--env", type=int, default=0,
                    help="which env of the eval fleet to plot")
    args = ap.parse_args(argv)

    with np.load(args.traj) as npz:
        f = {k: npz[k] for k in npz}
    try:
        if "pd_target" in f:
            plot_channels(f, args.out)
        else:
            plot_trajectory(f, args.out, args.env, args.traj)
    except ImportError as e:
        print(f"(plot skipped: {e})")
        return None
    return args.out


if __name__ == "__main__":
    main()
