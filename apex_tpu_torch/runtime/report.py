"""PDF report generation for the eval suites.

Rebuilds the reference's report artifacts — the "5k" pass-rate PDF
(5k_test.py:230-285, fpdf), the perturbation polar plot
(tools/eval_perturb.py:214-255, matplotlib savefig) and the two-policy
comparison PDF (tools/compare_pols.py:93-182) — on matplotlib's PdfPages
backend (fpdf is not in the image; the content parity is the tables/plots,
not the library).

A copy of `apex_tpu/runtime/report.py`: it imports numpy, and matplotlib
only when a report is written; without matplotlib, writing one raises an
ImportError that says so.
"""
from __future__ import annotations

import numpy as np


def _plt():
    """matplotlib.pyplot on the Agg backend, or a clear ImportError."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the PDF reports (--pdf) need matplotlib, which "
                          "is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _pdf(path):
    from matplotlib.backends.backend_pdf import PdfPages

    return PdfPages(path)


def report_5k(result: dict, path: str, title: str = "5k robustness matrix"):
    """result = eval_suites.eval_5k_matrix(...) output. Page 1: overall +
    per-axis pass-rate bars (reference report_stats, 5k_test.py:230-285);
    then one terrain x mission heatmap per speed, and a friction x
    foot-mass heatmap aggregated over the rest."""
    plt = _plt()

    grid = result["grid"]
    passed = np.asarray(result["passed"], dtype=float)
    missions = list(grid["missions"])
    speeds = list(grid["mission_speeds"])
    terrains = list(grid["terrains"])
    frictions = list(grid["frictions"])
    fmasses = list(grid["foot_mass_scales"])

    def _heat(ax, cell, xlabels, ylabels, xlabel, ylabel, subtitle):
        im = ax.imshow(cell, vmin=0, vmax=1, cmap="RdYlGn", aspect="auto")
        ax.set_xticks(range(len(xlabels)), [f"{x}" for x in xlabels],
                      rotation=45, ha="right", fontsize=7)
        ax.set_yticks(range(len(ylabels)), [f"{y}" for y in ylabels],
                      fontsize=7)
        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        ax.set_title(subtitle, fontsize=9)
        for (yi, xi), v in np.ndenumerate(cell):
            ax.text(xi, yi, f"{v:.2f}", ha="center", va="center", fontsize=6)
        return im

    with _pdf(path) as pdf:
        # summary page with per-axis breakdown bars
        fig, axes = plt.subplots(1, 5, figsize=(11, 3.2))
        fig.suptitle(f"{title} -- overall pass rate "
                     f"{result['pass_rate']:.3f}")
        for ax, key, names in (
                (axes[0], "by_mission", missions),
                (axes[1], "by_speed", speeds),
                (axes[2], "by_terrain", terrains),
                (axes[3], "by_friction", frictions),
                (axes[4], "by_foot_mass", fmasses)):
            rates = [float(v) for v in result[key].values()]
            ax.bar(range(len(names)), rates, color="#4a7")
            ax.set_xticks(range(len(names)), [f"{n}" for n in names],
                          rotation=60, ha="right", fontsize=6)
            ax.set_ylim(0, 1)
            ax.set_title(key[3:], fontsize=9)
        fig.tight_layout()
        pdf.savefig(fig)
        plt.close(fig)

        # terrain x mission per speed
        for si, sp in enumerate(speeds):
            cell = passed[:, si].mean(axis=(2, 3))      # (mission, terrain)
            fig, ax = plt.subplots(figsize=(8, 4))
            im = _heat(ax, cell, terrains, missions, "terrain", "mission",
                       f"speed {sp} m/s (pass rate {cell.mean():.2f})")
            fig.colorbar(im, ax=ax, shrink=0.8)
            fig.tight_layout()
            pdf.savefig(fig)
            plt.close(fig)

        # friction x foot-mass aggregate
        cell = passed.mean(axis=(0, 1, 2))              # (friction, fmass)
        fig, ax = plt.subplots(figsize=(5, 4))
        im = _heat(ax, cell, fmasses, frictions, "foot mass scale",
                   "friction scale",
                   f"friction x foot-mass (pass rate {cell.mean():.2f})")
        fig.colorbar(im, ax=ax, shrink=0.8)
        fig.tight_layout()
        pdf.savefig(fig)
        plt.close(fig)
    return path


def report_perturbation(result: dict, path: str,
                        title: str = "push robustness"):
    """result = eval_suites.eval_perturbation(...) output with keys
    `angles` (A,), `forces` (F,), `survival` (A, F, P). Polar plot of the
    maximum survived force per direction, per phase and aggregate
    (eval_perturb.plot_perturb parity)."""
    plt = _plt()

    angles = np.asarray(result["angles"], dtype=float)
    forces = np.asarray(result["forces"], dtype=float)
    surv = np.asarray(result["survival"]) > 0.5          # (A, F, P)

    # max force survived per (angle, phase)
    idx = np.where(surv, np.arange(len(forces))[None, :, None],
                   -1).max(axis=1)                       # (A, P)
    max_f = np.where(idx >= 0, forces[np.maximum(idx, 0)], 0.0)

    with _pdf(path) as pdf:
        fig = plt.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="polar")
        mean_f = max_f.mean(axis=-1)
        th = np.concatenate([angles, angles[:1]])
        rr = np.concatenate([mean_f, mean_f[:1]])
        ax.plot(th, rr, "-o")
        ax.fill(th, rr, alpha=0.25)
        ax.set_title(f"{title}: mean max survivable force (N)")
        pdf.savefig(fig)
        plt.close(fig)

        fig, ax = plt.subplots(figsize=(7, 4))
        im = ax.imshow(max_f.T, aspect="auto", cmap="viridis",
                       extent=[np.degrees(angles[0]), np.degrees(angles[-1]),
                               0, max_f.shape[1]])
        ax.set_xlabel("push direction (deg)")
        ax.set_ylabel("gait phase index")
        ax.set_title("max survivable force per phase")
        fig.colorbar(im, ax=ax, shrink=0.8, label="N")
        pdf.savefig(fig)
        plt.close(fig)
    return path


def report_compare(result: dict, path: str,
                   labels=("policy A", "policy B")):
    """result = eval_suites.compare_policies(...) output ({'a': (ret, len),
    'b': (ret, len)}). Bar-chart PDF (compare_pols.py parity)."""
    plt = _plt()

    ra, rb = result["a"], result["b"]
    with _pdf(path) as pdf:
        fig, axes = plt.subplots(1, 2, figsize=(8, 4))
        for ax, idx, name in ((axes[0], 0, "eval return"),
                              (axes[1], 1, "episode length")):
            vals = [float(ra[idx]), float(rb[idx])]
            ax.bar(labels, vals, color=["tab:blue", "tab:orange"])
            ax.set_title(name)
            for x, v in enumerate(vals):
                ax.text(x, v, f"{v:.1f}", ha="center", va="bottom")
        pdf.savefig(fig)
        plt.close(fig)
    return path
