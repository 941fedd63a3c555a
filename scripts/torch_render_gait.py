"""Offline stick-figure rendering of a recorded Cassie gait: the counterpart
of tools/render_gait.py, with the same arguments, figure and printed line.

--frames frames are taken evenly from the qpos of `runtime/evaluate.
dump_gait` (`python -m apex_tpu_torch eval --gait`); their body origins
come from the port's forward kinematics, one fleet of the frames
(`physics/fleet_fk.fleet_fk`: the kernel K2 on the card, its plain version
on the CPU), and the kinematic tree is drawn as segments between them in
the sagittal (x-z) plane and from the top. The figure needs matplotlib;
where it does not import, the script prints "(plot skipped: ...)".

Usage: python scripts/torch_render_gait.py gait.npz [--out gait.png]
           [--frames 8] [--device cpu]
It runs on the card unless --device cpu is given.
"""
import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import resolve_device  # noqa: E402


def frame_positions(qpos: np.ndarray, frames: int, device):
    """(the frames' step indices, their body origins (frames, nbody, 3) in
    the world frame, the tree's (child, parent) edges)."""
    from apex_tpu_torch.physics import fleet_fk
    from apex_tpu_torch.physics.cassie_sim import cassie_model

    m = cassie_model()
    idx = np.linspace(0, len(qpos) - 1, frames).astype(int)
    q = torch.as_tensor(np.ascontiguousarray(qpos[idx].T, np.float32),
                        device=device)
    ipos = torch.as_tensor(np.asarray(m.body_ipos, np.float32),
                           device=device)[..., None].expand(
                               -1, -1, frames).contiguous()
    with torch.no_grad():
        kin = fleet_fk.fleet_fk(m, ipos, q)
        xpos = (kin.xpos + kin.origin[None]).permute(2, 0, 1)
    edges = [(i, int(p)) for i, p in enumerate(m.body_parent) if p >= 0]
    return idx, xpos.cpu().numpy(), edges


def draw(idx, xpos, edges, out):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = len(idx)
    fig, axs = plt.subplots(2, frames, figsize=(2.2 * frames, 6),
                            sharey="row")
    for f in range(frames):
        for view, (a, b_) in enumerate([(0, 2), (0, 1)]):
            ax = axs[view, f]
            for i, p in edges:
                ax.plot([xpos[f, p, a], xpos[f, i, a]],
                        [xpos[f, p, b_], xpos[f, i, b_]],
                        "-o", ms=2, lw=1.2, color="C0")
            if view == 0:
                ax.axhline(-0.01, color="gray", lw=0.5)
                ax.set_ylim(-0.1, 1.3)
                ax.set_title(f"t={idx[f]}")
            ax.set_aspect("equal")
    axs[0, 0].set_ylabel("x-z (side)")
    axs[1, 0].set_ylabel("x-y (top)")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("gait", help="npz with qpos (T, 35)")
    ap.add_argument("--out", default="gait.png")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    with np.load(args.gait) as f:
        qpos = f["qpos"]
    idx, xpos, edges = frame_positions(qpos, args.frames, device)
    try:
        draw(idx, xpos, edges, args.out)
    except ImportError as e:
        print(f"(plot skipped: {e})")
    return idx, xpos


if __name__ == "__main__":
    main()
