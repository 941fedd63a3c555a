"""Command line of the port: `python -m apex_tpu_torch eval --path RUN_DIR`.

The subcommand and its flags mirror `apex.py eval` (apex.py:168-274) for
the deterministic fleet evaluation; `--device cpu` runs the plain PyTorch
versions of the kernels on the CPU.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m apex_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    ev = sub.add_parser("eval", help="deterministic evaluation of a run dir")
    ev.add_argument("--path", type=str, required=True,
                    help="run directory with experiment.pkl and "
                         "checkpoint.pkl")
    ev.add_argument("--n_episodes", type=int, default=16)
    ev.add_argument("--traj_len", type=int, default=400)
    ev.add_argument("--device", type=str, default="cuda",
                    choices=["cuda", "cpu"])
    ev.add_argument("--seed", type=int, default=42)
    args = parser.parse_args(argv)

    from apex_tpu_torch.runtime.evaluate import eval_checkpoint

    eval_checkpoint(args.path, n_episodes=args.n_episodes,
                    traj_len=args.traj_len, device=args.device,
                    seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
