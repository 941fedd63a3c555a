"""Command line of the port: `python -m apex_tpu_torch {ppo,eval} ...`.

The subcommands and their flags mirror `apex.py ppo` (apex.py:70-105, with
`_common_env_args`) and `apex.py eval` (apex.py:168-274). Both run on the
GPU; `--device cpu` runs the plain PyTorch versions of the kernels on the
CPU. `eval --physics` picks the PD scan's tier (K1 "megakernel" or
"fleet"); left out, and always for `ppo`, the device's default (megakernel
on CUDA, fleet on the CPU).
"""
from __future__ import annotations

import argparse
import sys


def _common_env_args(parser: argparse.ArgumentParser) -> None:
    """apex.py's `_common_env_args` (apex.py:21-47)."""
    parser.add_argument("--env_name", default="Cassie-v0")
    parser.add_argument("--simrate", default=50, type=int)
    parser.add_argument("--command_profile", default="clock", type=str)
    parser.add_argument("--input_profile", default="full", type=str)
    parser.add_argument("--dyn_random", default=False, action="store_true")
    parser.add_argument("--learn_gains", default=False, action="store_true")
    parser.add_argument("--reward", default="early_clock", type=str)
    parser.add_argument("--history", default=0, type=int)
    parser.add_argument("--mirror", default=False, action="store_true")
    parser.add_argument("--no_delta", default=True, action="store_true")
    parser.add_argument("--ik_baseline", default=False, action="store_true")
    parser.add_argument("--traj", default="walking", type=str)
    parser.add_argument("--estimator", default="firmware", type=str,
                        choices=["exact", "firmware"])
    parser.add_argument("--min_speed", default=-0.3, type=float)
    parser.add_argument("--max_speed", default=4.0, type=float)
    parser.add_argument("--orient_jump_prob", default=0.0, type=float)
    parser.add_argument("--speed_phase_add", default=False,
                        action="store_true")


def _device_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m apex_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("ppo", help="train with PPO (apex.py ppo)")
    pp.add_argument("--logdir", type=str, default="./trained_models/ppo/")
    pp.add_argument("--seed", default=0, type=int)
    pp.add_argument("--previous", type=str, default=None)
    pp.add_argument("--exchange_reward", default=None)
    pp.add_argument("--run_name", default=None)
    pp.add_argument("--input_norm_steps", type=int, default=10000)
    pp.add_argument("--n_itr", type=int, default=10000)
    pp.add_argument("--lr", type=float, default=1e-4)
    pp.add_argument("--eps", type=float, default=1e-5)
    pp.add_argument("--lam", type=float, default=0.95)
    pp.add_argument("--gamma", type=float, default=0.99)
    pp.add_argument("--anneal", default=1.0, type=float)
    pp.add_argument("--learn_stddev", default=False, action="store_true")
    pp.add_argument("--std_dev", type=float, default=-1.5)
    pp.add_argument("--entropy_coeff", type=float, default=0.0)
    pp.add_argument("--clip", type=float, default=0.2)
    pp.add_argument("--minibatch_size", type=int, default=64)
    pp.add_argument("--epochs", type=int, default=3)
    pp.add_argument("--num_steps", type=int, default=5096)
    pp.add_argument("--use_gae", default=False, action="store_true")
    pp.add_argument("--num_procs", type=int, default=64,
                    help="env fleet size")
    pp.add_argument("--max_grad_norm", type=float, default=0.05)
    pp.add_argument("--max_traj_len", type=int, default=400)
    pp.add_argument("--recurrent", action="store_true")
    pp.add_argument("--bounded", type=bool, default=False)
    _common_env_args(pp)
    _device_args(pp)

    ev = sub.add_parser("eval", help="deterministic evaluation of a run dir")
    ev.add_argument("--path", type=str, required=True,
                    help="run directory with experiment.pkl and "
                         "checkpoint.pkl")
    ev.add_argument("--n_episodes", type=int, default=16)
    ev.add_argument("--traj_len", type=int, default=400)
    ev.add_argument("--seed", type=int, default=42)
    ev.add_argument("--physics", type=str, default=None,
                    choices=["megakernel", "fleet"],
                    help="PD scan tier (default: megakernel on CUDA, "
                         "fleet on the CPU)")
    _device_args(ev)
    args = parser.parse_args(argv)

    if args.cmd == "ppo":
        if args.recurrent:
            raise NotImplementedError(
                "--recurrent (RecurrentPPO) is not ported to apex_tpu_torch "
                "yet")
        if args.previous is not None:
            raise NotImplementedError(
                "--previous (curriculum continuation) is not ported to "
                "apex_tpu_torch yet")
        from apex_tpu_torch.agents.ppo import run_experiment

        # the run directory's name hashes the namespace and experiment.pkl
        # stores it: keep them apex.py's, without the subcommand and device
        device = args.device
        del args.cmd, args.device
        run_experiment(args, device=device)
        return 0

    from apex_tpu_torch.runtime.evaluate import eval_checkpoint

    eval_checkpoint(args.path, n_episodes=args.n_episodes,
                    traj_len=args.traj_len, device=args.device,
                    seed=args.seed, physics=args.physics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
