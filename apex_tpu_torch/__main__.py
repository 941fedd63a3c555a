"""Command line of the port: `python -m apex_tpu_torch {ppo,td3_sync,
td3_async,ddpg,rdpg,ars,eval} ...`.

The subcommands and their flags mirror `apex.py` (apex.py:70-166, with
`_common_env_args`, and apex.py:168-274 for eval: the deterministic
evaluation, `--suite {commands,perturb,mission,sensitivity,5k,compare}`,
`--drive`, `--gait`, `--out`). They run on the GPU; `--device cpu` runs
the plain PyTorch versions of the kernels on the CPU. `eval --seed` seeds
the evaluation's draws; `eval --physics` picks the PD scan's tier (K1
"megakernel", "fleet", or "per_env", the per-env engine); left out, and
always for the learners, the device's default (megakernel on CUDA, fleet
on the CPU). The run directory's name hashes the namespace
and experiment.pkl stores it, so the learners get apex.py's namespace:
the subcommand and `--device` are taken out first. `ppo` trains on
several GPUs as the JAX package does on several devices: launched as the
ranks of a process group (torchrun, or the APEX_COORD_ADDR /
APEX_NUM_PROCS / APEX_PROC_ID variables, `parallel/multihost.py`), or, on
a host with more than one GPU and no group, as one rank per GPU that it
starts itself, where the fleet splits evenly and `--recurrent` is off.
`ppo --previous` inherits the previous run's env keys (with
`--exchange_reward`, a new reward and run name) where apex.py does,
before the namespace is handed on. `ppo --recurrent` trains `RecurrentPPO`, `rdpg` the recurrent DPG and
`ars --recurrent` ARS with an LSTM policy; as in apex.py, `eval` loads
feed-forward PPO run directories only.
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


def _lead_process() -> bool:
    """Whether this process prints the banner: not a rank other than 0."""
    import os

    return os.environ.get("RANK", os.environ.get("APEX_PROC_ID", "0")) \
        == "0"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if _lead_process():
        from apex_tpu_torch.utils.logo import print_logo

        print_logo()
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

    for cmd in ("td3_sync", "td3_async"):
        td = sub.add_parser(cmd, help=f"train with TD3 (apex.py {cmd})")
        td.add_argument("--logdir", type=str,
                        default=f"./trained_models/{cmd}/")
        td.add_argument("--seed", default=0, type=int)
        td.add_argument("--start_timesteps", default=10000, type=int)
        td.add_argument("--eval_freq", default=5000, type=int)
        td.add_argument("--max_timesteps", default=1e7, type=float)
        td.add_argument("--expl_noise", default=0.1, type=float)
        td.add_argument("--batch_size", default=64, type=int)
        td.add_argument("--discount", default=0.99, type=float)
        td.add_argument("--tau", default=0.005, type=float)
        td.add_argument("--policy_noise", default=0.2, type=float)
        td.add_argument("--noise_clip", default=0.5, type=float)
        td.add_argument("--policy_freq", default=2, type=int)
        td.add_argument("--a_lr", default=1e-4, type=float)
        td.add_argument("--c_lr", default=1e-4, type=float)
        td.add_argument("--num_procs", type=int, default=64)
        td.add_argument("--max_traj_len", type=int, default=400)
        td.add_argument("--param_noise", default=False, action="store_true")
        _common_env_args(td)
        _device_args(td)

    for cmd in ("ddpg", "rdpg"):
        dp = sub.add_parser(cmd, help=f"train with {cmd.upper()} (apex.py "
                                      f"{cmd})")
        dp.add_argument("--logdir", type=str,
                        default=f"./trained_models/{cmd}/")
        dp.add_argument("--seed", default=0, type=int)
        dp.add_argument("--batch_size", default=64, type=int)
        dp.add_argument("--discount", default=0.99, type=float)
        dp.add_argument("--tau", default=0.001, type=float)
        dp.add_argument("--a_lr", default=1e-4, type=float)
        dp.add_argument("--c_lr", default=1e-3, type=float)
        dp.add_argument("--expl_noise", default=0.2, type=float)
        dp.add_argument("--max_timesteps", default=1e7, type=float)
        dp.add_argument("--num_procs", type=int, default=64)
        dp.add_argument("--max_traj_len", type=int, default=400)
        _common_env_args(dp)
        _device_args(dp)

    ar = sub.add_parser("ars", help="train with ARS (apex.py ars)")
    ar.add_argument("--logdir", type=str, default="./trained_models/ars/")
    ar.add_argument("--seed", default=0, type=int)
    ar.add_argument("--n_itr", type=int, default=1000)
    ar.add_argument("--hidden_size", default=32, type=int)
    ar.add_argument("--deltas", default=64, type=int)
    ar.add_argument("--lr", default=0.01, type=float)
    ar.add_argument("--std", default=0.0075, type=float)
    ar.add_argument("--deltas_used", default=32, type=int)
    ar.add_argument("--num_procs", type=int, default=4)
    ar.add_argument("--max_traj_len", type=int, default=400)
    ar.add_argument("--algo", default="v1", type=str)
    ar.add_argument("--recurrent", action="store_true")
    _common_env_args(ar)
    _device_args(ar)

    ev = sub.add_parser("eval", help="deterministic evaluation of a run dir")
    ev.add_argument("--path", type=str, required=True,
                    help="run directory with experiment.pkl and "
                         "checkpoint.pkl")
    ev.add_argument("--n_episodes", type=int, default=16)
    ev.add_argument("--traj_len", type=int, default=400)
    ev.add_argument("--out", type=str, default=None,
                    help="npz path for trajectory dump")
    ev.add_argument("--gait", type=str, default=None,
                    help="npz path for a qpos gait recording "
                         "(render with tools/render_gait.py)")
    ev.add_argument("--speed", type=float, default=1.0)
    # behavioral eval suites (reference test_policy.py:49-121 dispatch)
    ev.add_argument("--suite", type=str, default=None,
                    choices=["commands", "perturb", "mission",
                             "sensitivity", "5k", "compare"])
    ev.add_argument("--pdf", type=str, default=None,
                    help="write the suite report to this PDF")
    ev.add_argument("--compare_to", type=str, default=None,
                    help="second run dir for --suite compare")
    ev.add_argument("--mission", type=str, default="default")
    ev.add_argument("--drive", type=str, default=None,
                    help="timed key-command script (JSON list of "
                         "[step, key]); the scripted equivalent of "
                         "the reference's interactive keyboard eval")
    ev.add_argument("--drive_steps", type=int, default=300)
    ev.add_argument("--seed", type=int, default=42)
    ev.add_argument("--physics", type=str, default=None,
                    choices=["megakernel", "fleet", "per_env"],
                    help="PD scan tier (default: megakernel on CUDA, "
                         "fleet on the CPU; per_env: the per-env engine)")
    _device_args(ev)
    args = parser.parse_args(argv)

    if args.cmd == "eval":
        return _eval(args)

    if args.cmd == "ppo":
        # apex.py:101-102: a continuation inherits the previous run's env
        from apex_tpu_torch.runtime.log import parse_previous

        args = parse_previous(args)

    # the run directory's name hashes the namespace and experiment.pkl
    # stores it: keep them apex.py's, without the subcommand and device
    cmd, device = args.cmd, args.device
    del args.cmd, args.device
    if cmd == "ppo":
        return _ppo(args, device, argv)
    elif cmd in ("td3_sync", "td3_async"):
        from apex_tpu_torch.agents.td3 import run_experiment

        run_experiment(args, async_mode=cmd == "td3_async", device=device)
    elif cmd in ("ddpg", "rdpg"):
        from apex_tpu_torch.agents.dpg import run_experiment

        run_experiment(args, recurrent=cmd == "rdpg", device=device)
    else:
        from apex_tpu_torch.agents.ars import run_experiment

        run_experiment(args, device=device)
    return 0


def _ppo(args, device: str, argv) -> int:
    """`ppo`: in a process group where one is set up, as one rank per GPU
    where the host has several and none is, else in this process."""
    import torch
    import torch.distributed as dist

    from apex_tpu_torch.agents.ppo import run_experiment
    from apex_tpu_torch.parallel import multihost

    if not multihost.initialize(device=device):
        n_gpu = torch.cuda.device_count() if device == "cuda" else 0
        if (n_gpu > 1 and not getattr(args, "recurrent", False)
                and args.num_procs % n_gpu == 0):
            print(f"starting {n_gpu} ranks, one per GPU", flush=True)
            return multihost.launch_local(argv, n_gpu)
        run_experiment(args, device=device)
        return 0
    try:
        run_experiment(args, device=device)
    finally:
        dist.destroy_process_group()
    return 0


def _eval(args) -> int:
    """apex.py eval (apex.py:168-274): a scripted drive, one of the
    behavioral suites, or the deterministic evaluation (with a trajectory
    dump and a gait recording)."""
    import numpy as np

    from apex_tpu_torch.runtime import evaluate

    device, physics = args.device, args.physics
    if args.drive:
        from apex_tpu_torch.runtime.drive import drive_policy

        exp = evaluate.load_experiment(args.path, device=device,
                                       physics=physics)
        res = drive_policy(exp.actor, exp.norm, exp.env, args.drive,
                           n_steps=args.drive_steps)
        print(f"eval reward: {float(res['eval_reward']):.2f}  "
              f"(steps {args.drive_steps}, falls "
              f"{int(res['done'].sum())})")
        if args.out:
            np.savez(args.out, **res)
            print("telemetry:", args.out)
        return 0

    if args.suite:
        from apex_tpu_torch.runtime import eval_suites, report

        if args.suite == "compare":
            res = eval_suites.compare_policies(
                args.path, args.compare_to, n_episodes=args.n_episodes,
                traj_len=args.traj_len, device=device)
            if args.pdf:
                print("report:", report.report_compare(res, args.pdf))
            return 0
        exp = evaluate.load_experiment(args.path, device=device,
                                       physics=physics)
        env = exp.env

        def policy_fn(obs):
            return exp.actor.act(exp.norm, obs, deterministic=True)

        if args.suite == "perturb":
            res = eval_suites.eval_perturbation(env, policy_fn)
            print("max force per angle:", res["max_force_per_angle"])
            if args.pdf:
                print("report:", report.report_perturbation(res, args.pdf))
        elif args.suite == "commands":
            print(eval_suites.eval_commands(env, policy_fn))
        elif args.suite == "mission":
            res = eval_suites.eval_mission(
                eval_suites.playground_policy(exp), mission=args.mission,
                simrate=env.simrate, device=device, pd_tier=physics)
            print({k: v for k, v in res.items() if np.ndim(v) == 0})
        elif args.suite == "sensitivity":
            print(eval_suites.eval_sensitivity(env, policy_fn))
        else:
            res = eval_suites.eval_5k_matrix(policy_fn, env)
            print("5k pass rate:", res["pass_rate"])
            for ax in ("by_mission", "by_speed", "by_terrain",
                       "by_friction", "by_foot_mass"):
                print(f"  {ax}:", {k: round(float(v), 3)
                                   for k, v in res[ax].items()})
            if args.pdf:
                print("report:", report.report_5k(res, args.pdf))
        return 0

    evaluate.eval_checkpoint(args.path, n_episodes=args.n_episodes,
                             traj_len=args.traj_len, device=device,
                             seed=args.seed, physics=physics, out=args.out)
    if args.gait:
        evaluate.dump_gait(args.path, out=args.gait, speed=args.speed,
                           device=device, physics=physics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
