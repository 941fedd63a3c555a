"""Train PPO with the PyTorch port and record the learning curve and the
best-eval checkpoint: the counterpart of tools/train_curve.py, with the
same positional argument, flags, defaults and artifacts.

The loop is the JAX tool's, not `PPO.train`'s (no host-side curriculum):
`PPO.init(seed)`, the observation normaliser's burn-in
(`prenormalize(steps=10000)`) unless --resume, then one
`_train_iteration` per iteration with the anneal multiplied by --anneal
after each, and a deterministic eval (`_evaluate`, a fresh fleet of
--num-envs for --max-traj-len steps, its generator seeded by the
iteration) at every --eval-every-th iteration and at the last. Writes
into --out (default curves/):
  <name>.npz      the curve, with the JAX tool's keys and dtypes (rewritten
                  at every eval point, so a cut run keeps its points);
  <name>_ckpt/    experiment.pkl with the JAX tool's keys, and the
                  best-eval checkpoint.pkl in the JAX package's layout
                  (its `runtime.evaluate.load_experiment` reads it).
The last line is the JAX tool's JSON summary plus "card" (the card's name
and power limit); the line before it the seconds per iteration with and
without the eval and the kernels' launches per iteration.

Usage: python scripts/torch_train_curve.py {cassie,walker,traj} [options]
           [--device cpu] [--out DIR]
It runs on the card unless --device cpu is given.
"""
import argparse
import json
import pathlib
import pickle
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import (card_line, launch_counts,  # noqa: E402
                                   resolve_device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=["cassie", "walker", "traj"])
    ap.add_argument("--n-itr", type=int, default=300)
    ap.add_argument("--num-envs", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--steps-per-env", type=int, default=32)
    ap.add_argument("--minibatch", type=int, default=2048)
    ap.add_argument("--reward", default="early_clock")
    ap.add_argument("--std", type=float, default=-1.5)
    ap.add_argument("--max-traj-len", type=int, default=300)
    ap.add_argument("--anneal", type=float, default=1.0)
    ap.add_argument("--dyn-random", action="store_true",
                    help="dynamics randomization on")
    ap.add_argument("--estimator", default="firmware",
                    choices=["exact", "firmware"])
    ap.add_argument("--terrain", default="flat",
                    choices=["flat", "noise", "hill", "steps"])
    ap.add_argument("--terrain-amplitude", type=float, default=0.05)
    ap.add_argument("--simrate", type=int, default=50)
    ap.add_argument("--min-speed", type=float, default=-0.3)
    ap.add_argument("--max-speed", type=float, default=4.0)
    ap.add_argument("--orient-jump-prob", type=float, default=0.0)
    ap.add_argument("--speed-phase-add", action="store_true")
    ap.add_argument("--max-incline", type=float, default=None)
    ap.add_argument("--name", default=None)
    ap.add_argument("--resume", default=None,
                    help="checkpoint dir to continue from (nets, "
                    "normaliser and optimiser moments; a fresh fleet)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(ROOT / "curves"))
    return ap.parse_args(argv)


def make_env(args, device):
    """(env, env_name) as the JAX tool builds them."""
    if args.which == "cassie":
        from apex_tpu_torch.envs.cassie import CassieEnv

        incline = ({} if args.max_incline is None else
                   {"max_pitch_incline": args.max_incline,
                    "max_roll_incline": args.max_incline})
        env = CassieEnv(dynamics_randomization=args.dyn_random,
                        reward=args.reward, estimator=args.estimator,
                        terrain=args.terrain,
                        terrain_amplitude=args.terrain_amplitude,
                        simrate=args.simrate, min_speed=args.min_speed,
                        max_speed=args.max_speed,
                        orient_jump_prob=args.orient_jump_prob,
                        speed_phase_add=args.speed_phase_add,
                        device=device, **incline)
        return env, "Cassie-v0"
    if args.which == "traj":
        from apex_tpu_torch.envs.cassie_traj import CassieTrajEnv

        if args.reward == "early_clock":
            args.reward = "iros_paper"   # the traj default, recorded so
        return CassieTrajEnv(dynamics_randomization=args.dyn_random,
                             reward=args.reward, simrate=args.simrate,
                             device=device), "CassieTraj-v0"
    from apex_tpu_torch.envs.walker2d import Walker2dEnv

    return Walker2dEnv(device=device), "Walker2d"


def experiment_record(args, cfg, env_name) -> dict:
    """experiment.pkl's dict, key for key the JAX tool's."""
    return {
        "env_name": env_name, "reward": args.reward,
        "num_procs": cfg.num_envs, "num_steps": cfg.num_steps,
        "max_traj_len": cfg.max_traj_len, "std_dev": args.std,
        "mirror": True, "dyn_random": args.dyn_random,
        "simrate": args.simrate, "command_profile": "clock",
        "input_profile": "full", "learn_gains": False, "history": 0,
        "seed": args.seed, "estimator": args.estimator,
        "terrain": args.terrain, "min_speed": args.min_speed,
        "max_speed": args.max_speed,
        "orient_jump_prob": args.orient_jump_prob,
        "speed_phase_add": args.speed_phase_add,
    }


def resume(state, path: str, lr: float):
    """The nets, normaliser and Adam moments of a saved PPO run over a
    fresh state, at learning rate `lr` (the JAX tool's `load_checkpoint`
    then `set_lr`; the fleet stays the fresh one)."""
    from apex_tpu_torch.agents.ppo import set_lr
    from apex_tpu_torch.runtime.checkpoint import _read, restore_ppo_learner

    state = restore_ppo_learner(state, _read(path))
    for opt in (state.actor_opt, state.critic_opt):
        set_lr(opt, lr)
    return state


def main(argv=None):
    args = parse_args(argv)
    from apex_tpu_torch.agents.ppo import PPO, PPOConfig
    from apex_tpu_torch.runtime.checkpoint import save_checkpoint

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    card = card_line() if cuda else "cpu"
    env, env_name = make_env(args, device)
    cfg = PPOConfig(num_envs=args.num_envs,
                    num_steps=args.num_envs * args.steps_per_env,
                    max_traj_len=args.max_traj_len,
                    minibatch_size=args.minibatch, epochs=args.epochs,
                    lr=args.lr, std_dev=args.std)

    name = args.name or f"{args.which}_ppo_seed{args.seed}"
    out = pathlib.Path(args.out)
    ckpt_dir = out / f"{name}_ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    with open(ckpt_dir / "experiment.pkl", "wb") as f:
        pickle.dump(experiment_record(args, cfg, env_name), f)

    ppo = PPO(env, cfg)
    state = ppo.init(seed=args.seed)
    if args.resume:
        state = resume(state, args.resume, args.lr)
        print(f"resumed from {args.resume}", flush=True)
    else:
        state = ppo.prenormalize(state, steps=10000)

    iters, walls, train_ret, eval_ret, eval_len, eplen, steps = \
        [], [], [], [], [], [], []
    path = out / f"{name}.npz"

    def write_curve():
        np.savez(path, iters=np.asarray(iters), wall_s=np.asarray(walls),
                 env_steps=np.asarray(steps),
                 train_return=np.asarray(train_ret),
                 eval_return=np.asarray(eval_ret),
                 eval_len=np.asarray(eval_len), ep_len=np.asarray(eplen),
                 num_envs=args.num_envs,
                 steps_per_iter=cfg.rollout_len * args.num_envs)

    total_steps = 0
    anneal = np.float32(1.0)
    best = -np.inf
    train_s, eval_s = [], []
    sync()
    launches0 = launch_counts()
    t0 = time.time()
    for itr in range(args.n_itr):
        t1 = time.time()
        state, metrics = ppo._train_iteration(state, float(anneal))
        metrics = {k: float(v) for k, v in metrics.items()}
        anneal = anneal * np.float32(args.anneal)
        total_steps += cfg.rollout_len * cfg.num_envs
        t2 = time.time()
        train_s.append(t2 - t1)
        if itr % args.eval_every == 0 or itr == args.n_itr - 1:
            gen = torch.Generator(device=device)
            gen.manual_seed((1 << 32) + itr)
            ev = ppo._evaluate(state, gen)
            er, el = float(ev["ep_return"]), float(ev["ep_len"])
            eval_s.append(time.time() - t2)
            wall = time.time() - t0
            iters.append(itr)
            walls.append(wall)
            train_ret.append(metrics["train_ep_return"])
            eval_ret.append(er)
            eval_len.append(el)
            eplen.append(metrics["train_ep_len"])
            steps.append(total_steps)
            print(f"itr {itr:5d} | wall {wall:8.1f}s | "
                  f"steps {total_steps / 1e6:7.1f}M | eval {er:8.2f} "
                  f"(len {el:5.1f}) | train {train_ret[-1]:8.2f} "
                  f"(len {eplen[-1]:5.1f})", flush=True)
            if er > best:
                best = er
                save_checkpoint(str(ckpt_dir), state, env)
            write_curve()
    sync()
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}

    print(json.dumps({
        "timing": {"s_per_itr_train": float(np.mean(train_s)),
                   "s_per_eval": float(np.mean(eval_s)),
                   "s_per_itr": (time.time() - t0) / args.n_itr,
                   "n_itr": args.n_itr, "n_evals": len(eval_s)},
        "launches": launches,
        "launches_per_itr": {k: v / args.n_itr
                             for k, v in launches.items()}}))
    print(json.dumps({
        "env": args.which, "n_itr": args.n_itr, "num_envs": args.num_envs,
        "seed": args.seed, "reward": args.reward, "lr": args.lr,
        "total_env_steps": total_steps,
        "wall_s": round(walls[-1], 1),
        "env_steps_per_s": round(total_steps / walls[-1], 1),
        "eval_return_first": round(eval_ret[0], 2),
        "eval_return_last": round(eval_ret[-1], 2),
        "eval_return_max": round(float(np.max(eval_ret)), 2),
        "eval_len_max": round(float(np.max(eval_len)), 1),
        "curve": str(path), "ckpt": str(ckpt_dir), "card": card,
    }))
    return state


if __name__ == "__main__":
    main()
