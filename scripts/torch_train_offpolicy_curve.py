"""Train the replay and derivative-free agents with the PyTorch port and
record the learning curve: the counterpart of
tools/train_offpolicy_curve.py, with the same positional argument, flags,
defaults and artifacts.

  td3_async, td3_sync  TD3 (`agents/td3.py`); the acting snapshot is
                       refreshed every iteration (sync) or every
                       load_freq iterations (async); the best-eval
                       checkpoint goes to <name>_ckpt/ in the JAX package's
                       layout
  ddpg, rdpg           DDPG and recurrent DDPG (`agents/dpg.py`)
  ars                  ARS v2 (`agents/ars.py`); its curve is each
                       iteration's mean candidate return

on Walker2d (`walker`) or CassieStanding-v0 (`cassie_standing`). The
iterations, the random warm-up and the eval cadence are the JAX tool's;
each eval's generator is seeded by the iteration. Writes <name>.npz into
--out (default curves/) with the JAX tool's keys (rewritten at every eval
point) and prints, on its last line, the JAX tool's JSON summary plus
"card" (the card's name and power limit), and on the line before it the
seconds per iteration with and without the eval, the kernels' launches
in all and per iteration, and the peak device memory.

Usage: python scripts/torch_train_offpolicy_curve.py
           {td3_async,td3_sync,ars,ddpg,rdpg} [--env walker]
           [--timesteps N | --n-itr N] [--device cpu] [--out DIR] ...
It runs on the card unless --device cpu is given.
"""
import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import (card_line, launch_counts,  # noqa: E402
                                   resolve_device)


def make_env(which: str, device):
    if which == "walker":
        from apex_tpu_torch.envs.walker2d import Walker2dEnv

        return Walker2dEnv(device=device), "Walker2d"
    if which == "cassie_standing":
        from apex_tpu_torch.envs.cassie_standing import CassieStandingEnv

        return CassieStandingEnv(device=device), "CassieStanding-v0"
    raise ValueError(which)


def eval_generator(device, base: int, it: int) -> torch.Generator:
    """The eval's generator of iteration `it` (the JAX tool folds `it`
    into PRNGKey(base))."""
    gen = torch.Generator(device=device)
    gen.manual_seed((base << 32) + it)
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("algo", choices=["td3_async", "td3_sync", "ars",
                                     "ddpg", "rdpg"])
    ap.add_argument("--env", default="walker",
                    choices=["walker", "cassie_standing"])
    ap.add_argument("--timesteps", type=float, default=3e6)
    ap.add_argument("--n-itr", type=int, default=300, help="ars iterations")
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--name", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(ROOT / "curves"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    env, env_name = make_env(args.env, device)
    name = args.name or f"{args.algo}_{args.env}_seed{args.seed}"
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{name}.npz"

    iters, walls, rets, steps_l = [], [], [], []
    train_s, eval_s = [], []
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def record(it, ret, total):
        """One eval point: kept and the npz rewritten; returns the head
        of its printed line."""
        iters.append(it)
        walls.append(time.time() - t0)
        rets.append(ret)
        steps_l.append(total)
        np.savez(path, iters=np.asarray(iters), wall_s=np.asarray(walls),
                 env_steps=np.asarray(steps_l), eval_return=np.asarray(rets),
                 algo=args.algo, env=env_name, seed=args.seed)
        return (f"{it:5d} | wall {walls[-1]:7.1f}s | "
                f"steps {total / 1e6:6.2f}M")

    def timed(fn, into):
        """fn()'s result, its seconds (the card's work included) kept in
        `into`."""
        t = time.time()
        out = fn()
        sync()
        into.append(time.time() - t)
        return out

    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    sync()
    launches0 = launch_counts()
    t0 = time.time()
    if args.algo == "ars":
        from apex_tpu_torch.agents.ars import ARS, ARSConfig

        ars = ARS(env, ARSConfig(algo="v2"))
        state = ars.init(seed=args.seed)
        for it in range(args.n_itr):
            state, metrics = timed(lambda: ars._iteration(state), train_s)
            if it % args.eval_every == 0 or it == args.n_itr - 1:
                head = record(it, float(metrics["mean_return"]),
                              int(state.total_steps))
                print(f"itr {head} | mean {rets[-1]:8.2f} | "
                      f"max {float(metrics['max_return']):8.2f}",
                      flush=True)
    elif args.algo in ("ddpg", "rdpg"):
        from apex_tpu_torch.agents.dpg import DPG, DPGConfig

        cfg = DPGConfig(num_envs=args.num_envs,
                        recurrent=args.algo == "rdpg")
        dpg = DPG(env, cfg)
        state = dpg.init(seed=args.seed)
        steps_per_iter = (cfg.max_traj_len if cfg.recurrent
                          else cfg.collect_steps) * cfg.num_envs
        n_iters = max(1, int(args.timesteps) // steps_per_iter)
        warmup = max(1, cfg.start_timesteps // steps_per_iter)
        total = 0
        for it in range(n_iters):
            state, metrics = timed(
                lambda: dpg._train_iteration(state, it < warmup), train_s)
            total += steps_per_iter
            if it % args.eval_every == 0 or it == n_iters - 1:
                ev = timed(lambda: dpg._evaluate(
                    state, eval_generator(device, 5, it)), eval_s)
                head = record(it, float(ev["ep_return"]), total)
                print(f"it {head} | eval {rets[-1]:8.2f} | "
                      f"closs {float(metrics['critic_loss']):8.4f}",
                      flush=True)
    else:
        from apex_tpu_torch.agents.td3 import TD3, TD3Config, copy_params
        from apex_tpu_torch.runtime.checkpoint import save_checkpoint

        cfg = TD3Config(num_envs=args.num_envs,
                        async_mode=args.algo == "td3_async")
        td3 = TD3(env, cfg)
        state = td3.init(seed=args.seed)
        ckpt_dir = out / f"{name}_ckpt"
        ckpt_dir.mkdir(exist_ok=True)
        steps_per_iter = cfg.collect_steps * cfg.num_envs
        n_iters = max(1, int(args.timesteps) // steps_per_iter)
        warmup = max(1, cfg.start_timesteps // steps_per_iter)
        total, best = 0, -np.inf
        for it in range(n_iters):
            if not cfg.async_mode or it % cfg.load_freq == 0:
                copy_params(state.behavior, state.actor)
            state, metrics = timed(
                lambda: td3._train_iteration(state, it < warmup), train_s)
            total += steps_per_iter
            if it % args.eval_every == 0 or it == n_iters - 1:
                ev = timed(lambda: td3._evaluate(
                    state, eval_generator(device, 7, it)), eval_s)
                head = record(it, float(ev["ep_return"]), total)
                print(f"it {head} | eval {rets[-1]:8.2f} | "
                      f"closs {float(metrics['critic_loss']):8.4f}",
                      flush=True)
                if rets[-1] > best:
                    best = rets[-1]
                    save_checkpoint(str(ckpt_dir), state, env)

    sync()
    n_itr = len(train_s)
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    print(json.dumps({
        "timing": {"s_per_itr_train": float(np.mean(train_s)),
                   "s_per_eval": (float(np.mean(eval_s)) if eval_s
                                  else None),
                   "s_per_itr": (time.time() - t0) / n_itr,
                   "n_itr": n_itr, "n_evals": len(eval_s)},
        "launches": launches,
        "launches_per_itr": {k: v / n_itr for k, v in launches.items()},
        "peak_mb": (torch.cuda.max_memory_allocated(device) / 2**20
                    if cuda else None)}))
    print(json.dumps({
        "algo": args.algo, "env": env_name, "seed": args.seed,
        "wall_s": round(walls[-1], 1), "total_env_steps": steps_l[-1],
        "eval_return_first": round(rets[0], 2),
        "eval_return_last": round(rets[-1], 2),
        "eval_return_max": round(float(np.max(rets)), 2),
        "curve": str(path), "card": card,
    }))
    return state


if __name__ == "__main__":
    main()
