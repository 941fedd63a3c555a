"""Train recurrent PPO (LSTM actor and critic, BPTT over env chunks) with
the PyTorch port and record the learning curve and the best-eval
checkpoint: the counterpart of tools/train_recurrent_curve.py, with the
same positional argument, flags, defaults and artifacts.

`RecurrentPPO.init(seed)`, the normaliser's burn-in (10,000 steps), then
one `_train_iteration` per iteration at anneal 1 and a deterministic eval
(`_evaluate`, a fresh fleet, each env's first episode; its generator
seeded by the iteration) at every --eval-every-th iteration and at the
last. Writes into --out (default curves/) <name>.npz with the JAX tool's
keys (rewritten at every eval point) and <name>_ckpt/ (experiment.pkl with
the JAX tool's keys, checkpoint.pkl in the JAX package's layout), and
prints the JAX tool's JSON summary plus "card".

Usage: python scripts/torch_train_recurrent_curve.py {walker,cassie}
           [options] [--device cpu] [--out DIR]
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

from apex_tpu_torch.device import card_line, resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=["walker", "cassie"])
    ap.add_argument("--n-itr", type=int, default=300)
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--chunk-len", type=int, default=64)
    ap.add_argument("--minibatch-envs", type=int, default=32)
    ap.add_argument("--reward", default="early_clock")
    ap.add_argument("--std", type=float, default=-1.5)
    ap.add_argument("--max-traj-len", type=int, default=300)
    ap.add_argument("--name", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=str(ROOT / "curves"))
    args = ap.parse_args(argv)

    from apex_tpu_torch.agents.ppo import PPOConfig
    from apex_tpu_torch.agents.ppo_recurrent import RecurrentPPO
    from apex_tpu_torch.runtime.checkpoint import save_checkpoint

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    if args.which == "cassie":
        from apex_tpu_torch.envs.cassie import CassieEnv

        env = CassieEnv(dynamics_randomization=False, reward=args.reward,
                        device=device)
        env_name = "Cassie-v0"
    else:
        from apex_tpu_torch.envs.walker2d import Walker2dEnv

        env = Walker2dEnv(device=device)
        env_name = "Walker2d"

    cfg = PPOConfig(num_envs=args.num_envs,
                    num_steps=args.num_envs * args.chunk_len,
                    max_traj_len=args.max_traj_len,
                    minibatch_size=args.minibatch_envs,
                    epochs=args.epochs, lr=args.lr, std_dev=args.std)

    name = args.name or f"recurrent_ppo_{args.which}_seed{args.seed}"
    out = pathlib.Path(args.out)
    ckpt_dir = out / f"{name}_ckpt"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    with open(ckpt_dir / "experiment.pkl", "wb") as f:
        pickle.dump({"env_name": env_name, "reward": args.reward,
                     "recurrent": True, "num_procs": cfg.num_envs,
                     "seed": args.seed, "std_dev": args.std}, f)

    ppo = RecurrentPPO(env, cfg)
    state = ppo.init(seed=args.seed)
    state = ppo.prenormalize(state, steps=10000)

    iters, walls, train_ret, eval_ret, steps = [], [], [], [], []
    path = out / f"{name}.npz"
    total = 0
    best = -np.inf
    t0 = time.time()
    for itr in range(args.n_itr):
        state, metrics = ppo._train_iteration(state, 1.0)
        total += cfg.num_envs * args.chunk_len
        if itr % args.eval_every == 0 or itr == args.n_itr - 1:
            gen = torch.Generator(device=device)
            gen.manual_seed((1 << 32) + itr)
            er = float(ppo._evaluate(state, gen)["ep_return"])
            wall = time.time() - t0
            iters.append(itr)
            walls.append(wall)
            train_ret.append(float(metrics["train_ep_return"]))
            eval_ret.append(er)
            steps.append(total)
            print(f"itr {itr:5d} | wall {wall:7.1f}s | "
                  f"steps {total / 1e6:6.1f}M | eval {er:8.2f} | "
                  f"train {train_ret[-1]:8.2f}", flush=True)
            if er > best:
                best = er
                save_checkpoint(str(ckpt_dir), state, env)
            np.savez(path, iters=np.asarray(iters), wall_s=np.asarray(walls),
                     env_steps=np.asarray(steps),
                     train_return=np.asarray(train_ret),
                     eval_return=np.asarray(eval_ret), algo="recurrent_ppo",
                     env=env_name, seed=args.seed)

    print(json.dumps({
        "algo": "recurrent_ppo", "env": env_name,
        "total_env_steps": total, "wall_s": round(walls[-1], 1),
        "eval_return_first": round(eval_ret[0], 2),
        "eval_return_last": round(eval_ret[-1], 2),
        "eval_return_max": round(float(np.max(eval_ret)), 2),
        "curve": str(path), "ckpt": str(ckpt_dir), "card": card}))
    return state


if __name__ == "__main__":
    main()
