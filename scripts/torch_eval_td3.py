"""The port's deterministic evaluation of a TD3 actor on Walker2d, on the card
unless --device cpu: `TD3._evaluate`'s protocol (a fresh fleet of 64 envs
for 400 steps, the deterministic actor, auto-reset), the counterpart of
`scripts/export_td3_draws.py`, which gives JAX's figure on the CPU.

The actor and normaliser come from a TD3 run dir or checkpoint.pkl (the
JAX package's or the port's) or from an .npz of `export_td3_draws.py`
(`runtime.checkpoint.load_td3_actor`). Given such an .npz, the evaluation
runs on the draws of JAX's own run (`chip_smoke.jax_draws`) and prints
JAX's return beside the port's, with the bound it is held to: 1.8 % or
JAX's largest move under 1e-6 changes of the first fleet's qpos, whichever
is larger (limit (f)). It also evaluates on the port's own draws (a
generator seeded with 42). With --export OUT it writes the actor and
normaliser alone into OUT, the .npz that `export_td3_draws.py --path`
reads (a port run's best checkpoint holds the 1M replay ring too).
The last line is one JSON object.

    python3 scripts/torch_eval_td3.py curves/jax_eval_draws/td3_async_walker.npz
    python3 scripts/torch_eval_td3.py RUN_ckpt --export actor.npz --device cpu
"""
import argparse
import contextlib
import json
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.device import (card_line, launch_counts,  # noqa: E402
                                   resolve_device)

BOUND = 0.018          # the 1.8 % between the JAX package's physics tiers
SEED = 42              # the seed of the port's own draws' generator


def evaluate(env, actor, norm, generator, n_envs: int, traj_len: int):
    """`TD3._evaluate` of the actor: (mean return, mean length) of the
    episodes that ended."""
    from apex_tpu_torch.agents.td3 import TD3, TD3Config

    td3 = TD3(env, TD3Config(num_envs=n_envs, max_traj_len=traj_len))
    ev = td3._evaluate(types.SimpleNamespace(actor=actor, norm=norm),
                       generator)
    return float(ev["ep_return"]), float(ev["ep_len"])


def export(path: str, out: str) -> None:
    """The actor's and normaliser's leaves of a TD3 checkpoint into `out`,
    with the names `export_td3_draws.py` reads."""
    from apex_tpu_torch.runtime.checkpoint import (TD3_NPZ_KEYS,
                                                   td3_actor_leaves)

    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **{k: np.asarray(x, np.float32) for k, x in zip(
        TD3_NPZ_KEYS, td3_actor_leaves(path))})


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("path", help="a TD3 run dir, checkpoint.pkl or .npz")
    p.add_argument("--n_episodes", type=int, default=64)
    p.add_argument("--traj_len", type=int, default=400)
    p.add_argument("--export", default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.export:
        export(args.path, args.export)
    from apex_tpu_torch.envs.walker2d import Walker2dEnv
    from apex_tpu_torch.runtime.checkpoint import load_td3_actor

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    env = Walker2dEnv(device=device)
    actor, norm = load_td3_actor(args.path, device)
    out = {"path": args.path, "n_episodes": args.n_episodes,
           "traj_len": args.traj_len, "card": card}

    def run(ctx):
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        before = launch_counts()
        t0 = time.time()
        with ctx:
            ret, ln = evaluate(env, actor, norm, gen, args.n_episodes,
                               args.traj_len)
        if cuda:
            torch.cuda.synchronize()
        n = {k: v - before[k] for k, v in launch_counts().items()
             if v != before[k]}
        return {"return": ret, "ep_len": ln, "seconds": time.time() - t0,
                "launches": n}

    if args.path.endswith(".npz"):
        with np.load(args.path) as f:
            jax_figs = ({"jax_return": float(f["jax_return"]),
                         "jax_length": float(f["jax_length"]),
                         "jax_perturbed_returns": [
                             float(x) for x in f.get(
                                 "jax_perturbed_returns", [])],
                         "batch": int(f["batch"]), "steps": int(f["steps"])}
                        if "jax_return" in f else None)
        if jax_figs:
            if (jax_figs["batch"], jax_figs["steps"]) != (
                    args.n_episodes, args.traj_len):
                raise SystemExit(f"{args.path} holds JAX's draws of "
                                 f"{jax_figs['batch']} envs x "
                                 f"{jax_figs['steps']} steps")
            from chip_smoke import jax_draws

            res = run(jax_draws(args.path))
            jr = jax_figs["jax_return"]
            spread = max([abs(x - jr) / abs(jr)
                          for x in jax_figs["jax_perturbed_returns"]],
                         default=0.0)
            rel = (res["return"] - jr) / abs(jr)
            res.update(jax_return=jr, jax_length=jax_figs["jax_length"],
                       rel_diff=rel, jax_spread=spread,
                       bound=max(BOUND, spread),
                       held=abs(rel) <= max(BOUND, spread))
            out["on_jax_draws"] = res
            print(f"on JAX's draws: return {res['return']:.4f} (len "
                  f"{res['ep_len']:.2f}), JAX {jr:.4f} (len "
                  f"{jax_figs['jax_length']:.2f}): {100 * rel:+.3f} %, "
                  f"JAX's 1e-6 spread {100 * spread:.3f} %, "
                  f"{'held' if res['held'] else 'NOT held'}", flush=True)
    res = run(contextlib.nullcontext())
    out["own_draws"] = res
    print(f"own draws (seed {SEED}): return {res['return']:.4f} (len "
          f"{res['ep_len']:.2f})", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
