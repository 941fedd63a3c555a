"""The port's deterministic evaluation of run directories at several seeds,
on the card: `python -m apex_tpu_torch eval`'s protocol (`eval_checkpoint`:
64 envs for 300 policy steps, the deterministic policy, auto-reset) with
the torch generator seeded by each seed in turn; the counterpart of
`scripts/reference_eval_seeds.py`, which gives JAX's figures on the CPU.
torch and jax.random draw different numbers from the same seed, so one
seed's returns differ by the draws as well as by the stacks; the mean
over seeds compares the two. With --jax_draws DIR each run instead takes
the draws of JAX's own evaluation from DIR/<name>.npz (the run dir's name
without "cassie_" and "_ckpt"; `scripts/export_eval_draws.py` writes
them, `chip_smoke.jax_draws` replays them), and prints JAX's return
beside the port's.

    python3 scripts/torch_eval_seeds.py --paths curves/cassie_main_ckpt \\
        curves/cassie_mk5a_ckpt --seeds 42 0 1 [--physics fleet]
    python3 scripts/torch_eval_seeds.py --paths curves/cassie_main_ckpt \\
        --seeds 42 --jax_draws curves/jax_eval_draws
"""
import argparse
import contextlib
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

from apex_tpu_torch.device import card_line  # noqa: E402
from apex_tpu_torch.runtime.evaluate import eval_checkpoint  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--paths", nargs="+", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 0, 1])
    p.add_argument("--n_episodes", type=int, default=64)
    p.add_argument("--traj_len", type=int, default=300)
    p.add_argument("--physics", default=None,
                   choices=["megakernel", "fleet"])
    p.add_argument("--jax_draws", default=None)
    args = p.parse_args(argv)
    print("card:", card_line(), flush=True)
    for path in args.paths:
        rets = []
        for seed in args.seeds:
            ctx, jax_ret = contextlib.nullcontext(), ""
            if args.jax_draws:
                from chip_smoke import draws_file, jax_draws

                f = draws_file(path, args.jax_draws)
                ctx = jax_draws(f)
                with np.load(f) as d:
                    jax_ret = f", JAX {float(d['jax_return']):.4f}"
            t0 = time.time()
            with ctx:
                ret, ln = eval_checkpoint(path, n_episodes=args.n_episodes,
                                          traj_len=args.traj_len, seed=seed,
                                          physics=args.physics)
            rets.append(ret)
            print(f"{path} seed {seed}: mean return {ret:.4f}{jax_ret}, "
                  f"mean length {ln:.2f} ({time.time() - t0:.1f} s)",
                  flush=True)
        print(f"{path}: over seeds {args.seeds}: mean {np.mean(rets):.4f}, "
              f"std {np.std(rets):.4f}", flush=True)


if __name__ == "__main__":
    main()
