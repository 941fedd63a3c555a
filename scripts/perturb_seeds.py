"""The push-robustness suite of one checkpoint at several seeds, in either
stack: how far the largest survived force per angle moves with the
suite's random draws alone (the resets, and the random command changes of
every step). The port and the JAX package draw different numbers, so
their figures for one seed differ by at least that much.

    python scripts/perturb_seeds.py <ckpt_dir> --stack torch --seeds 0 1 2
    JAX_PLATFORMS=cpu python scripts/perturb_seeds.py <ckpt_dir> \
        --stack jax --seeds 1

The torch stack runs on the GPU (448 envs, one fleet; ~1 s a seed on an
H100); the JAX stack on its default backend (on 8 CPU cores, ~10-20
minutes a seed). Both run the battery's grid: 8 angles x 14 forces up to
350 N x 4 gait phases. Prints one JSON line per seed.
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--stack", choices=["torch", "jax"], required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args()

    if args.stack == "torch":
        from apex_tpu_torch.runtime import eval_suites
        from apex_tpu_torch.runtime.evaluate import load_experiment

        exp = load_experiment(args.ckpt, device="cuda")
        env = exp.env

        def policy_fn(obs):
            return exp.actor.act(exp.norm, obs, deterministic=True)
    else:
        from apex_tpu.runtime import eval_suites
        from apex_tpu.runtime.evaluate import load_experiment

        ppo, state, _ = load_experiment(args.ckpt)
        env = ppo.env

        def policy_fn(obs):
            return state.actor.act(state.norm, obs, deterministic=True)

    for seed in args.seeds:
        t0 = time.time()
        res = eval_suites.eval_perturbation(env, policy_fn, max_force=350.0,
                                            seed=seed)
        print(json.dumps({
            "stack": args.stack, "ckpt": args.ckpt, "seed": seed,
            "max_force_per_angle": [float(v)
                                    for v in res["max_force_per_angle"]],
            "seconds": round(time.time() - t0, 1)}), flush=True)


if __name__ == "__main__":
    main()
