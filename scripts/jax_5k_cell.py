"""One cell of the JAX package's 5k matrix on the CPU: the checkpoint's
trials of one (mission, speed) schedule through `eval_5k_matrix`'s own
program (`apex_tpu/runtime/eval_suites.py`), on the terrains named, with
every friction and foot mass of the grid. Writes the cell's pass tensor
(terrain, friction, foot mass), its rate and the seconds it took.

A 5k trial draws nothing (`reset_for_test` ignores its key), so the
trials of a cell are the same whichever terrains run together: a cell
split over processes by terrain is the whole cell.

    JAX_PLATFORMS=cpu python scripts/jax_5k_cell.py \\
        --ckpt curves/cassie_mk5c_ckpt --mission 90_left --speed 0.5 \\
        --terrains flat noise3 hill3 --out cell.npz

With --merge NPZ..., the finished parts of a cell together: their rate
and seconds, and against each battery of --against (an eval_5k.pkl),
that battery's rate on the same trials and the trials that pass only in
one of the two.

    python scripts/jax_5k_cell.py --mission 90_left --speed 0.5 \\
        --merge flat.npz noise3.npz hill3.npz \\
        --against curves/cassie_mk5c_eval/eval_5k.pkl
"""
import argparse
import importlib.util
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from apex_tpu.runtime import eval_suites  # noqa: E402


def _loader():
    spec = importlib.util.spec_from_file_location(
        "reference_eval_seeds", ROOT / "scripts" / "reference_eval_seeds.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_experiment_lenient


def merge(args):
    """The parts of a cell together, against the --against batteries."""
    import pickle

    parts = [np.load(p) for p in args.merge]
    terrains = [str(t) for p in parts for t in p["terrains"]]
    passed = np.concatenate([p["passed"] for p in parts])
    out = {"cell": f"{args.mission}_{args.speed}", "terrains": terrains,
           "n": int(passed.size), "pass_rate": float(passed.mean()),
           "seconds": [round(float(p["seconds"]), 1) for p in parts]}
    for path in args.against:
        with open(path, "rb") as f:
            res = pickle.load(f)
        grid = res["grid"]
        mi = [str(m) for m in grid["missions"]].index(args.mission)
        si = [float(v) for v in grid["mission_speeds"]].index(args.speed)
        ti = [[str(t) for t in grid["terrains"]].index(t) for t in terrains]
        other = np.asarray(res["passed"])[mi, si][ti]
        out[path] = {"pass_rate": float(other.mean()),
                     "only_here": int((passed & ~other).sum()),
                     "only_there": int((other & ~passed).sum())}
    print(json.dumps(out, indent=1), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt")
    ap.add_argument("--mission", required=True)
    ap.add_argument("--speed", type=float, required=True)
    ap.add_argument("--terrains", nargs="*",
                    default=list(eval_suites.DEFAULT_5K_TERRAINS))
    ap.add_argument("--max_steps", type=int, default=0)
    ap.add_argument("--out")
    ap.add_argument("--merge", nargs="*", default=[])
    ap.add_argument("--against", nargs="*", default=[])
    args = ap.parse_args(argv)
    if args.merge:
        return merge(args)
    ppo, state, _ = _loader()(args.ckpt)

    def policy_fn(obs):
        return state.actor.act(state.norm, obs, deterministic=True)

    t0 = time.time()
    res = eval_suites.eval_5k_matrix(
        policy_fn, ppo.env, missions=(args.mission,),
        mission_speeds=(args.speed,), terrains=tuple(args.terrains),
        max_steps=args.max_steps)
    secs = time.time() - t0
    passed = np.asarray(res["passed"])[0, 0]
    np.savez(args.out, passed=passed, terrains=np.asarray(args.terrains),
             seconds=secs)
    print(json.dumps({"cell": f"{args.mission}_{args.speed}",
                      "terrains": args.terrains, "n": int(passed.size),
                      "pass_rate": float(passed.mean()),
                      "seconds": round(secs, 1)}), flush=True)


if __name__ == "__main__":
    main()
