"""Hold a reference learning curve against the port's seeds: the decision
rule of the port's Cassie curve (`PERF.md` §6, PR 16).

Each curve (an .npz of tools/train_curve.py or scripts/torch_train_curve.py)
is smoothed by the mean of the 5 eval points centred on each point (fewer
at the ends). At each iteration of --at, a curve's value is its smoothed
value at the eval point nearest that iteration (a 1,000-iteration run's
last point is iteration 999). At each point the port's seeds give
min, max and mean; w = max - min, h = max(w, 0.25 mean), and the band is
[min - h, max + h]. The curve is held when the reference's value lies
inside the band at every point and each seed's value at the last point
is at least --growth times its own at iteration 0.

Usage: python scripts/curve_band.py --reference curves/cassie_mk4_hardened.npz
           --port curves/torch_cassie_mk4_hardened_seed{0,1,2}.npz
Prints one JSON object; exits 0 whether held or not. Needs numpy only.
"""
import argparse
import json

import numpy as np


def smoothed(eval_return: np.ndarray, width: int = 5) -> np.ndarray:
    """The mean of the `width` points centred on each point, fewer where
    the window runs past an end."""
    r = np.asarray(eval_return, np.float64)
    half = width // 2
    return np.array([r[max(0, i - half):i + half + 1].mean()
                     for i in range(len(r))])


def value_at(curve: dict, itr: int) -> float:
    """The smoothed eval return at the eval point nearest `itr`."""
    i = int(np.argmin(np.abs(np.asarray(curve["iters"]) - itr)))
    return float(smoothed(curve["eval_return"])[i])


def decide(reference: dict, port: list, at, growth: float = 2.0) -> dict:
    points = []
    for itr in at:
        vals = [value_at(c, itr) for c in port]
        lo, hi, mean = min(vals), max(vals), float(np.mean(vals))
        h = max(hi - lo, 0.25 * mean)
        ref = value_at(reference, itr)
        band = (lo - h, hi + h)
        points.append({"iter": itr, "reference": ref, "port": vals,
                       "band": band,
                       "inside": band[0] <= ref <= band[1],
                       "outside_by": max(band[0] - ref, ref - band[1], 0.0)})
    ratios = [value_at(c, at[-1]) / value_at(c, 0) for c in port]
    held = (all(p["inside"] for p in points)
            and all(r >= growth for r in ratios))
    first_out = next((p for p in points if not p["inside"]), None)
    return {"points": points, "growth": ratios,
            "reference_growth": value_at(reference, at[-1])
            / value_at(reference, 0),
            "first_point_outside": first_out, "held": held}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", required=True)
    ap.add_argument("--port", nargs="+", required=True)
    ap.add_argument("--at", type=int, nargs="+",
                    default=[300, 500, 750, 1000])
    ap.add_argument("--growth", type=float, default=2.0)
    args = ap.parse_args(argv)
    load = lambda p: {k: v for k, v in np.load(p).items()}
    out = decide(load(args.reference), [load(p) for p in args.port],
                 args.at, args.growth)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
