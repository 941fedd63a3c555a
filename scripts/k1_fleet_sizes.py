"""K1's device time at the fleet sizes of the port's main paths, in turns.

For B = 64 and 1024 (eval and training) and 3,971 and 10,000 (a 5k cell
and the command suite), on `chip_smoke.k1_standing_inputs`'s fleets, and
through the heightfield build for the mk5c command suite's terrain at
10,000 and the 5k noise and hill tables and ramps at 3,971 (`chip_smoke.
k1_5k_terrain_inputs`, `k1_ramp_inputs`), prints K1's device time per
launch from torch.profiler's trace (`chip_smoke.device_ms`, which holds
each trace to a CUDA-event timing of the same calls) and from CUDA events
around back-to-back launches (`chip_smoke.cuda_ms`), over `--rounds`
rounds that visit the cases first to last, then last to first, with the
card's name and power limit and K1's launch shape. With `--detail`, each
trace's launches, kernel names, shortest, median and longest durations
and its events' time (`chip_smoke.TRACE`), one line per reading.

    python3 scripts/k1_fleet_sizes.py [--rounds 4] [--iters 20] [--detail]

Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apex_tpu_torch.ops import cuda_build  # noqa: E402
from apex_tpu_torch.physics import fleet_kernel  # noqa: E402
from apex_tpu_torch.physics.cassie_sim import cassie_model  # noqa: E402
import chip_smoke  # noqa: E402
from chip_smoke import (card_line, cuda_ms, device_ms,  # noqa: E402
                        k1_5k_terrain_inputs, k1_ramp_inputs,
                        k1_standing_inputs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--detail", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_fleet_sizes: no CUDA device")
    cuda_build.library()
    dev = torch.device("cuda")
    gen = torch.Generator()
    gen.manual_seed(0)
    cases = {}
    for B in (64, 1024, 3971, 10000):
        cases[f"flat B={B}"] = (cassie_model(),
                                k1_standing_inputs(B, gen, dev))
    mh = cassie_model(enable_hfield=True)
    cases["terrain B=10000"] = (mh, k1_standing_inputs(10000, gen, dev,
                                                       terrain=0.03))
    cases["5k tables B=3971"] = (mh, k1_5k_terrain_inputs(3971, gen, dev))
    cases["ramps B=3971"] = (mh, k1_ramp_inputs(3971, gen, dev))
    times = {k: ([], []) for k in cases}
    names = list(cases)
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            m, (params, qpos, qvel, rows) = cases[name]
            fn = lambda: fleet_kernel.pd_substep(m, params, qpos, qvel, rows)
            times[name][0].append(device_ms(fn, args.iters,
                                            "pd_substep_kernel"))
            if args.detail:
                print(f"{name} round {r}: {chip_smoke.TRACE}", flush=True)
            times[name][1].append(cuda_ms(fn, args.iters))
    print(card_line())
    print("K1 launch:", fleet_kernel.launch_info(cassie_model()))
    for name, (prof, events) in times.items():
        print(f"{name}: profiler ms median {np.median(prof):.4f} "
              f"(rounds {', '.join(f'{x:.4f}' for x in prof)}); events ms "
              f"median {np.median(events):.4f} "
              f"(rounds {', '.join(f'{x:.4f}' for x in events)})",
              flush=True)


if __name__ == "__main__":
    main()
