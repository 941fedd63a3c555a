"""Where K1's time goes inside one env's warp, by phase, on the card.

Builds an instrumented copy of `apex_tpu_torch/csrc/fleet_kernel.cu` (or
of `--source`): before each phase comment of the kernel body ("  // ----
...") and at its end, the warp synchronizes and lane 0 stores `clock64()`
for its env. It then launches the copy on `chip_smoke.k1_inputs`'s
perturbed fleets (flat, and the heightfield model on terrain of amplitude
0.06) at B = 64 and 1024 and prints, per phase, the mean and the largest
cycles over the envs, and the whole kernel's device time per launch (from
torch.profiler) next to the uninstrumented kernel's. The markers cost a __syncwarp and a store
each; the totals say how much.

    python3 scripts/k1_phase_clocks.py [--source FILE]

Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from apex_tpu_torch.ops import cuda_build  # noqa: E402
from apex_tpu_torch.physics import fleet_kernel  # noqa: E402
from apex_tpu_torch.physics.cassie_sim import cassie_model  # noqa: E402
from chip_smoke import card_line, device_ms, k1_inputs  # noqa: E402
from k1_variants import build, launcher  # noqa: E402

MAX_ENVS = 1024
SLOTS = 32


def instrument(src: str):
    """The source with a clock marker before each phase of the kernel body
    and at its end; returns (text, phase names)."""
    head, rest = src.split("pd_substep_kernel(", 1)
    body, tail = rest.split("#undef ROW", 1)
    names = []

    def mark(match):
        names.append(match.group(1).strip(" -"))
        return (f"  __syncwarp();\n  if (lane == 0) k1_clk[(size_t)b * {SLOTS}"
                f" + {len(names) - 1}] = clock64();\n{match.group(0)}")
    define = "#define ROW(ptr, r) (ptr)[(size_t)(r) * B + b]\n"
    body = body.replace(define, define + "  // ---- loads\n", 1)
    body = re.sub(r"^  // ---- ([^\n]*)$", mark, body, flags=re.M)
    names.append("end")
    body += (f"  __syncwarp();\n  if (lane == 0) k1_clk[(size_t)b * {SLOTS} + "
             f"{len(names) - 1}] = clock64();\n")
    if len(names) > SLOTS:
        raise RuntimeError("too many phases")
    glob = (f"__device__ long long k1_clk[{MAX_ENVS * SLOTS}];\n")
    text = (head.replace("namespace {", "namespace {\n" + glob, 1)
            + "pd_substep_kernel(" + body + "#undef ROW" + tail)
    text += f"""
extern "C" int k1_read_clocks(long long* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, k1_clk,
      sizeof(long long) * {MAX_ENVS * SLOTS}));
}}
"""
    return text, names


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", type=Path,
                    default=cuda_build.CSRC / "fleet_kernel.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    src = args.source.read_text()
    text, names = instrument(src)
    lib, report = build(text, "clocks")
    lib.k1_read_clocks.argtypes = (ctypes.c_void_p,)
    run = launcher(lib, fleet_kernel._k1_tables)
    plain_lib, plain_report = build(src, "plain")
    plain = launcher(plain_lib, fleet_kernel._k1_tables)
    print("instrumented: " + " | ".join(report), flush=True)
    print("as is: " + " | ".join(plain_report), flush=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    clk = np.zeros(MAX_ENVS * SLOTS, np.int64)
    for hfield in (False, True):
        m = cassie_model(enable_hfield=hfield)
        for B in (64, MAX_ENVS):
            inputs = k1_inputs(B, gen, dev, 0.06 if hfield else 0.0)
            run(m, *inputs)
            torch.cuda.synchronize()
            cuda_build.check(lib.k1_read_clocks(clk.ctypes.data),
                             "k1_read_clocks")
            c = clk.reshape(MAX_ENVS, SLOTS)[:B, :len(names)]
            d = np.diff(c, axis=1)
            total = c[:, -1] - c[:, 0]
            ms_i = device_ms(lambda: run(m, *inputs), 50, "pd_substep_kernel")
            ms_p = device_ms(lambda: plain(m, *inputs), 50,
                             "pd_substep_kernel")
            print(f"{'hfield' if hfield else 'flat'} B={B}: kernel {ms_p:.4f}"
                  f" ms as is, {ms_i:.4f} ms instrumented; cycles per env "
                  f"mean {total.mean():.0f}, max {total.max()}", flush=True)
            for k, name in enumerate(names[:-1]):
                print(f"  {name[:48]:48s} mean {d[:, k].mean():9.0f} "
                      f"({d[:, k].mean() / total.mean():6.1%}) max "
                      f"{d[:, k].max():9d}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
