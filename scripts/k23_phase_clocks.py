"""Where K2's and K3's time goes inside one warp, by phase, on the card.

Builds instrumented copies of `apex_tpu_torch/csrc/fleet_fk.cu` and
`spd_inverse.cu` (or of `--fk-source` / `--spd-source`): before each phase
comment of the kernel body ("// ---- name" at the start of a line) and at
its end, the warp synchronizes and lane 0 stores `clock64()` for its env or
matrix (a warp per env or matrix; warps past B skip their compute phases
and record none of them). It then
launches the copies -- K2 on a dyn-rand Cassie fleet (`chip_smoke.
cassie_inputs`) at B = 1 (a warp alone on its SM), 64 and 1024, K3 on
Cassie's M + hD at B = 1, 64 and 1024 and on random SPD at (n = 9,
B = 2048) -- and prints, per phase, the mean
and the largest cycles over the warps, and the whole kernel's device time
per launch (torch.profiler) next to the uninstrumented kernel's, with the
card's name and power limit. A marker costs a __syncwarp and a store.

    python3 scripts/k23_phase_clocks.py [--fk-source FILE] [--spd-source FILE]

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

from apex_tpu_torch.ops import cuda_build, pallas_linalg  # noqa: E402
from apex_tpu_torch.physics import fleet_fk  # noqa: E402
from apex_tpu_torch.physics.cassie_sim import cassie_model  # noqa: E402
from chip_smoke import (card_line, cassie_inputs, cassie_mhd,  # noqa: E402
                        device_ms, random_spd)
from k23_variants import build_all  # noqa: E402

MAX_WARPS = 2048
SLOTS = 16
_P, _I = ctypes.c_void_p, ctypes.c_int


def instrument(src: str):
    """The source with a clock marker before each phase comment of its
    kernel (the last function of its anonymous namespace) and at the
    kernel's end; returns (text, phase names)."""
    end = src.index("}  // namespace")
    names = []

    def marker(slot, pad="  "):
        warp = "(blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5))"
        return (f"{pad}__syncwarp();\n{pad}if ((threadIdx.x & 31) == 0 && "
                f"{warp} < {MAX_WARPS}) k23_clk[(size_t){warp} * {SLOTS} + "
                f"{slot}] = clock64();\n")

    def mark(match):
        names.append(match.group(2))
        return marker(len(names) - 1, match.group(1)) + match.group(0)
    head = re.sub(r"^( +)// ---- (\w+)", mark, src[:end], flags=re.M)
    close = head.rindex("\n}\n")
    names.append("end")
    if len(names) > SLOTS:
        raise RuntimeError("too many phases")
    text = (head[:close + 1] + marker(len(names) - 1) + head[close + 1:]
            + src[end:])
    text = text.replace(
        "namespace {", "namespace {\n__device__ long long "
        f"k23_clk[{MAX_WARPS * SLOTS}];\n", 1)
    text += f"""
extern "C" int k23_read_clocks(long long* out) {{
  return static_cast<int>(cudaMemcpyFromSymbol(out, k23_clk,
      sizeof(long long) * {MAX_WARPS * SLOTS}));
}}
"""
    return text, names


def report(lib, names, n_warps, ms_i, ms_p, what):
    clk = np.zeros(MAX_WARPS * SLOTS, np.int64)
    cuda_build.check(lib.k23_read_clocks(clk.ctypes.data), "k23_read_clocks")
    c = clk.reshape(MAX_WARPS, SLOTS)[:n_warps, :len(names)].copy()
    d = np.diff(c, axis=1)
    total = c[:, -1] - c[:, 0]
    print(f"{what}: kernel {ms_p:.4f} ms as is, {ms_i:.4f} ms instrumented; "
          f"cycles per warp from the first marker, mean {total.mean():.0f}, "
          f"max {total.max()}", flush=True)
    for k, name in enumerate(names[:-1]):
        print(f"  {name:12s} mean {d[:, k].mean():8.0f} "
              f"({d[:, k].mean() / total.mean():6.1%}) max {d[:, k].max():8d}",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fk-source", type=Path,
                    default=cuda_build.CSRC / "fleet_fk.cu")
    ap.add_argument("--spd-source", type=Path,
                    default=cuda_build.CSRC / "spd_inverse.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k23_phase_clocks: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    fk_text, fk_names = instrument(args.fk_source.read_text())
    spd_text, spd_names = instrument(args.spd_source.read_text())
    built = build_all({"fk_clocks": fk_text, "spd_clocks": spd_text,
                       "fk_as_is": args.fk_source.read_text(),
                       "spd_as_is": args.spd_source.read_text()})
    for name, (lib, regs) in built.items():
        print(f"{name}: {regs}", flush=True)
        if "clocks" in name:
            lib.k23_read_clocks.argtypes = (_P,)
        if "fk" in name:
            lib.apex_fleet_fk.argtypes = cuda_build.SIGNATURES["apex_fleet_fk"]
        else:
            lib.apex_spd_inverse.argtypes = (_P, _P, _I, _I, _P)

    def fk(lib, m, ipos, qpos, out):
        tabs = fleet_fk._fk_tables(m, dev)
        cuda_build.check(lib.apex_fleet_fk(
            qpos.data_ptr(), ipos.data_ptr(), out.data_ptr(),
            tabs.itab.data_ptr(), tabs.ftab.data_ptr(), tabs.itab.numel(),
            tabs.ftab.numel(), tabs.stride, qpos.shape[-1],
            torch.cuda.current_stream().cuda_stream), "apex_fleet_fk")

    def spd(lib, A, out):
        n, _, B = A.shape
        cuda_build.check(lib.apex_spd_inverse(
            A.data_ptr(), out.data_ptr(), n, B,
            torch.cuda.current_stream().cuda_stream), "apex_spd_inverse")

    gen = torch.Generator()
    gen.manual_seed(0)
    m = cassie_model()
    for B in (1, 64, 1024):
        qpos, _, params = cassie_inputs(B, gen)
        qpos, ipos = qpos.to(dev), params.body_ipos.to(dev)
        out = torch.empty((15 * m.nbody + 6 * m.nv, B), device=dev)
        lib_i, lib_p = built["fk_clocks"][0], built["fk_as_is"][0]
        fk(lib_i, m, ipos, qpos, out)
        torch.cuda.synchronize()
        ms_i = device_ms(lambda: fk(lib_i, m, ipos, qpos, out), 100,
                         "fleet_fk_kernel")
        ms_p = device_ms(lambda: fk(lib_p, m, ipos, qpos, out), 100,
                         "fleet_fk_kernel")
        fk(lib_i, m, ipos, qpos, out)
        torch.cuda.synchronize()
        report(lib_i, fk_names, B, ms_i, ms_p, f"K2 cassie B={B}")
    for n, B in ((32, 1), (32, 64), (32, 1024), (9, 2048)):
        A = (cassie_mhd(B, gen, dev) if n == 32
             else random_spd(B, n, gen).to(dev))
        out = torch.empty_like(A)
        lib_i, lib_p = built["spd_clocks"][0], built["spd_as_is"][0]
        ms_i = device_ms(lambda: spd(lib_i, A, out), 100,
                         "spd_inverse_kernel")
        ms_p = device_ms(lambda: spd(lib_p, A, out), 100,
                         "spd_inverse_kernel")
        spd(lib_i, A, out)
        torch.cuda.synchronize()
        report(lib_i, spd_names, B, ms_i, ms_p, f"K3 n={n} B={B} "
               f"(width {pallas_linalg.launch_info(n)['width']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
