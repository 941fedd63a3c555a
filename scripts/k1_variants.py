"""K1 builds side by side on one card, on the same inputs.

Builds the whole-substep kernel of this checkout (`apex_tpu_torch/csrc/
fleet_kernel.cu`) at several block sizes (envs per block, two warps each:
the source's `kEnvsPerBlock`, substituted in a copy), and optionally an older
checkout's K1 beside it, each into a library of its own. Then, for the flat
and the heightfield model at B = 64 and 1024, on `chip_smoke.k1_inputs`'s
perturbed fleets (on terrain of amplitude 0.06 for the heightfield model),
it prints each build's largest difference from the kernel of this checkout
as the port loads it, and each build's device time per launch (from
torch.profiler), in turns (first to last, then last to first), with the
card's name and power limit.

    python3 scripts/k1_variants.py [--envs-per-block 1 2 4 8] [--parent DIR]

DIR holds an older checkout's `apex_tpu_torch/` (for example `git archive
<commit> apex_tpu_torch | tar -x -C DIR`); its `physics/fleet_kernel.py`
builds the tables its kernel reads. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apex_tpu_torch.ops import cuda_build  # noqa: E402
from apex_tpu_torch.physics import fleet_kernel  # noqa: E402
from apex_tpu_torch.physics.cassie_sim import cassie_model  # noqa: E402
from chip_smoke import card_line, device_ms, k1_inputs  # noqa: E402

BLOCK_CONST = re.compile(r"constexpr int kEnvsPerBlock = \d+;")


def build(src_text: str, name: str) -> tuple:
    """nvcc one K1 source into its own library (cached by content);
    returns (the loaded library, the compiler's register report)."""
    h = hashlib.sha256((src_text + " ".join(cuda_build.NVCC_FLAGS))
                       .encode()).hexdigest()[:12]
    cuda_build.BUILD.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD / f"k1_{name}_{h}.cu"
    so = src.with_suffix(".so")
    if not so.is_file():
        src.write_text(src_text)
        out = subprocess.run(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
             "-shared", str(src), "-o", str(so)],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{out.stdout}"
                               f"{out.stderr}")
        so.with_suffix(".log").write_text(out.stdout + out.stderr)
    lib = ctypes.CDLL(str(so))
    lib.apex_pd_substep.restype = ctypes.c_int
    report = [ln.strip() for ln in so.with_suffix(".log").read_text()
              .splitlines() if "registers" in ln or "stack frame" in ln]
    return lib, report


def launcher(lib, tables, sizes=True):
    """fn(model, params, qpos, qvel, rows) -> outputs, through `lib` with
    the tables `tables(model, device)`; `sizes`: the entry point takes the
    tables' lengths (older sources' did not)."""
    lib.apex_pd_substep.argtypes = (
        cuda_build.SIGNATURES["apex_pd_substep"] if sizes
        else (ctypes.c_void_p,) * 14 + (ctypes.c_int, ctypes.c_void_p))
    def run(m, params, qpos, qvel, rows):
        B = qpos.shape[-1]
        ipos, misc, hf = fleet_kernel.static_rows(m, params)
        itab, ftab = tables(m, qpos.device)
        outs = [torch.empty(r, B, device=qpos.device)
                for r in (m.nq, m.nv, m.nv, fleet_kernel.DIAG_ROWS)]
        ins = (qpos, qvel, rows, params.dof_damping, params.body_mass, ipos,
               misc)
        lens = (itab.numel(), ftab.numel()) if sizes else ()
        err = lib.apex_pd_substep(
            *(x.data_ptr() for x in ins),
            hf.data_ptr() if m.enable_hfield else None,
            *(o.data_ptr() for o in outs), itab.data_ptr(), ftab.data_ptr(),
            *lens, B, torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "apex_pd_substep")
        return outs
    return run


def parent_tables(parent: Path):
    """The older checkout's `_k1_tables`, on private copies of the models
    (the tables are cached on the model instance)."""
    spec = importlib.util.spec_from_file_location(
        "k1_parent_fleet_kernel",
        parent / "apex_tpu_torch" / "physics" / "fleet_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    copies = {}

    def tables(m, dev):
        key = m.enable_hfield
        if key not in copies:
            copies[key] = dataclasses.replace(m)
        return mod._k1_tables(copies[key], dev)
    return tables


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--envs-per-block", type=int, nargs="+",
                    default=[1, 2, 4, 8])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    src = (cuda_build.CSRC / "fleet_kernel.cu").read_text()
    if not BLOCK_CONST.search(src):
        raise RuntimeError("no kEnvsPerBlock constant in fleet_kernel.cu")
    builds = {}
    for e in args.envs_per_block:
        lib, report = build(BLOCK_CONST.sub(
            f"constexpr int kEnvsPerBlock = {e};", src), f"e{e}")
        builds[f"envs_per_block={e}"] = launcher(lib, fleet_kernel._k1_tables)
        print(f"envs_per_block={e}: " + " | ".join(report), flush=True)
    if args.parent:
        lib, report = build(
            (args.parent / "apex_tpu_torch" / "csrc" / "fleet_kernel.cu")
            .read_text(), "parent")
        builds["parent"] = launcher(lib, parent_tables(args.parent),
                                    sizes=False)
        print("parent: " + " | ".join(report), flush=True)

    gen = torch.Generator()
    gen.manual_seed(0)
    for hfield in (False, True):
        m = cassie_model(enable_hfield=hfield)
        for B in (64, 1024):
            inputs = k1_inputs(B, gen, dev, 0.06 if hfield else 0.0)
            ref = fleet_kernel.pd_substep(m, *inputs)
            times = {name: [] for name in builds}
            for order in (list(builds), list(reversed(builds))):
                for name in order:
                    times[name].append(device_ms(
                        lambda: builds[name](m, *inputs), args.iters,
                        "pd_substep_kernel"))
            for name, fn in builds.items():
                got = fn(m, *inputs)
                torch.cuda.synchronize()
                diff = max(float((a - b).abs().max()) for a, b in
                           zip(got, ref))
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                print(f"{'hfield' if hfield else 'flat'} B={B} {name}: "
                      f"ms {' '.join(f'{t:.4f}' for t in times[name])}; "
                      f"max |diff| from the port's K1 {diff:.3e}"
                      f"{' (bitwise equal)' if same else ''}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
