"""K2 and K3 beside an older checkout's K2 and K3, on one card, on the same
inputs.

Builds the forward-kinematics kernel K2 (`csrc/fleet_fk.cu`) and the batched
SPD inverse K3 (`csrc/spd_inverse.cu`) of an older checkout, each into a
library of its own, beside this checkout's (as the port loads them). Then:

  - K2 on a dyn-rand Cassie fleet (`chip_smoke.cassie_inputs`) and on
    `chip_smoke.fk_tree_model`'s tree at B = 1, 33, 64, 1000 and 1024: whether
    each output (xpos, xmat, xipos, cdof) is bit for bit the older
    kernel's, and the largest difference where it is not;
  - K3 on random SPD (n = 32 and 9) and on Cassie's M + hD: the largest
    difference between the two kernels, and each one's against the plain
    version, relative to max|A^-1|;
  - device times per launch from torch.profiler's trace, in turns (this
    checkout's, the older, the older, this checkout's), for K2 at B = 64
    and 1024, K3 at (n = 32, B = 64 and 1024) and (n = 9, B = 2048), with
    torch.linalg.inv beside K3;
  - each build's registers and stack frame (nvcc -Xptxas -v), and this
    checkout's kernels' shared memory per block and residency;
and prints the card's name and power limit first.

    python3 scripts/k23_variants.py --parent DIR [--iters 100]

DIR holds an older checkout's `apex_tpu_torch/` (for example `git archive
<commit> apex_tpu_torch | tar -x -C DIR`), whose K2 takes the tables of
its own `physics/fleet_fk.py` and is launched one thread per env with the
entry point `apex_fleet_fk(..., itab, ftab, nbody, root_origin, B,
stream)`. Exits non-zero if a K2 output differs. Needs a CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apex_tpu_torch.ops import cuda_build, pallas_linalg  # noqa: E402
from apex_tpu_torch.physics import fleet_fk  # noqa: E402
from apex_tpu_torch.physics.cassie_sim import cassie_model  # noqa: E402
from chip_smoke import (build_report, card_line, cassie_inputs,  # noqa: E402
                        cassie_mhd, device_ms, fk_tree_inputs, fk_tree_model,
                        random_spd)

_P, _I = ctypes.c_void_p, ctypes.c_int


def build_all(sources: dict) -> dict:
    """nvcc each {name: source text} into its own library (cached by
    content), all started together; {name: (library, register report)}."""
    cuda_build.BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        h = hashlib.sha256((text + " ".join(cuda_build.NVCC_FLAGS))
                           .encode()).hexdigest()[:12]
        src = cuda_build.BUILD / f"k23_{name}_{h}.cu"
        so = src.with_suffix(".so")
        proc = None
        if not so.is_file():
            src.write_text(text)
            proc = subprocess.Popen(
                [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas",
                 "-v", "-shared", str(src), "-o", str(so)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (so, proc)
    out = {}
    for name, (so, proc) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
            so.with_suffix(".log").write_text(log)
        out[name] = (ctypes.CDLL(str(so)),
                     build_report(so.with_suffix(".log").read_text()))
    return out


def parent_fk_tables(parent: Path):
    """The older checkout's `_fk_tables` (itab, ftab), on private copies of
    the models (the tables are cached on the model instance)."""
    spec = importlib.util.spec_from_file_location(
        "k23_parent_fleet_fk",
        parent / "apex_tpu_torch" / "physics" / "fleet_fk.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    copies = {}

    def tables(m, dev):
        if id(m) not in copies:
            copies[id(m)] = (m, dataclasses.replace(m))
        return mod._fk_tables(copies[id(m)][1], dev)
    return tables


def parent_fk(lib, tables):
    lib.apex_fleet_fk.argtypes = (_P,) * 8 + (_I, _I, _I, _P)
    lib.apex_fleet_fk.restype = _I

    def run(m, ipos, qpos):
        B = qpos.shape[-1]
        itab, ftab = tables(m, qpos.device)
        outs = [torch.empty(s, device=qpos.device) for s in
                ((m.nbody, 3, B), (m.nbody, 3, 3, B), (m.nbody, 3, B),
                 (m.nv, 6, B))]
        err = lib.apex_fleet_fk(
            qpos.data_ptr(), ipos.data_ptr(), *(o.data_ptr() for o in outs),
            itab.data_ptr(), ftab.data_ptr(), m.nbody, int(m.nv >= 3), B,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check(err, "parent apex_fleet_fk")
        return outs
    return run


def parent_spd(lib):
    lib.apex_spd_inverse.argtypes = (_P, _P, _I, _I, _P)
    lib.apex_spd_inverse.restype = _I

    def run(A):
        out = torch.empty_like(A)
        n, _, B = A.shape
        cuda_build.check(lib.apex_spd_inverse(
            A.data_ptr(), out.data_ptr(), n, B,
            torch.cuda.current_stream().cuda_stream),
            "parent apex_spd_inverse")
        return out
    return run


def in_turns(fns: dict, iters: int, kernel: str) -> dict:
    """Device ms per launch of each fn, first to last then last to first."""
    times = {name: [] for name in fns}
    for order in (list(fns), list(reversed(fns))):
        for name in order:
            times[name].append(device_ms(fns[name], iters, kernel))
    return times


def fmt(ts) -> str:
    return " ".join(f"{t:.4f}" for t in ts)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k23_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(card_line(), flush=True)
    csrc = args.parent / "apex_tpu_torch" / "csrc"
    built = build_all({"fk_parent": (csrc / "fleet_fk.cu").read_text(),
                       "spd_parent": (csrc / "spd_inverse.cu").read_text()})
    so = cuda_build.build()
    cuda_build.library()
    log = so.with_suffix(".log").read_text()
    for src in ("fleet_fk.cu", "spd_inverse.cu"):
        print(f"this checkout's {src}: {build_report(log, src)}", flush=True)
    for name, (_, report) in built.items():
        print(f"{name}: {report}", flush=True)
    old_fk = parent_fk(built["fk_parent"][0], parent_fk_tables(args.parent))
    old_spd = parent_spd(built["spd_parent"][0])
    new_fk = lambda m, ipos, qpos: list(fleet_fk.fleet_fk(m, ipos, qpos))[:4]
    gen = torch.Generator()
    gen.manual_seed(0)
    models = {"cassie": cassie_model(), "tree": fk_tree_model()}
    for which, m in models.items():
        print(f"K2 {which}: {fleet_fk.launch_info(m)}", flush=True)
    for n in (9, 32):
        print(f"K3 n={n}: {pallas_linalg.launch_info(n)}", flush=True)

    same_all = True
    for which, m in models.items():
        for B in (1, 33, 64, 1000, 1024):
            if which == "cassie":
                qpos, _, params = cassie_inputs(B, gen)
                ipos = params.body_ipos
            else:
                qpos, ipos = fk_tree_inputs(m, B, gen)
            qpos, ipos = qpos.to(dev).contiguous(), ipos.to(dev).contiguous()
            got, ref = new_fk(m, ipos, qpos), old_fk(m, ipos, qpos)
            torch.cuda.synchronize()
            parts = []
            for name, a, b in zip(("xpos", "xmat", "xipos", "cdof"), got,
                                  ref):
                same = torch.equal(a, b)
                same_all &= same
                parts.append(f"{name} " + ("bitwise equal" if same else
                                           f"DIFFERS by up to "
                                           f"{float((a - b).abs().max()):.3e}"))
            line = f"K2 {which} B={B}: " + ", ".join(parts)
            if which == "cassie" and B in (64, 1024):
                t = in_turns({"new": lambda: new_fk(m, ipos, qpos),
                              "parent": lambda: old_fk(m, ipos, qpos)},
                             args.iters, "fleet_fk_kernel")
                line += (f"; ms new {fmt(t['new'])}, parent "
                         f"{fmt(t['parent'])}")
            print(line, flush=True)

    for n, B, kind in ((32, 64, "random"), (32, 1024, "random"),
                       (32, 64, "cassie"), (32, 1024, "cassie"),
                       (9, 2048, "random")):
        A = (random_spd(B, n, gen).to(dev) if kind == "random"
             else cassie_mhd(B, gen, dev))
        got, old = pallas_linalg.spd_inverse_bt(A), old_spd(A)
        ref = pallas_linalg.spd_inverse_bt_plain(A)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        rel = lambda x: (x - ref).abs().max().item() / scale
        t = in_turns({"new": lambda: pallas_linalg.spd_inverse_bt(A),
                      "parent": lambda: old_spd(A)}, args.iters,
                     "spd_inverse_kernel")
        Abf = A.permute(2, 0, 1).contiguous()
        lib_ms = device_ms(lambda: torch.linalg.inv(Abf), args.iters)
        print(f"K3 {kind} n={n} B={B}: new vs parent max |diff| "
              f"{(got - old).abs().max().item():.3e} "
              f"({(got - old).abs().max().item() / scale:.2e} of max); vs "
              f"plain new {rel(got):.2e}, parent {rel(old):.2e} of max; ms "
              f"new {fmt(t['new'])}, parent {fmt(t['parent'])}, "
              f"torch.linalg.inv {lib_ms:.4f}", flush=True)
    print("K2 outputs bitwise equal to the older kernel's: "
          f"{'yes' if same_all else 'NO'}", flush=True)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
