"""Build and load the hand-written CUDA kernels of `apex_tpu_torch/csrc/`.

The sources are compiled by `nvcc` for Hopper (`sm_90a`) at first use, one
`nvcc -c` per source started together, then linked into one shared library
with a plain C interface and loaded with ctypes. The library is cached in
`apex_tpu_torch/build/` under a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads at once. Nothing here runs at
import time: this module imports on machines without nvcc or a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass Python ints as 32-bit ints)
SIGNATURES = {
    "apex_fleet_fk": (_P,) * 5 + (_I, _I, _I, _I, _P),
    "apex_fleet_fk_info": (_I, _I, _I, _P),
    "apex_spd_inverse": (_P, _P, _I, _I, _P),
    "apex_spd_inverse_bf": (_P, _P, _I, _I, _P),
    "apex_spd_inverse_info": (_I, _P),
    "apex_pd_substep": (_P,) * 14 + (_I, _I, _I, _P),
    "apex_pd_substep_info": (_I, _I, _P),
}

_LIB = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "of apex_tpu_torch are built at first use")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD / f"libapex_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the cached library is missing; returns its
    path. The compiler's register and spill report goes to a `.log` beside
    the library."""
    so = library_path()
    if so.is_file():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
               "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(log))
    tmp = BUILD / f"{tag}.so"
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in jobs),
         "-o", str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    so.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
