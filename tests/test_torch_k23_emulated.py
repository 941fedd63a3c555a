"""K2's and K3's CUDA sources (`apex_tpu_torch/csrc/fleet_fk.cu`,
`spd_inverse.cu`) run on the CPU.

The card is the only place the kernels run for real (tests/test_torch_cuda.py,
chip_smoke.py). Here each source is compiled by g++ as C++ against a stub of
the CUDA names it uses and each block is run with one OS thread per lane:
`__syncwarp` and `__syncthreads` become pthread barriers over the warp and
the block, `__shfl_sync` a per-warp slot between two warp barriers, and
`__fmaf_rn` / `__fmul_rn` plain products and sums. With -ffp-contract=off
nothing is fused, so the order of every sum is exercised as written, with
the lanes interleaved by the OS scheduler instead of in lockstep. K2 is
held to `fk_plain` on Cassie and on `chip_smoke.fk_tree_model`'s tree, K3
to the unrolled Cholesky; repeated runs give the same bits. Skips where
g++ is missing.

Run as a script with `--parent DIR` (DIR holding an older checkout's
`apex_tpu_torch/`, one thread per env), it compiles that checkout's K2 the
same way and compares the two sources' outputs bit for bit:

    python tests/test_torch_k23_emulated.py --parent chip_proof/parent
"""
import argparse
import ctypes
import dataclasses
import importlib.util
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apex_tpu_torch.ops import cuda_build, pallas_linalg  # noqa: E402
from apex_tpu_torch.physics import fleet_fk  # noqa: E402
from apex_tpu_torch.physics.cassie_sim import cassie_model  # noqa: E402
from apex_tpu_torch.physics.spec import JointType  # noqa: E402
from chip_smoke import (cassie_inputs, fk_tree_inputs,  # noqa: E402
                        fk_tree_model, random_spd)

STUB = r"""
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <pthread.h>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx, blockIdx;
extern dim3_ blockDim;
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmaf_rn(float a, float b, float c) { return a * b + c; }
template <class T>
T __ldg(const T* p) { return *p; }
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
void __syncwarp(unsigned mask = 0xffffffffu);
void __syncthreads();
float __shfl_sync(unsigned mask, float v, int src);
extern unsigned char emulated_smem[];
typedef int cudaError_t;
"""

HARNESS = r"""
#include <thread>
#include <vector>
thread_local dim3_ threadIdx, blockIdx;
dim3_ blockDim;
alignas(16) unsigned char emulated_smem[1 << 18];
static pthread_barrier_t warp_bar[32], block_bar;
static float shfl_slot[32][32];
void __syncwarp(unsigned) { pthread_barrier_wait(&warp_bar[threadIdx.x / 32]); }
void __syncthreads() { pthread_barrier_wait(&block_bar); }
float __shfl_sync(unsigned, float v, int src) {
  const int w = threadIdx.x / 32;
  shfl_slot[w][threadIdx.x % 32] = v;
  pthread_barrier_wait(&warp_bar[w]);
  const float got = shfl_slot[w][src];
  pthread_barrier_wait(&warp_bar[w]);
  return got;
}
template <class F>
static void run_blocks(int nblocks, int nthreads, F kernel) {
  blockDim = {unsigned(nthreads), 1, 1};
  for (int blk = 0; blk < nblocks; ++blk) {
    for (int w = 0; w < nthreads / 32; ++w)
      pthread_barrier_init(&warp_bar[w], nullptr, 32);
    pthread_barrier_init(&block_bar, nullptr, nthreads);
    std::vector<std::thread> lanes;
    for (int t = 0; t < nthreads; ++t)
      lanes.emplace_back([=] {
        threadIdx = {unsigned(t), 0, 0};
        blockIdx = {unsigned(blk), 0, 0};
        kernel();
      });
    for (auto& lane : lanes) lane.join();
    for (int w = 0; w < nthreads / 32; ++w)
      pthread_barrier_destroy(&warp_bar[w]);
    pthread_barrier_destroy(&block_bar);
  }
}
"""

ENTRY = {
    "fleet_fk": (r"""
extern "C" int emulate(const float* qpos, const float* ipos, float* out,
    const int* itab, const float* ftab, int nitab, int nftab, int stride,
    int B) {
  if (smem_bytes(nitab, nftab, stride) > int(sizeof(emulated_smem)))
    return 1;
  run_blocks((B + kEnvs - 1) / kEnvs, kThreads, [=] {
    fleet_fk_kernel(qpos, ipos, out, itab, ftab, nitab, nftab, B);
  });
  return 0;
}
""", (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4),
    "spd_inverse": (r"""
template <bool kBatchFirst>
static void run_k3(const float* A, float* out, int n, int B) {
  const int blocks = (B + kMats - 1) / kMats;
  if (n <= 8)
    run_blocks(blocks, kMats * 32,
               [=] { spd_inverse_kernel<8, kBatchFirst>(A, out, n, B); });
  else if (n <= 16)
    run_blocks(blocks, kMats * 32,
               [=] { spd_inverse_kernel<16, kBatchFirst>(A, out, n, B); });
  else
    run_blocks(blocks, kMats * 32,
               [=] { spd_inverse_kernel<32, kBatchFirst>(A, out, n, B); });
}
extern "C" int emulate(const float* A, float* out, int n, int B,
                       int batch_first) {
  if (batch_first)
    run_k3<true>(A, out, n, B);
  else
    run_k3<false>(A, out, n, B);
  return 0;
}
""", (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 3),
    # the one-thread-per-env K2 of older checkouts: no barriers
    "fleet_fk_parent": (r"""
extern "C" int emulate(const float* qpos, const float* ipos, float* xpos,
    float* xmat, float* xipos, float* cdof, const int* itab,
    const float* ftab, int nbody, int root_origin, int B) {
  blockDim = {64, 1, 1};
  for (int b = 0; b < B; ++b) {
    blockIdx = {unsigned(b / 64), 0, 0};
    threadIdx = {unsigned(b % 64), 0, 0};
    fleet_fk_kernel(qpos, ipos, xpos, xmat, xipos, cdof, itab, ftab, nbody,
                    root_origin, B);
  }
  return 0;
}
""", (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 3),
}


def emulation_source(src: str, entry: str) -> str:
    """The kernel part of `src` (up to the end of its anonymous namespace)
    as C++ for the stub, its dynamic shared memory mapped onto the
    harness's, followed by the harness and the `emulate` entry point."""
    end = "}  // namespace"
    assert end in src, f"no {end!r} in the source: update the emulation"
    kernel = src[:src.index(end) + len(end)]
    kernel = kernel.replace("#include <cuda_runtime.h>", STUB)
    for name in ("k2_smem", "k3_smem"):
        kernel = kernel.replace(
            f"extern __shared__ float4 {name}[];",
            f"float4* {name} = reinterpret_cast<float4*>(emulated_smem);")
    assert "extern __shared__" not in kernel, "unmapped shared memory"
    return kernel + "\n" + HARNESS + ENTRY[entry][0]


def build(src: str, entry: str, work: Path):
    """g++ the emulation of `src` with entry point `entry`; the library."""
    gxx = shutil.which("g++")
    cpp = work / f"{entry}_emulated.cpp"
    cpp.write_text(emulation_source(src, entry))
    so = cpp.with_suffix(".so")
    done = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                           "-fno-strict-aliasing", "-fPIC", "-shared",
                           "-pthread", str(cpp), "-o", str(so)],
                          capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed on {cpp.name}:\n{done.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.emulate.argtypes = ENTRY[entry][1]
    lib.emulate.restype = ctypes.c_int
    return lib


def _outputs(m, B):
    return [torch.full(s, float("nan")) for s in
            ((m.nbody, 3, B), (m.nbody, 3, 3, B), (m.nbody, 3, B),
             (m.nv, 6, B))]


def run_fk(lib, m, ipos, qpos):
    """The emulated kernel of this checkout: (xpos, ximat, xipos, cdof)."""
    B = qpos.shape[-1]
    tabs = fleet_fk._fk_tables(m, torch.device("cpu"))
    out = torch.full((15 * m.nbody + 6 * m.nv, B), float("nan"))
    assert lib.emulate(qpos.data_ptr(), ipos.data_ptr(), out.data_ptr(),
                       tabs.itab.data_ptr(), tabs.ftab.data_ptr(),
                       tabs.itab.numel(), tabs.ftab.numel(), tabs.stride,
                       B) == 0
    return list(fleet_fk.kin_views(m, out, None))[:4]


def run_spd(lib, A, batch_first: bool = False):
    """The emulated K3 on batch-last (n, n, B) A, or K3-bf on batch-first
    (B, n, n) A."""
    n, B = (A.shape[-1], A.shape[0]) if batch_first else A.shape[1:]
    out = torch.full_like(A, float("nan"))
    assert lib.emulate(A.data_ptr(), out.data_ptr(), n, B,
                       int(batch_first)) == 0
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources as C++")
    work = tmp_path_factory.mktemp("k23_emulated")
    return {name: build((cuda_build.CSRC / f"{name}.cu").read_text(), name,
                        work) for name in ("fleet_fk", "spd_inverse")}


def _fk_case(which, B, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    if which == "cassie":
        m = cassie_model()
        qpos, _, params = cassie_inputs(B, gen)
        return m, params.body_ipos.contiguous(), qpos.contiguous()
    m = fk_tree_model()
    qpos, ipos = fk_tree_inputs(m, B, gen)
    return m, ipos, qpos


@pytest.mark.parametrize("which", ["cassie", "tree"])
def test_fk_schedule_covers_the_tree(which):
    """The walk's rounds hold every body once, at most 10 each, each body
    after its parent's round; the cross items hold every hinge and ball
    dof once and no slide dof; the table's header and round offsets say
    the same."""
    m = cassie_model() if which == "cassie" else fk_tree_model()
    rounds, cross = fleet_fk.fk_schedule(m)
    round_of = {i: r for r, bodies in enumerate(rounds) for i in bodies}
    assert sorted(round_of) == list(range(m.nbody))
    assert sum(len(r) for r in rounds) == m.nbody
    assert all(0 < len(r) <= fleet_fk.BODIES_PER_ROUND for r in rounds)
    for i in range(m.nbody):
        p = int(m.body_parent[i])
        assert p < 0 or round_of[p] < round_of[i], (i, p)
    want = sorted(j.dofadr + k for j in m.joints if j.jtype != JointType.SLIDE
                  for k in range(3 if j.jtype == JointType.BALL else 1))
    assert sorted(d for d, _ in cross) == want
    for d, jidx in cross:
        j = m.joints[jidx]
        assert j.dofadr <= d < j.dofadr + (3 if j.jtype == JointType.BALL
                                           else 1)
    tabs = fleet_fk._fk_tables(m, torch.device("cpu"))
    itab = tabs.itab.tolist()
    assert itab[:7] == [m.nbody, len(m.joints), len(rounds), len(cross),
                        m.nq, m.nv, 1]
    assert itab[8:8 + len(rounds) + 1] == [
        sum(len(r) for r in rounds[:k]) for k in range(len(rounds) + 1)]
    at = 8 + len(rounds) + 1 + (-(len(rounds) + 1) % 4)
    slots = [i for r in rounds for i in r]
    assert itab[at:at + 4 * m.nbody:4] == slots
    assert itab[at + 1:at + 4 * m.nbody:4] == [int(m.body_parent[i])
                                              for i in slots]
    assert tabs.stride % 32 == 4 and tabs.stride >= (
        15 * m.nbody + 6 * m.nv + m.nq + 3 * m.nbody + 12 * len(m.joints))
    if which == "tree":   # deeper than Cassie (8), a level in two rounds
        depth = [0] * m.nbody
        for i in range(m.nbody):
            p = int(m.body_parent[i])
            depth[i] = 0 if p < 0 else depth[p] + 1
        assert max(depth) > 8 and len(rounds) > max(depth) + 1


@pytest.mark.parametrize("which", ["cassie", "tree"])
def test_emulated_fk_matches_plain(libs, which):
    """The K2 source against `fk_plain` at rtol = atol = 1e-5 (the card
    tests' tolerance) on 20 envs: two blocks and a partial one."""
    m, ipos, qpos = _fk_case(which, 20, seed=3)
    got = run_fk(libs["fleet_fk"], m, ipos, qpos)
    ref = fleet_fk.fk_plain(m, ipos, qpos)
    for name, a, b in zip(("xpos", "ximat", "xipos", "cdof"), got, ref):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def test_emulated_fk_is_deterministic_and_per_env(libs):
    """Two runs give the same bits however the OS interleaves the lanes (a
    missing __syncwarp between two rounds would let a child read its
    parent's frame before it is written), and an env's outputs do not
    depend on the other envs of its block."""
    for which in ("cassie", "tree"):
        m, ipos, qpos = _fk_case(which, 11, seed=4)
        first = run_fk(libs["fleet_fk"], m, ipos, qpos)
        again = run_fk(libs["fleet_fk"], m, ipos, qpos)
        part = run_fk(libs["fleet_fk"], m, ipos[..., 2:5].contiguous(),
                      qpos[..., 2:5].contiguous())
        for a, b, c in zip(first, again, part):
            assert torch.equal(a, b)
            assert torch.equal(c, a[..., 2:5])


@pytest.mark.parametrize("n", [1, 9, 16, 32])
def test_emulated_spd_inverse_matches_plain(libs, n):
    """The K3 source against the unrolled Cholesky on random SPD at 1e-5 of
    max|A^-1| (the card tests' bound), at each width the kernel runs (n
    padded with the identity to 8, 16 or 32), on 20 matrices: two blocks
    and a partial one; a second run gives the same bits."""
    gen = torch.Generator()
    gen.manual_seed(n)
    A = random_spd(20, n, gen)
    got = run_spd(libs["spd_inverse"], A)
    ref = pallas_linalg.spd_inverse_bt_plain(A)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 1e-5 * scale
    assert torch.equal(run_spd(libs["spd_inverse"], A), got)


@pytest.mark.parametrize("n", [1, 9, 16, 32])
def test_emulated_spd_inverse_bf_is_k3_bit_for_bit(libs, n):
    """The batch-first route (K3-bf) on (B, n, n) gives the batch-last
    kernel's output on the same matrices laid out (n, n, B), bit for bit:
    only the global addresses differ. 20 matrices: two blocks and a
    partial one."""
    gen = torch.Generator()
    gen.manual_seed(100 + n)
    A = random_spd(20, n, gen)
    got = run_spd(libs["spd_inverse"], A.permute(2, 0, 1).contiguous(),
                  batch_first=True)
    assert torch.equal(got.permute(1, 2, 0), run_spd(libs["spd_inverse"], A))


def parent_tables(parent: Path):
    """The older checkout's `_fk_tables` (itab, ftab), on private copies of
    the models (the tables are cached on the model instance)."""
    spec = importlib.util.spec_from_file_location(
        "k2_parent_fleet_fk",
        parent / "apex_tpu_torch" / "physics" / "fleet_fk.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lambda m, dev: mod._fk_tables(dataclasses.replace(m), dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    args = ap.parse_args()
    work = Path(tempfile.mkdtemp(prefix="k23_emulated_"))
    new = build((cuda_build.CSRC / "fleet_fk.cu").read_text(), "fleet_fk",
                work)
    old = build((args.parent / "apex_tpu_torch" / "csrc" / "fleet_fk.cu")
                .read_text(), "fleet_fk_parent", work)
    tables = parent_tables(args.parent)
    same_all = True
    for which in ("cassie", "tree"):
        for B in (1, 33, 64, 1000, 1024):
            m, ipos, qpos = _fk_case(which, B, seed=B)
            got = run_fk(new, m, ipos, qpos)
            itab, ftab = tables(m, torch.device("cpu"))
            ref = _outputs(m, B)
            assert old.emulate(qpos.data_ptr(), ipos.data_ptr(),
                               *(o.data_ptr() for o in ref),
                               itab.data_ptr(), ftab.data_ptr(), m.nbody,
                               int(m.nv >= 3), B) == 0
            same = [torch.equal(a, b) for a, b in zip(got, ref)]
            same_all &= all(same)
            print(f"{which} B={B}: " + ", ".join(
                f"{name} {'bitwise equal' if s else 'DIFFERS'}"
                for name, s in zip(("xpos", "xmat", "xipos", "cdof"), same)),
                flush=True)
    shutil.rmtree(work)
    return 0 if same_all else 1


if __name__ == "__main__":
    sys.exit(main())
