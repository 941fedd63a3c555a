"""K1's CUDA source (`apex_tpu_torch/csrc/fleet_kernel.cu`) run on the CPU.

The card is the only place the kernel runs for real (tests/test_torch_cuda.py,
chip_smoke.py). Here its source is compiled by g++ as C++ against a stub of
the few CUDA names it uses, and each block is run with one OS thread per
lane: `__syncwarp`, the env's named barrier and `__syncthreads` become
pthread barriers over the warp, the env's two warps and the block. So the
lane schedule, the shared-memory layout, the tables and the formula order
are exercised as written, with the lanes interleaved by the OS scheduler
instead of in lockstep; g++ does not contract products into FMAs. The
outputs are held to `fleet_kernel.kernel_bounds` against the plain version,
as on the card. Skips where g++ is missing.
"""
import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from apex_tpu_torch.ops import cuda_build
from apex_tpu_torch.physics import fleet_kernel
from apex_tpu_torch.physics.cassie_sim import cassie_model
from chip_smoke import k1_inputs, k1_standing_inputs

STUB = r"""
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <pthread.h>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
struct float4 { float x, y, z, w; };
struct dim3_ { unsigned x, y, z; };
extern thread_local dim3_ threadIdx, blockIdx;
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
void __syncwarp(unsigned mask = 0xffffffffu);
void __syncthreads();
void k1_env_barrier(int slot);
extern unsigned char k1_emulated_smem[];
typedef int cudaError_t;
"""

HARNESS = r"""
#include <thread>
#include <vector>
thread_local dim3_ threadIdx, blockIdx;
alignas(16) unsigned char k1_emulated_smem[1 << 20];
static pthread_barrier_t warp_bar[32], env_bar[16], block_bar;
void __syncwarp(unsigned) { pthread_barrier_wait(&warp_bar[threadIdx.x / 32]); }
void __syncthreads() { pthread_barrier_wait(&block_bar); }
void k1_env_barrier(int slot) { pthread_barrier_wait(&env_bar[slot]); }

extern "C" int k1_emulate(const float* qpos, const float* qvel,
    const float* cmd, const float* damp, const float* mass,
    const float* ipos, const float* misc, const float* hfield,
    float* qpos_out, float* qvel_out, float* qacc_out, float* diag_out,
    const int* itab, const float* ftab, int nitab, int nftab, int B) {
  if (sizeof(Scratch) * kEnvsPerBlock + 4 * (nitab + nftab) >
      sizeof(k1_emulated_smem))
    return 1;
  for (int blk = 0; blk * kEnvsPerBlock < B; ++blk) {
    for (int w = 0; w < kThreads / 32; ++w)
      pthread_barrier_init(&warp_bar[w], nullptr, 32);
    for (int e = 0; e < kEnvsPerBlock; ++e)
      pthread_barrier_init(&env_bar[e], nullptr, 32 * kWarpsPerEnv);
    pthread_barrier_init(&block_bar, nullptr, kThreads);
    std::vector<std::thread> lanes;
    for (int t = 0; t < kThreads; ++t)
      lanes.emplace_back([=] {
        threadIdx = {unsigned(t), 0, 0};
        blockIdx = {unsigned(blk), 0, 0};
        pd_substep_kernel(qpos, qvel, cmd, damp, mass, ipos, misc, hfield,
                          qpos_out, qvel_out, qacc_out, diag_out, itab, ftab,
                          nitab, nftab, B);
      });
    for (auto& lane : lanes) lane.join();
    for (int w = 0; w < kThreads / 32; ++w)
      pthread_barrier_destroy(&warp_bar[w]);
    for (int e = 0; e < kEnvsPerBlock; ++e)
      pthread_barrier_destroy(&env_bar[e]);
    pthread_barrier_destroy(&block_bar);
  }
  return 0;
}
"""


def emulation_source(src: str) -> str:
    """The kernel of `src` (up to its host-side launch code) as C++ for
    the stub, with its shared memory and named barrier mapped onto the
    harness's."""
    cut = "// Shared memory of a block for tables"
    smem = "extern __shared__ float4 k1_smem[];"
    barrier = re.compile(r'asm volatile\("bar\.sync.*?\);', re.S)
    for what, ok in ((cut, cut in src), (smem, smem in src),
                     ("bar.sync", bool(barrier.search(src)))):
        assert ok, f"fleet_kernel.cu no longer has {what!r}: update the stub"
    kernel = src[:src.index(cut)]
    kernel = kernel.replace("#include <cuda_runtime.h>", STUB)
    kernel = kernel.replace(
        smem, "float4* k1_smem = reinterpret_cast<float4*>(k1_emulated_smem);")
    kernel = barrier.sub("k1_env_barrier(slot);", kernel)
    return kernel + HARNESS


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source as C++")
    work = tmp_path_factory.mktemp("k1_emulated")
    cpp = work / "fleet_kernel_emulated.cpp"
    cpp.write_text(emulation_source(
        (cuda_build.CSRC / "fleet_kernel.cu").read_text()))
    so = work / "fleet_kernel_emulated.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", "-pthread", str(cpp), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.k1_emulate.argtypes = (ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 3
    lib.k1_emulate.restype = ctypes.c_int

    def run(m, params, qpos, qvel, rows):
        B = qpos.shape[-1]
        ipos, misc, hf = fleet_kernel.static_rows(m, params)
        itab, ftab = fleet_kernel._k1_tables(m, torch.device("cpu"))
        outs = [torch.full((r, B), float("nan"))
                for r in (m.nq, m.nv, m.nv, fleet_kernel.DIAG_ROWS)]
        ins = (qpos, qvel, rows, params.dof_damping, params.body_mass,
               ipos, misc)
        assert lib.k1_emulate(
            *(x.contiguous().data_ptr() for x in ins),
            hf.data_ptr() if m.enable_hfield else None,
            *(o.data_ptr() for o in outs), itab.data_ptr(), ftab.data_ptr(),
            itab.numel(), ftab.numel(), B) == 0
        return outs
    return run


def _inputs(B, seed, terrain, standing):
    gen = torch.Generator()
    gen.manual_seed(seed)
    if standing:
        return k1_standing_inputs(B, gen, "cpu", terrain=terrain)
    return k1_inputs(B, gen, "cpu", terrain)


@pytest.mark.parametrize("hfield,standing", [(False, False), (False, True),
                                             (True, False), (True, True)])
def test_emulated_kernel_matches_plain(emulated, hfield, standing):
    """The kernel source against `pd_substep_plain` on a perturbed and a
    standing fleet of 64 envs, flat and on terrain (noise and steps
    tables, a quarter of the envs on the plane), each output elementwise
    within `kernel_bounds`, as the card tests hold the kernel: the bound
    takes each row's rounding spread over the fleet, which a handful of
    envs does not sample (5 envs standing: 1.9 x the bound)."""
    m = cassie_model(enable_hfield=hfield)
    params, qpos, qvel, rows = _inputs(64, 11 + standing, 0.06 * hfield,
                                       standing)
    got = emulated(m, params, qpos, qvel, rows)
    gen = torch.Generator()
    gen.manual_seed(0)
    ref, spread = fleet_kernel.plain_spread(m, params, qpos, qvel, rows, gen)
    for k, (a, r, bound) in enumerate(zip(
            got, ref, fleet_kernel.kernel_bounds(ref, spread))):
        assert torch.isfinite(a).all(), k
        assert ((a - r).abs() <= bound).all(), (
            k, float(((a - r).abs() / bound).max()))
    assert float(ref[3][0:2].abs().max()) > 0      # feet in contact


def test_emulated_kernel_is_deterministic_and_per_env(emulated):
    """Two runs give the same bits however the OS interleaves the lanes
    (a missing barrier between two phases would let a lane read a value
    before or after another lane wrote it), the plane envs of a
    heightfield launch give the flat launch's bits, and an env's outputs
    do not depend on the other envs of the launch."""
    m = cassie_model(enable_hfield=True)
    params, qpos, qvel, rows = _inputs(5, 3, 0.06, standing=False)
    first = emulated(m, params, qpos, qvel, rows)
    again = emulated(m, params, qpos, qvel, rows)
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    flat = emulated(cassie_model(), params, qpos, qvel, rows)
    plane = params.hfield_active == 0
    assert 0 < int(plane.sum()) < 5
    for a, b in zip(first, flat):
        assert torch.equal(a[:, plane], b[:, plane])
    cut = lambda x: x[..., 1:4].contiguous()
    part = emulated(m, type(params)(**{k: cut(v) for k, v in
                                       vars(params).items()}),
                    cut(qpos), cut(qvel), cut(rows))
    for a, b in zip(part, first):
        assert torch.equal(a, b[:, 1:4])
