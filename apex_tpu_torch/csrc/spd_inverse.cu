// Batched inverse of small SPD matrices, batch-last (K3) and batch-first
// (K3-bf).
//
// Replaces the Pallas TPU kernel `_spd_inverse_kernel` of
// apex_tpu/ops/pallas_linalg.py (launched by `pallas_spd_inverse_bt`), which
// inverts the damped mass matrix M + hD of every env once per physics
// substep (apex_tpu/physics/fleet.py, `_spd_inverse_bt`). Same algorithm:
// right-looking Cholesky with the squared pivot floored at 1e-12, then the
// rows of Y = L^-1 by forward substitution and A^-1 = sum_i y_i y_i^T. Its
// plain version is `ops.linalg.spd_inverse` (unrolled Cholesky and
// triangular solves), reached through `ops.pallas_linalg.spd_inverse_bt`.
//
// What bounds it: bytes, by the roofline: each (n, n) f32 matrix is read
// once and its inverse written once (8 KB per env at n = 32, 8 MB at
// B = 1024) against ~n^3 = 33 kFLOP per matrix. In practice the chain of
// dependent steps bounds it: the factorisation is n steps, each waiting on
// the pivot of the one before.
//
// The design: the input is batch-last, (n, n, B) with entry (i, j) of
// matrix b at (i * n + j) * B + b, so a block of kMats warps owns kMats
// neighbouring matrices, loads and stores them cooperatively (the kMats
// envs of an entry are one 32-byte sector) and stages them in shared
// memory, padded with the identity to a compile-time width W (8, 16 or 32,
// the next at or above n; envs past B are identity too). The batch-first
// route (K3-bf, replacing `pallas_spd_inverse`, which the per-env engine
// reaches through `ops/linalg.py`'s custom vmap rule) reads and writes
// (B, n, n), entry (i, j) of matrix b at (b * n + i) * n + j, through the
// same staging: only the global addresses differ, so its output is the
// batch-last kernel's bit for bit, and the JAX route's two transposes
// around the kernel are not needed. Then each warp
// inverts its matrix with lane c holding column c in W registers, every
// loop unrolled at W:
//   - Cholesky step j: the pivot comes from lane j by one shuffle (lane j
//     formed it from its own entries as soon as step j - 1 gave it L[j][j
//     - 1]); each lane scales its entry of row j (= column j, by symmetry)
//     into L[c][j] and writes it to shared memory; the entry the next step
//     depends on, L[j + 1][j], comes by shuffle, and after one __syncwarp
//     every lane reads the rest of the column back as float4 broadcasts and
//     updates its own column of the Schur complement with independent
//     FMAs.
//   - Forward solve: lane m solves L y = e_m against the stored columns of
//     L, in registers, then writes its column of Y to shared memory.
//   - Accumulation: after one __syncwarp, lane m forms column m of
//     A^-1 = Y^T Y from the rows of Y (float4 broadcasts; Y is lower
//     triangular, so row i stops at column i).
// So the chain is W steps of a shuffle, a reciprocal square root, a
// multiply and an FMA, against ~n^2 dependent shared-memory steps in a
// warp that kept the Schur complement in shared memory; each thread keeps
// all its global loads in flight at once. n <= 32.
#include <cuda_runtime.h>

namespace {

constexpr int kMats = 8;           // matrices (= warps) per block
constexpr unsigned kFull = 0xffffffffu;

// floats of shared memory per warp at width W: two W x W regions (the
// staged input, then Y; the columns of L, then the staged output), padded
// by 4 so that the kMats warps' regions start on different banks
template <int W>
__host__ __device__ constexpr int warp_floats() { return 2 * W * W + 4; }

// v[a] = row[a] for a in [lo, W): float4 broadcast loads from shared memory
template <int W>
__device__ __forceinline__ void load_row(const float* row, int lo,
                                         float v[W]) {
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    if (4 * q + 3 < lo) continue;
    const float4 f = reinterpret_cast<const float4*>(row)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

// global index of entry (i, j) of matrix b: batch-last (n, n, B) or
// batch-first (B, n, n)
template <bool kBatchFirst>
__device__ __forceinline__ size_t entry(int b, int i, int j, int n, int B) {
  return kBatchFirst ? ((size_t)b * n + i) * n + j : (size_t)(i * n + j) * B + b;
}

template <int W, bool kBatchFirst>
__global__ void __launch_bounds__(kMats * 32)
    spd_inverse_kernel(const float* __restrict__ A, float* __restrict__ out,
                       int n, int B) {
  extern __shared__ float4 k3_smem[];
  float* smem = reinterpret_cast<float*>(k3_smem);
  constexpr int kWarpFloats = warp_floats<W>();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kMats;

  // ---- loads: cooperative, padded with the identity past n and past B.
  // Thread t owns matrix m = t % kMats and staged entries e0 + 32 k (rows
  // i0 + (32 / W) k of column j0), and starts all its loads before its
  // first shared store
  constexpr int kPer = W * W / 32;  // entries per thread
  const int m = threadIdx.x % kMats, e0 = threadIdx.x / kMats;
  const int i0 = e0 / W, j0 = e0 % W, b = b0 + m;
  const bool in_b = b < B && j0 < n;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = i0 + (32 / W) * k;
    v[k] = (in_b && i < n) ? A[entry<kBatchFirst>(b, i, j0, n, B)]
                           : (i == j0 ? 1.f : 0.f);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) smem[m * kWarpFloats + e0 + 32 * k] = v[k];
  __syncthreads();

  if (b0 + warp < B) {  // warps past B have nothing to invert
    float* X = smem + warp * kWarpFloats;  // input, then the rows of Y
    float* L = X + W * W;                  // columns of L, then the output
    const bool live = lane < W;
    float x[W];
#pragma unroll
    for (int r = 0; r < W; ++r) x[r] = live ? X[r * W + lane] : 0.f;

    // ---- cholesky, right-looking: lane c keeps column c of the Schur
    // complement; row j of L^T (= column j of L) goes to L[j * W + c]. The
    // pivot comes by shuffle from lane j, which formed it from its own
    // entries (so one shuffle per step on the pivots' chain); the next
    // column's entry comes by shuffle too, the rest of the column by float4
    // broadcasts from shared memory
    float dinv[W];
    float dnext = x[0];  // lane j + 1: its diagonal entry after step j
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float piv = __shfl_sync(kFull, dnext, j);
      const float d = rsqrtf(fmaxf(piv, 1e-12f));
      dinv[j] = d;
      const float col = x[j] * d;  // L[c][j] for c >= j
      if (live) L[j * W + lane] = col;
      if (j + 1 < W) {
        dnext = fmaf(-col, col, x[j + 1]);
        x[j + 1] = fmaf(-__shfl_sync(kFull, col, j + 1), col, x[j + 1]);
      }
      __syncwarp();
      float lj[W];
      load_row<W>(L + j * W, j + 2, lj);
#pragma unroll
      for (int a = j + 2; a < W; ++a) x[a] = fmaf(-lj[a], col, x[a]);
    }

    // ---- solve: lane c holds column c of Y = L^-1 (r starts as e_c), in
    // registers; its rows go to shared memory afterwards
    float r[W];
#pragma unroll
    for (int a = 0; a < W; ++a) r[a] = (a == lane) ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      r[i] *= dinv[i];
      float li[W];
      load_row<W>(L + i * W, i + 1, li);
#pragma unroll
      for (int a = i + 1; a < W; ++a) r[a] = fmaf(-li[a], r[i], r[a]);
    }
#pragma unroll
    for (int i = 0; i < W; ++i)
      if (live) X[i * W + lane] = r[i];
    __syncwarp();

    // ---- accumulate A^-1 = Y^T Y: lane c forms column c; row i of Y is
    // zero past column i
    float acc[W];
#pragma unroll
    for (int a = 0; a < W; ++a) acc[a] = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      float yi[W];
      load_row<W>(X + i * W, 0, yi);
#pragma unroll
      for (int a = 0; a <= i; ++a) acc[a] = fmaf(yi[a], r[i], acc[a]);
    }

    // ---- stores: the inverse staged (row a, column c) over L, then stored
    // cooperatively, each thread's shared loads started before its global
    // stores
#pragma unroll
    for (int a = 0; a < W; ++a)
      if (live) L[a * W + lane] = acc[a];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    v[k] = smem[m * kWarpFloats + W * W + e0 + 32 * k];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = i0 + (32 / W) * k;
    if (in_b && i < n) out[entry<kBatchFirst>(b, i, j0, n, B)] = v[k];
  }
}

}  // namespace

template <int W, bool kBatchFirst>
static int launch(const float* A, float* out, int n, int B,
                  cudaStream_t stream) {
  const int smem = kMats * warp_floats<W>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      spd_inverse_kernel<W, kBatchFirst>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kMats - 1) / kMats;
  spd_inverse_kernel<W, kBatchFirst>
      <<<blocks, kMats * 32, smem, stream>>>(A, out, n, B);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBatchFirst>
static int launch_any(const float* A, float* out, int n, int B,
                      void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 32) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 8) return launch<8, kBatchFirst>(A, out, n, B, s);
  if (n <= 16) return launch<16, kBatchFirst>(A, out, n, B, s);
  return launch<32, kBatchFirst>(A, out, n, B, s);
}

// Launches K3 on `stream` at the smallest width of 8, 16 and 32 that holds
// n; A and out are (n, n, B); returns cudaGetLastError() as an int (0 = ok).
extern "C" int apex_spd_inverse(const float* A, float* out, int n, int B,
                                void* stream) {
  return launch_any<false>(A, out, n, B, stream);
}

// The same for batch-first A and out, (B, n, n) (K3-bf).
extern "C" int apex_spd_inverse_bf(const float* A, float* out, int n, int B,
                                   void* stream) {
  return launch_any<true>(A, out, n, B, stream);
}

// Launch shape of the kernel for n on the current card: out[0..3] = shared
// memory per block, matrices per block, blocks and matrices resident per
// SM; out[4] = the width W it runs at.
extern "C" int apex_spd_inverse_info(int n, int* out) {
  if (n < 1 || n > 32) return static_cast<int>(cudaErrorInvalidValue);
  const int W = n <= 8 ? 8 : n <= 16 ? 16 : 32;
  const void* fn = W == 8    ? (const void*)spd_inverse_kernel<8, false>
                   : W == 16 ? (const void*)spd_inverse_kernel<16, false>
                             : (const void*)spd_inverse_kernel<32, false>;
  out[0] = kMats * (2 * W * W + 4) * static_cast<int>(sizeof(float));
  out[1] = kMats;
  out[4] = W;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, out[0]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fn,
                                                        kMats * 32, out[0]);
  out[3] = out[2] * kMats;
  return static_cast<int>(err);
}
