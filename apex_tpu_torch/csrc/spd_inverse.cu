// Batched inverse of small SPD matrices, batch-last (K3).
//
// Replaces the Pallas TPU kernel `_spd_inverse_kernel` of
// apex_tpu/ops/pallas_linalg.py (launched by `pallas_spd_inverse_bt`), which
// inverts the damped mass matrix M + hD of every env once per physics
// substep (apex_tpu/physics/fleet.py, `_spd_inverse_bt`). Same algorithm:
// right-looking Cholesky with the pivot floored at 1e-12, then the rows of
// Y = L^-1 produced one by one and accumulated into A^-1 = sum_i y_i y_i^T.
// Its plain version is `ops.linalg.spd_inverse` (unrolled Cholesky and
// triangular solves), reached through `ops.pallas_linalg.spd_inverse_bt`.
//
// What bounds it: bytes. Each (n, n) f32 matrix is read once and its inverse
// written once (8 KB per env at n = 32, 8 MB at B = 1024) against ~n^3 =
// 33 kFLOP per matrix. The input is batch-last, (n, n, B) with entry (i, j)
// of matrix b at (i * n + j) * B + b, so a warp that owned one matrix would
// read 4-byte words B floats apart. Instead a block of kMats warps owns kMats
// neighbouring matrices: the block loads and stores them cooperatively, the
// kMats envs of each entry being contiguous (32-byte sectors), and stages
// them in shared memory. Then each warp factors and inverts its own matrix
// with lane = column index: the Schur complement S (and later the columns of
// L) and the residual R of the forward solve live in shared memory, the
// columns of the accumulated inverse in registers. n <= 32.
#include <cuda_runtime.h>

namespace {

constexpr int kMats = 8;                  // matrices (= warps) per block
constexpr int kMax = 32;                  // largest n
constexpr int kLd = kMax + 1;             // padded row stride in shared memory
constexpr int kMatStride = kMax * kLd + 1;  // S, then R, per matrix
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kMats * 32)
    spd_inverse_kernel(const float* __restrict__ A, float* __restrict__ out,
                       int n, int B) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kMats;
  const int nn = n * n;

  // cooperative load; envs past B are padded with the identity
  for (int t = threadIdx.x; t < nn * kMats; t += blockDim.x) {
    const int m = t % kMats, e = t / kMats;
    const int i = e / n, j = e % n;
    const int b = b0 + m;
    const float v = b < B ? A[(size_t)e * B + b] : (i == j ? 1.f : 0.f);
    smem[m * 2 * kMatStride + i * kLd + j] = v;
  }
  __syncthreads();

  float* S = smem + warp * 2 * kMatStride;
  float* R = S + kMatStride;
  const bool col_ok = lane < n;

  // right-looking Cholesky; row j of S is replaced by column j of L
  float dinv = 0.f;  // lane j keeps 1 / L[j][j]
  for (int j = 0; j < n; ++j) {
    const float d = 1.f / sqrtf(fmaxf(S[j * kLd + j], 1e-12f));
    const float col = (col_ok && lane >= j) ? S[j * kLd + lane] * d : 0.f;
    __syncwarp();
    if (col_ok) S[j * kLd + lane] = col;
    if (lane == j) dinv = d;
    for (int a = j + 1; a < n; ++a) {
      const float ca = __shfl_sync(kFull, col, a);
      if (col_ok) S[a * kLd + lane] -= ca * col;
    }
    __syncwarp();
  }

  // forward solve Y = L^-1 row by row (R starts as I), fused with
  // A^-1 = sum_i y_i y_i^T; lane m accumulates column m of A^-1
  for (int a = 0; a < n; ++a)
    if (col_ok) R[a * kLd + lane] = (a == lane) ? 1.f : 0.f;
  __syncwarp();
  float acc[kMax];
#pragma unroll
  for (int a = 0; a < kMax; ++a) acc[a] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float di = __shfl_sync(kFull, dinv, i);
    const float y = col_ok ? R[i * kLd + lane] * di : 0.f;
    for (int a = i + 1; a < n; ++a) {
      const float la = S[i * kLd + a];  // L[a][i]
      if (col_ok) R[a * kLd + lane] -= la * y;
    }
#pragma unroll
    for (int a = 0; a < kMax; ++a) acc[a] += __shfl_sync(kFull, y, a) * y;
    __syncwarp();
  }

  // stage the inverse through R, then store cooperatively
#pragma unroll
  for (int a = 0; a < kMax; ++a)
    if (a < n && col_ok) R[a * kLd + lane] = acc[a];
  __syncthreads();
  for (int t = threadIdx.x; t < nn * kMats; t += blockDim.x) {
    const int m = t % kMats, e = t / kMats;
    const int b = b0 + m;
    if (b < B)
      out[(size_t)e * B + b] =
          smem[m * 2 * kMatStride + kMatStride + (e / n) * kLd + e % n];
  }
}

}  // namespace

// Launches K3 on `stream`; returns cudaGetLastError() as an int (0 = ok).
extern "C" int apex_spd_inverse(const float* A, float* out, int n, int B,
                                void* stream) {
  if (n < 1 || n > kMax) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kMats * 2 * kMatStride * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      spd_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kMats - 1) / kMats;
  spd_inverse_kernel<<<blocks, kMats * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(A, out, n, B);
  return static_cast<int>(cudaGetLastError());
}
