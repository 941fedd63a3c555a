// Forward kinematics for a whole env fleet, one thread per env (K2).
//
// Replaces the Pallas TPU kernel `_fk_kernel` of apex_tpu/physics/fleet_fk.py
// (launched by `pallas_fk`). Same math in the same order as the batch-last
// XLA version `fleet._fk_bt`, whose PyTorch port `fleet_fk.fk_plain` is this
// kernel's plain version: per body the world position and rotation, the COM
// position from the per-env (dyn-rand) `body_ipos`, and per dof the world
// motion axis `cdof`, all origin-shifted by the root translation. Slide,
// hinge (Rodrigues) and ball (quaternion) joints.
//
// What bounds it: bytes. Per env it reads qpos (nq rows) and body_ipos
// (nb*3 rows) and writes xpos, xmat, xipos and cdof (nb*3 + nb*9 + nb*3 +
// nv*6 rows) -- for Cassie 677 floats, 2.8 MB at B=1024 -- against ~3 kFLOP
// per env. The design keeps the batch on the minor axis (row r of an
// (rows, B) array is at r*B + b), so the 32 threads of a warp, which hold
// 32 neighbouring envs, load and store 128 contiguous bytes per row. The
// tree walk is sequential per env; the parent's frame is read back from the
// rows this thread has just written (L1/L2 hits), so no per-model frame
// stack is needed and the kernel takes any tree.
//
// The model reaches the kernel as two small tables built by
// apex_tpu_torch/physics/fleet_fk.py (`_fk_tables`), not as generated code:
//   itab: per body  [parent, first joint, joint count, rot is identity]
//         per joint [type, qposadr, dofadr, 0]
//   ftab: per body  [pos(3), rot(9)]
//         per joint [axis(3), ref, K(9), K@K(9)]   K = skew(axis)
#include <cuda_runtime.h>

namespace {

constexpr int kSlide = 0;
constexpr int kHinge = 1;
constexpr int kBodyInts = 4;
constexpr int kJointInts = 4;
constexpr int kBodyFloats = 12;
constexpr int kJointFloats = 22;

__device__ __forceinline__ void mat_mul_c(const float R[3][3], const float* C,
                                          float out[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = R[i][0] * C[0 * 3 + j] + R[i][1] * C[1 * 3 + j] +
                  R[i][2] * C[2 * 3 + j];
}

__device__ __forceinline__ void store_cdof(float* cdof, int dof, int B, int b,
                                           const float ang[3],
                                           const float lin[3]) {
  float* row = cdof + (size_t)dof * 6 * B + b;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    row[(size_t)k * B] = ang[k];
    row[(size_t)(3 + k) * B] = lin[k];
  }
}

// lin = axis x (-pos), as fleet._fk_bt's _cross_bt(axis_w, -pos)
__device__ __forceinline__ void cross_neg(const float a[3], const float p[3],
                                          float out[3]) {
  out[0] = a[1] * (-p[2]) - a[2] * (-p[1]);
  out[1] = a[2] * (-p[0]) - a[0] * (-p[2]);
  out[2] = a[0] * (-p[1]) - a[1] * (-p[0]);
}

__global__ void fleet_fk_kernel(const float* __restrict__ qpos,
                                const float* __restrict__ ipos,
                                float* __restrict__ xpos,
                                float* __restrict__ xmat,
                                float* __restrict__ xipos,
                                float* __restrict__ cdof,
                                const int* __restrict__ itab,
                                const float* __restrict__ ftab, int nbody,
                                int root_origin, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int* jtab = itab + kBodyInts * nbody;
  const float* jftab = ftab + kBodyFloats * nbody;

  float origin[3] = {0.f, 0.f, 0.f};
  if (root_origin) {
#pragma unroll
    for (int k = 0; k < 3; ++k) origin[k] = qpos[(size_t)k * B + b];
  }

  for (int i = 0; i < nbody; ++i) {
    const int parent = itab[kBodyInts * i + 0];
    const int j0 = itab[kBodyInts * i + 1];
    const int nj = itab[kBodyInts * i + 2];
    const int rot_identity = itab[kBodyInts * i + 3];
    const float* bpos = ftab + kBodyFloats * i;
    const float* brot = bpos + 3;

    float p[3], R[3][3];
    if (parent < 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = bpos[k] - origin[k];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) R[a][c] = brot[3 * a + c];
    } else {
      float Rp[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        p[a] = xpos[(size_t)(parent * 3 + a) * B + b];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          Rp[a][c] = xmat[(size_t)(parent * 9 + 3 * a + c) * B + b];
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (bpos[k] != 0.f) {
#pragma unroll
          for (int a = 0; a < 3; ++a) p[a] = p[a] + Rp[a][k] * bpos[k];
        }
      }
      if (rot_identity) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) R[a][c] = Rp[a][c];
      } else {
        mat_mul_c(Rp, brot, R);
      }
    }

    for (int jj = j0; jj < j0 + nj; ++jj) {
      const int type = jtab[kJointInts * jj + 0];
      const int qadr = jtab[kJointInts * jj + 1];
      const int dadr = jtab[kJointInts * jj + 2];
      const float* jf = jftab + kJointFloats * jj;
      if (type == kSlide || type == kHinge) {
        float aw[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          aw[a] = R[a][0] * jf[0] + R[a][1] * jf[1] + R[a][2] * jf[2];
        const float t = qpos[(size_t)qadr * B + b] - jf[3];
        if (type == kSlide) {
#pragma unroll
          for (int a = 0; a < 3; ++a) p[a] = p[a] + aw[a] * t;
          const float zero[3] = {0.f, 0.f, 0.f};
          store_cdof(cdof, dadr, B, b, zero, aw);
        } else {
          float RK[3][3], RKK[3][3];
          mat_mul_c(R, jf + 4, RK);
          mat_mul_c(R, jf + 13, RKK);
          const float s = sinf(t);
          const float c1 = 1.f - cosf(t);
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int c = 0; c < 3; ++c)
              R[a][c] = R[a][c] + s * RK[a][c] + c1 * RKK[a][c];
          float lin[3];
          cross_neg(aw, p, lin);
          store_cdof(cdof, dadr, B, b, aw, lin);
        }
      } else {  // ball: unit quaternion (w, x, y, z), dofs in the child frame
        float q[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) q[k] = qpos[(size_t)(qadr + k) * B + b];
        const float nrm =
            sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
        const float w = q[0] / nrm, x = q[1] / nrm, y = q[2] / nrm,
                    z = q[3] / nrm;
        const float Rq[9] = {
            1.f - 2.f * (y * y + z * z), 2.f * (x * y - w * z),
            2.f * (x * z + w * y),       2.f * (x * y + w * z),
            1.f - 2.f * (x * x + z * z), 2.f * (y * z - w * x),
            2.f * (x * z - w * y),       2.f * (y * z + w * x),
            1.f - 2.f * (x * x + y * y)};
        float Rn[3][3];
        mat_mul_c(R, Rq, Rn);
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) R[a][c] = Rn[a][c];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float aw[3] = {R[0][k], R[1][k], R[2][k]};
          float lin[3];
          cross_neg(aw, p, lin);
          store_cdof(cdof, dadr + k, B, b, aw, lin);
        }
      }
    }

    const float* ip = ipos + (size_t)(i * 3) * B + b;
    const float ip0 = ip[0], ip1 = ip[(size_t)B], ip2 = ip[(size_t)2 * B];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      xpos[(size_t)(i * 3 + a) * B + b] = p[a];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        xmat[(size_t)(i * 9 + 3 * a + c) * B + b] = R[a][c];
      xipos[(size_t)(i * 3 + a) * B + b] =
          p[a] + (R[a][0] * ip0 + R[a][1] * ip1 + R[a][2] * ip2);
    }
  }
}

}  // namespace

// Launches K2 on `stream`; returns cudaGetLastError() as an int (0 = ok).
extern "C" int apex_fleet_fk(const float* qpos, const float* ipos, float* xpos,
                             float* xmat, float* xipos, float* cdof,
                             const int* itab, const float* ftab, int nbody,
                             int root_origin, int B, void* stream) {
  constexpr int kThreads = 64;
  const int blocks = (B + kThreads - 1) / kThreads;
  fleet_fk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      qpos, ipos, xpos, xmat, xipos, cdof, itab, ftab, nbody, root_origin, B);
  return static_cast<int>(cudaGetLastError());
}
