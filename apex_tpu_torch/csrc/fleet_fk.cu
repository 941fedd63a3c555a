// Forward kinematics for a whole env fleet, one warp per env (K2).
//
// Replaces the Pallas TPU kernel `_fk_kernel` of apex_tpu/physics/fleet_fk.py
// (launched by `pallas_fk`). Same math in the same order as the batch-last
// XLA version `fleet._fk_bt`, whose PyTorch port `fleet_fk.fk_plain` is this
// kernel's plain version: per body the world position and rotation, the COM
// position from the per-env (dyn-rand) `body_ipos`, and per dof the world
// motion axis `cdof`, all origin-shifted by the root translation. Slide,
// hinge (Rodrigues) and ball (quaternion) joints.
//
// What bounds it: bytes, by the roofline. Per env it reads qpos (nq rows)
// and body_ipos (nb*3 rows) and writes xpos, xmat, xipos and cdof (nb*3 +
// nb*9 + nb*3 + nv*6 rows) -- for Cassie 677 floats, 2.8 MB at B = 1024 --
// against ~3 kFLOP per env. In practice the tree walk's chain of dependent
// steps bounds it: a body waits on its parent's frame.
//
// The design:
//   - A block of kEnvs warps owns kEnvs neighbouring envs. It loads their
//     qpos and body_ipos rows, and stores their outputs, cooperatively: the
//     kEnvs envs of a row are one 32-byte sector, and each thread keeps
//     kBatch loads in flight. The four outputs are the rows of one buffer.
//     Inputs, outputs and per-joint scratch of each env are staged in
//     shared memory, and so are the model tables, so the walk reads
//     nothing from device memory.
//   - Each env's warp first computes, one joint per lane, each hinge's
//     sinf and 1 - cosf of its angle and each ball's rotation from its
//     normalised quaternion.
//   - Then it walks the tree by depth, in rounds of at most 10 bodies whose
//     parents are done: three lanes per body, lane a owning row a of the
//     body's rotation and entry a of its position. Row a of a child's
//     frame, and of each joint's update, needs only row a of the parent's,
//     so the rows never exchange values. A body's joints stay in order on
//     its three lanes. The parent's frame is read from the staged outputs.
//   - Last, one lane per hinge or ball dof forms the linear part of cdof,
//     axis x (-pos), from the staged axis and the position at that joint.
// Every output value is computed by one lane with the expressions, and the
// order of operations and FMA contractions, of the one-thread-per-env
// kernel this design replaced (its SASS, read back with cuobjdump): so the
// products and sums are written out with __fmaf_rn / __fmul_rn, and the
// outputs are bit for bit those of that kernel.
//
// The model reaches the kernel as two tables built by
// apex_tpu_torch/physics/fleet_fk.py (`_fk_tables`), not as generated code,
// with the records 16-byte aligned for vector loads:
//   itab: header [nbody, njoint, nround, ncross, nq, nv, root_origin,
//                 stride (floats of shared memory per env)]
//         round offsets (nround + 1) into the slots, padded to 4
//         per slot (bodies in walk order)
//                   [body, parent, first joint, joint count | rot is
//                    identity << 8]
//         per joint [type, qposadr, dofadr, 0]   (bodies' joints in order)
//         per cross item [dof, joint]
//   ftab: per slot  [pos(3), rot(9)]
//         per joint [axis(3), ref, K(9), K@K(9), 0, 0]   K = skew(axis)
#include <cuda_runtime.h>

namespace {

constexpr int kEnvs = 8;           // envs (= warps) per block
constexpr int kThreads = kEnvs * 32;
constexpr int kBatch = 8;          // loads in flight per thread
constexpr int kRowStep = kThreads / kEnvs;  // rows apart of a thread's
                                             // loads and stores
constexpr int kHeader = 8;
constexpr int kBodiesPerRound = 10;  // three lanes each
constexpr int kJointScratch = 12;    // sin, 1 - cos or R(q); pos at joint
constexpr int kSlide = 0;
constexpr int kHinge = 1;

// x0*y0 + x1*y1 + x2*y2, contracted as the one-thread kernel's SASS has it
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0,
                                      float y1, float y2) {
  return __fmaf_rn(x2, y2, __fmaf_rn(x0, y0, __fmul_rn(x1, y1)));
}

// lin = axis x (-pos), as fleet._fk_bt's _cross_bt(axis_w, -pos)
__device__ __forceinline__ void cross_neg(const float* a, const float* p,
                                          float* out) {
  out[0] = __fmaf_rn(a[2], p[1], -__fmul_rn(a[1], p[2]));
  out[1] = __fmaf_rn(a[0], p[2], -__fmul_rn(a[2], p[0]));
  out[2] = __fmaf_rn(a[1], p[0], -__fmul_rn(a[0], p[1]));
}

// rotation of the unit quaternion q / |q| (w, x, y, z), row-major
__device__ __forceinline__ void ball_rotation(const float* q, float* Rq) {
  const float nrm = sqrtf(__fmaf_rn(
      q[3], q[3], __fmaf_rn(q[2], q[2], __fmaf_rn(q[0], q[0],
                                                  __fmul_rn(q[1], q[1])))));
  const float w = q[0] / nrm, x = q[1] / nrm, y = q[2] / nrm, z = q[3] / nrm;
  const float yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float xz = __fmul_rn(x, z), wx = __fmul_rn(w, x),
              wz = __fmul_rn(w, z);
  Rq[0] = 1.f - __fmul_rn(2.f, yy + zz);
  Rq[1] = __fmul_rn(2.f, __fmaf_rn(x, y, -wz));
  Rq[2] = __fmul_rn(2.f, __fmaf_rn(w, y, xz));
  Rq[3] = __fmul_rn(2.f, __fmaf_rn(x, y, wz));
  Rq[4] = 1.f - __fmul_rn(2.f, __fmaf_rn(x, x, zz));
  Rq[5] = __fmul_rn(2.f, __fmaf_rn(y, z, -wx));
  Rq[6] = __fmul_rn(2.f, __fmaf_rn(-w, y, xz));
  Rq[7] = __fmul_rn(2.f, __fmaf_rn(y, z, wx));
  Rq[8] = 1.f - __fmul_rn(2.f, __fmaf_rn(x, x, yy));
}

// A lane's record for a round of the walk: the slot's [body, parent, first
// joint, joint count | rot is identity << 8] and its body's pos and rot;
// `live` false past the round's bodies (then slot 0's, unused)
struct Slot {
  int4 rec;
  float4 f[3];
  int at;
  bool live;
};

__device__ __forceinline__ Slot fetch_slot(const int* round_at,
                                           const int4* rec,
                                           const float4* bflt, int rd,
                                           int item) {
  Slot s;
  s.at = round_at[rd] + item;
  s.live = item < kBodiesPerRound && s.at < round_at[rd + 1];
  if (!s.live) s.at = 0;
  s.rec = rec[s.at];
#pragma unroll
  for (int k = 0; k < 3; ++k) s.f[k] = bflt[3 * s.at + k];
  return s;
}

// v, opaque to the compiler: a value derived from the thread index stays in
// its register through the walk instead of being recomputed every round
__device__ __forceinline__ int kept(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

int smem_bytes(int nitab, int nftab, int stride) {
  return static_cast<int>(sizeof(float)) *
         (((nitab + 3) & ~3) + ((nftab + 3) & ~3) + kEnvs * stride);
}

__global__ void __launch_bounds__(kThreads)
    fleet_fk_kernel(const float* __restrict__ qpos,
                    const float* __restrict__ ipos, float* __restrict__ out,
                    const int* __restrict__ itab,
                    const float* __restrict__ ftab, int nitab, int nftab,
                    int B) {
  extern __shared__ float4 k2_smem[];
  unsigned* words = reinterpret_cast<unsigned*>(k2_smem);
  const int* sint = reinterpret_cast<const int*>(words);
  float* sflt = reinterpret_cast<float*>(words + ((nitab + 3) & ~3));
  float* stage = sflt + ((nftab + 3) & ~3);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b0 = blockIdx.x * kEnvs;

  const int nbody = itab[0], njoint = itab[1], nround = itab[2],
            ncross = itab[3], nq = itab[4], nv = itab[5],
            root_origin = itab[6], stride = itab[7];
  // staged rows of an env: outputs, then inputs, then per-joint scratch
  const int o_xmat = 3 * nbody, o_xipos = 12 * nbody, o_cdof = 15 * nbody;
  const int n_out = o_cdof + 6 * nv;
  const int o_qpos = n_out, o_ipos = n_out + nq;
  const int n_in = nq + 3 * nbody;
  const int o_scr = (n_out + n_in + 3) & ~3;

  // ---- loads: the tables, and the block's input rows with thread t on
  // env t % kEnvs and rows t / kEnvs + kRowStep u; kBatch loads of each in
  // flight per thread before its shared stores
  const int n_tab = nitab + nftab, f0 = (nitab + 3) & ~3;
  const int m = threadIdx.x % kEnvs, r0 = threadIdx.x / kEnvs, b = b0 + m;
  for (int it = 0;
       it * kThreads * kBatch < n_tab || it * kRowStep * kBatch < n_in;
       ++it) {
    unsigned tv[kBatch];
    float iv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = threadIdx.x + (it * kBatch + u) * kThreads;
      tv[u] = t < nitab  ? static_cast<unsigned>(__ldg(itab + t))
              : t < n_tab ? __float_as_uint(__ldg(ftab + (t - nitab)))
                          : 0u;
      const int r = r0 + (it * kBatch + u) * kRowStep;
      iv[u] = r >= n_in || b >= B ? 0.f
              : r < nq            ? __ldg(qpos + (size_t)r * B + b)
                                  : __ldg(ipos + (size_t)(r - nq) * B + b);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = threadIdx.x + (it * kBatch + u) * kThreads;
      if (t < n_tab) words[t < nitab ? t : f0 + (t - nitab)] = tv[u];
      const int r = r0 + (it * kBatch + u) * kRowStep;
      if (r < n_in) stage[m * stride + o_qpos + r] = iv[u];
    }
  }
  __syncthreads();

  const int* round_at = sint + kHeader;
  const int4* rec = reinterpret_cast<const int4*>(round_at +
                                                  ((nround + 4) & ~3));
  const int4* joint = rec + nbody;
  const int* cross = reinterpret_cast<const int*>(joint + njoint);
  const float4* bflt = reinterpret_cast<const float4*>(sflt);
  const float4* jflt = bflt + 3 * nbody;
  float* env = stage + kept(warp * stride);
  const float* q = env + o_qpos;
  float* scr = env + o_scr;

  if (b0 + warp < B) {  // warps past B have no env
    // ---- joints: one lane each, sin and 1 - cos of a hinge's angle, the
    // rotation of a ball's normalised quaternion
    for (int j = lane; j < njoint; j += 32) {
      const int4 ji = joint[j];
      float* s = scr + kJointScratch * j;
      if (ji.x == kHinge) {
        const float t = q[ji.y] - jflt[6 * j].w;
        s[0] = sinf(t);
        s[1] = 1.f - cosf(t);
      } else if (ji.x != kSlide) {
        ball_rotation(q + ji.y, s);
      }
    }
    __syncwarp();

    // ---- walk: round by round, row a of each body on its own lane; the
    // lane's next record is fetched while it works on the current one
    const int item = kept(lane / 3), a = kept(lane % 3);
    Slot cur = fetch_slot(round_at, rec, bflt, 0, item);
    for (int rd = 0; rd < nround; ++rd) {
      const Slot nxt = fetch_slot(round_at, rec, bflt, min(rd + 1, nround - 1),
                                  item);
      if (cur.live) {
        const int i = cur.rec.x, parent = cur.rec.y, j0 = cur.rec.z;
        const int nj = cur.rec.w & 0xff;
        const float bpos[3] = {cur.f[0].x, cur.f[0].y, cur.f[0].z};
        const float brot[9] = {cur.f[0].w, cur.f[1].x, cur.f[1].y,
                               cur.f[1].z, cur.f[1].w, cur.f[2].x,
                               cur.f[2].y, cur.f[2].z, cur.f[2].w};
        const float* ip = q + (o_ipos - o_qpos) + 3 * i;
        const float ip0 = ip[0], ip1 = ip[1], ip2 = ip[2];
        float p, R[3];
        if (parent < 0) {
          const float* bf = reinterpret_cast<const float*>(bflt + 3 * cur.at);
          p = bf[a] - (root_origin ? q[a] : 0.f);
#pragma unroll
          for (int c = 0; c < 3; ++c) R[c] = bf[3 + 3 * a + c];
        } else {
          p = env[3 * parent + a];
          const float* rp = env + o_xmat + 9 * parent + 3 * a;
          const float P[3] = {rp[0], rp[1], rp[2]};
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (bpos[k] != 0.f) p = __fmaf_rn(P[k], bpos[k], p);
          if (cur.rec.w >> 8) {
#pragma unroll
            for (int c = 0; c < 3; ++c) R[c] = P[c];
          } else {
#pragma unroll
            for (int c = 0; c < 3; ++c)
              R[c] = dot3(P[0], P[1], P[2], brot[c], brot[3 + c], brot[6 + c]);
          }
        }

        for (int jj = j0; jj < j0 + nj; ++jj) {
          // every operand of the joint, loaded before its type is known
          const int4 ji = joint[jj];
          float jf[24], sv[9];  // table; sin, 1 - cos or R(q)
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            const float4 f = jflt[6 * jj + k];
            jf[4 * k] = f.x, jf[4 * k + 1] = f.y, jf[4 * k + 2] = f.z,
            jf[4 * k + 3] = f.w;
          }
          float* s = scr + kJointScratch * jj;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float4 f = reinterpret_cast<const float4*>(s)[k];
            sv[4 * k] = f.x, sv[4 * k + 1] = f.y, sv[4 * k + 2] = f.z,
            sv[4 * k + 3] = f.w;
          }
          sv[8] = s[8];
          const float qv = q[ji.y];
          float* cd = env + o_cdof + 6 * ji.z;
          if (ji.x == kSlide) {
            const float aw = dot3(R[0], R[1], R[2], jf[0], jf[1], jf[2]);
            p = __fmaf_rn(aw, qv - jf[3], p);
            cd[a] = 0.f;
            cd[3 + a] = aw;
          } else if (ji.x == kHinge) {
            const float aw = dot3(R[0], R[1], R[2], jf[0], jf[1], jf[2]);
            const float* K = jf + 4;
            const float* KK = jf + 13;
            float Rn[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float rk = dot3(R[0], R[1], R[2], K[c], K[3 + c], K[6 + c]);
              const float rkk = dot3(R[0], R[1], R[2], KK[c], KK[3 + c],
                                     KK[6 + c]);
              Rn[c] = __fmaf_rn(sv[1], rkk, __fmaf_rn(sv[0], rk, R[c]));
            }
#pragma unroll
            for (int c = 0; c < 3; ++c) R[c] = Rn[c];
            cd[a] = aw;
            s[9 + a] = p;
          } else {  // ball: R <- R @ R(q); dofs along the new columns
            float Rn[3];
#pragma unroll
            for (int c = 0; c < 3; ++c)
              Rn[c] = dot3(R[0], R[1], R[2], sv[c], sv[3 + c], sv[6 + c]);
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              R[c] = Rn[c];
              cd[6 * c + a] = Rn[c];
            }
            s[9 + a] = p;
          }
        }

        env[3 * i + a] = p;
#pragma unroll
        for (int c = 0; c < 3; ++c) env[o_xmat + 9 * i + 3 * a + c] = R[c];
        env[o_xipos + 3 * i + a] = dot3(R[0], R[1], R[2], ip0, ip1, ip2) + p;
      }
      __syncwarp();
      cur = nxt;
    }

    // ---- cross: the linear part of each hinge and ball dof, from its axis
    // and the position at its joint
    for (int k = lane; k < ncross; k += 32) {
      float* cd = env + o_cdof + 6 * cross[2 * k];
      cross_neg(cd, scr + kJointScratch * cross[2 * k + 1] + 9, cd + 3);
    }
  }
  __syncthreads();

  // ---- stores: the staged outputs, rows of `out`; thread t on env
  // t % kEnvs and rows t / kEnvs + kRowStep u, kBatch shared loads before
  // its global stores
  for (int rb = r0; rb < n_out; rb += kRowStep * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      v[u] = stage[m * stride + min(rb + kRowStep * u, n_out - 1)];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (rb + kRowStep * u < n_out && b < B)
        out[(size_t)(rb + kRowStep * u) * B + b] = v[u];
  }
}

}  // namespace

// Launches K2 on `stream`: `out` is one (15 nbody + 6 nv, B) buffer whose
// rows are xpos, xmat, xipos and cdof; `stride` is the header's floats of
// shared memory per env. Returns cudaGetLastError() as an int (0 = ok).
extern "C" int apex_fleet_fk(const float* qpos, const float* ipos, float* out,
                             const int* itab, const float* ftab, int nitab,
                             int nftab, int stride, int B, void* stream) {
  const int smem = smem_bytes(nitab, nftab, stride);
  cudaError_t err = cudaFuncSetAttribute(
      fleet_fk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kEnvs - 1) / kEnvs;
  fleet_fk_kernel<<<blocks, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      qpos, ipos, out, itab, ftab, nitab, nftab, B);
  return static_cast<int>(cudaGetLastError());
}

// Launch shape for tables of these sizes on the current card: out[0..3] =
// shared memory per block, envs per block, blocks and envs resident per SM.
extern "C" int apex_fleet_fk_info(int nitab, int nftab, int stride,
                                  int* out) {
  out[0] = smem_bytes(nitab, nftab, stride);
  out[1] = kEnvs;
  cudaError_t err = cudaFuncSetAttribute(
      fleet_fk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, out[0]);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], fleet_fk_kernel, kThreads, out[0]);
  out[3] = out[2] * kEnvs;
  return static_cast<int>(err);
}
