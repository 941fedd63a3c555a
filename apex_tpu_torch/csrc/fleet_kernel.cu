// One whole PD substep of the env fleet, one thread per env (K1).
//
// Replaces the Pallas TPU kernel of apex_tpu/physics/fleet_kernel.py (body
// generated by `_gen_kernel`, launched by `pallas_pd_substep` through
// `_invoke`). That kernel is straight-line code generated per model, about
// 70k equations for Cassie. This source is fixed: the model reaches it as
// two tables built once per model by apex_tpu_torch/physics/fleet_kernel.py
// (`_k1_tables`, layout below), and the kernel loops over them, in the phase
// order and the formula order of the generator and of the plain version
// `pd_substep_plain`:
//   PD law and actuator clamp; FK (as K2); body velocities and cdof_dot;
//   spatial inertias; RNEA bias; CRBA at the ancestor pairs of M (307 for
//   Cassie); the fill-in-free LTDL of M + hD (in place, pivot floor 1e-12)
//   and its solves restricted to ancestor supports; plane/tilt penalty
//   contacts through each contact body's 6x6 inverse inertia; joint
//   limits; springs; the root wrench; the free-acceleration solve; the
//   connect impulses (dense ne x ne Cholesky, pivot floor 1e-4);
//   integration; the 44 diagnostic rows.
//
// Heightfield terrain (header flag HFIELD, the model's enable_hfield): misc
// has two more rows (hfield_radius, hfield_active) and each env brings its
// own 32 x 32 terrain table as (1024, B) rows, row ix * 32 + iy. An env with
// hfield_active > 0.5 takes each contact's depth and normal from the table
// instead of the plane. The TPU kernel contracts the table with tent
// weights because Mosaic cannot gather per lane; here the thread reads the
// four corners of its cell and combines them in the contraction's order
// (x first, then y), which gives the contraction's values: its other terms
// are exact zeros. Flat models and inactive envs run the plane code as
// before. Of the env's 4 KB table column, each contact reads the 4 floats
// of its cell's corners and nothing else.
//
// What bounds it. Bytes: (263 input + 143 output) rows x 4 B per env, 1.66
// MB at B = 1024, 0.5 us at 3.35 TB/s (with a terrain table 1,289 input
// rows, 5.87 MB, 1.75 us). Operations: about 1e5 FP32 per env
// (chip_smoke.py counts them from these loops), 0.1 GFLOP at B = 1024, 1.5
// us at 67 TFLOP/s. In truth neither: one thread per env makes a serial
// chain of ~1e5 dependent operations through per-thread scratch, and at B =
// 1024 that is only 32 warps. Blocks of 32 threads spread them over 32 SMs;
// the latency of that chain sets the time. The design keeps the batch on the
// minor axis, so a warp's 32 neighbouring envs load and store 128
// contiguous bytes per row; the per-thread scratch (frames, cdof, composite
// inertias, the packed lower triangle of M, the 6x6 inverse inertias of
// the contact bodies, the connect system: ~5k floats, ~20 KB) lives in
// local memory, which the 50 MB L2 holds at B = 1024. A redesign with one
// warp per env (lane = dof: nv = 32 is a warp) and frames in shared memory
// is later work.
//
// Tables (int32 itab, float32 ftab). itab starts with a header whose order
// is the enum below (and `_HEADER` in the Python module): scalars, then the
// offsets of the sections.
//   O_BODY    per body  [parent, first joint, joint count, rot is identity]
//   O_JOINT   per joint [type, qposadr, dofadr, 0]
//   O_ANC_PTR/O_ANC     CSR: ancestor dofs of each dof (ascending, not self)
//   O_BANC_PTR/O_BANC   CSR: dofs on the path from each body to the root
//   O_BDOF_PTR/O_BDOF   CSR: dofs of each body's joints
//   O_LIMSUP_PTR/O_LIMSUP  CSR: support anc[d] + [d] of each limit's solve
//   O_DOFBODY per dof body;  O_CON per contact [body, contact-body index]
//   O_CB      contact bodies (ascending)
//   O_LIM     per limit [dof, qposadr];  O_SPRING per dof spring qposadr
//   O_LIN     per hinge/slide [dof, qposadr];  O_BALL per ball [qposadr, dofadr]
//   O_ACT     per actuator [qposadr, dofadr]
//   O_EQ      per connect [body1, body2, support start, support length]
//   O_EQSUP   the supports (body1's ancestry, then body2's new dofs)
//   O_EQU     union of the supports (ascending);  O_LCON/O_RCON foot contacts
//   (HFIELD, a scalar of the header: 1 for a heightfield model)
//   F_BODY    per body [pos 3, rot 9, inertia 9]
//   F_JOINT   per joint [axis 3, ref, K 9, K@K 9]   K = skew(axis)
//   F_ARM per dof armature;  F_CON per contact [offset 3, radius]
//   F_LIM per limit [lo, hi];  F_SPRING per dof stiffness
//   F_ACT per actuator [gear, lo, hi];  F_EQ per connect [anchor1 3, anchor2 3]
//   F_CONST   [h, k_unit, b_unit, beta/h, 2h, h/2, a0 (6)]
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// capacity of the per-thread scratch (`_LIMITS` in the Python module)
constexpr int kNb = 32;
constexpr int kNv = 32;
constexpr int kNq = 40;
constexpr int kNu = 16;
constexpr int kNcon = 32;
constexpr int kNcb = 16;
constexpr int kNe = 12;  // 3 rows per connect, 4 connects
constexpr int kDiagRows = 44;
constexpr int kHfRes = 32;            // HFIELD_RES of the Python modules
constexpr float kHfMax = 30.999f;     // the lookup's clip, HFIELD_RES - 1.001

enum Header {
  NB, NV, NQ, NU, NCON, NCB, NEQ, NLIM, NLIN, NBALL, ROOT_ORIGIN, FEET, LF,
  RF, NLCON, NRCON, NEQU, HFIELD, O_BODY, O_JOINT, O_ANC_PTR, O_ANC, O_BANC_PTR,
  O_BANC, O_BDOF_PTR, O_BDOF, O_DOFBODY, O_CON, O_CB, O_LIM, O_LIMSUP_PTR,
  O_LIMSUP, O_SPRING, O_LIN, O_BALL, O_ACT, O_EQ, O_EQSUP, O_EQU, O_LCON,
  O_RCON, F_BODY, F_JOINT, F_ARM, F_CON, F_LIM, F_SPRING, F_ACT, F_EQ,
  F_CONST
};

constexpr int kSlide = 0;
constexpr int kHinge = 1;

// NaN-propagating max / min / clamp, as torch.clamp, torch.minimum and
// jnp.maximum (fmaxf and fminf would drop a NaN)
__device__ __forceinline__ float max_nan(float x, float lo) {
  return x < lo ? lo : x;
}
__device__ __forceinline__ float min_nan(float x, float hi) {
  return x > hi ? hi : x;
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// packed lower triangle of M + hD and its LTDL factor: entry (d, w), w <= d
__device__ __forceinline__ int tri(int d, int w) { return d * (d + 1) / 2 + w; }

// out = R @ C for a 3x3 constant C, skipping C's zero entries and
// multiplying by no 1.0, as the generator's mat_mul_c
__device__ void mat_mul_c(const float* R, const float* C, float* out) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float t = 0.f;
      bool any = false;
      for (int k = 0; k < 3; ++k) {
        const float c = C[3 * k + j];
        if (c == 0.f) continue;
        const float term = c == 1.f ? R[3 * i + k] : R[3 * i + k] * c;
        t = any ? t + term : term;
        any = true;
      }
      out[3 * i + j] = t;
    }
}

__device__ void matvec_c(const float* R, const float* v, float* out) {
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
    bool any = false;
    for (int k = 0; k < 3; ++k) {
      if (v[k] == 0.f) continue;
      const float term = v[k] == 1.f ? R[3 * i + k] : R[3 * i + k] * v[k];
      t = any ? t + term : term;
      any = true;
    }
    out[i] = t;
  }
}

// x = (M + hD)^-1 x restricted to an ancestor-closed support sup[0..n)
// (ascending): the L^T pass, the D scaling and the L pass of the generator's
// `solve`. Entries of x outside the support are never touched.
__device__ void ltdl_solve(const float* L, const float* Dinv, float* x,
                           const int* sup, int n, const int* anc_ptr,
                           const int* anc) {
  for (int s = n - 1; s >= 0; --s) {
    const int k = sup[s];
    const float xk = x[k];
    for (int a = anc_ptr[k]; a < anc_ptr[k + 1]; ++a) {
      const int i = anc[a];
      x[i] = x[i] - L[tri(k, i)] * xk;
    }
  }
  for (int s = 0; s < n; ++s) x[sup[s]] = x[sup[s]] * Dinv[sup[s]];
  for (int s = 0; s < n; ++s) {
    const int k = sup[s];
    float acc = x[k];
    for (int a = anc_ptr[k]; a < anc_ptr[k + 1]; ++a) {
      const int i = anc[a];
      acc = acc - L[tri(k, i)] * x[i];
    }
    x[k] = acc;
  }
}

// Height and gradient of the env's terrain at world (pwx, pwy): the corners
// of the cell from the table `hf` ((kHfRes^2, B) rows, this env's column
// b), combined in the order of the TPU kernel's tent-weight contraction.
__device__ void hfield_bilinear(const float* __restrict__ hf, int b, int B,
                                const float* fpos, float cellsz, float pwx,
                                float pwy, float* h, float* dhdx,
                                float* dhdy) {
  const float ux = min_nan(max_nan((pwx - fpos[0]) / cellsz + 15.5f, 0.f), kHfMax);
  const float uy = min_nan(max_nan((pwy - fpos[1]) / cellsz + 15.5f, 0.f), kHfMax);
  const float i0x = floorf(ux), i0y = floorf(uy);
  const float fx = ux - i0x, fy = uy - i0y;
  // a NaN coordinate converts to cell 0; its weights are NaN all the same
  const int ix = min(max(static_cast<int>(i0x), 0), kHfRes - 2);
  const int iy = min(max(static_cast<int>(i0y), 0), kHfRes - 2);
  const float* c = hf + static_cast<size_t>(ix * kHfRes + iy) * B + b;
  const float h00 = c[0], h01 = c[B];
  const float h10 = c[static_cast<size_t>(kHfRes) * B];
  const float h11 = c[static_cast<size_t>(kHfRes + 1) * B];
  const float acc0 = h00 * (1.f - fx) + h10 * fx;  // row iy, x contracted
  const float acc1 = h01 * (1.f - fx) + h11 * fx;  // row iy + 1
  *h = acc0 * (1.f - fy) + acc1 * fy;
  *dhdx = ((h10 - h00) * (1.f - fy) + (h11 - h01) * fy) / cellsz;
  *dhdy = (acc1 - acc0) / cellsz;
}

__device__ void mat2quat(const float* R, float* q) {
  const float m00 = R[0], m01 = R[1], m02 = R[2];
  const float m10 = R[3], m11 = R[4], m12 = R[5];
  const float m20 = R[6], m21 = R[7], m22 = R[8];
  const float tr = m00 + m11 + m22;
  if (tr > 0.f) {
    const float qw0 = sqrtf(max_nan(1.f + tr, 1e-12f)) / 2.f;
    q[0] = qw0;
    q[1] = (m21 - m12) / (4.f * qw0);
    q[2] = (m02 - m20) / (4.f * qw0);
    q[3] = (m10 - m01) / (4.f * qw0);
  } else if (m00 >= m11 && m00 >= m22) {
    const float s = sqrtf(max_nan(1.f + m00 - m11 - m22, 1e-12f)) * 2.f;
    q[0] = (m21 - m12) / s;
    q[1] = s / 4.f;
    q[2] = (m01 + m10) / s;
    q[3] = (m02 + m20) / s;
  } else if (m11 >= m22) {
    const float s = sqrtf(max_nan(1.f - m00 + m11 - m22, 1e-12f)) * 2.f;
    q[0] = (m02 - m20) / s;
    q[1] = (m01 + m10) / s;
    q[2] = s / 4.f;
    q[3] = (m12 + m21) / s;
  } else {
    const float s = sqrtf(max_nan(1.f - m00 - m11 + m22, 1e-12f)) * 2.f;
    q[0] = (m10 - m01) / s;
    q[1] = (m02 + m20) / s;
    q[2] = (m12 + m21) / s;
    q[3] = s / 4.f;
  }
  const float qn = rsqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int k = 0; k < 4; ++k) q[k] = q[k] * qn;
  if (q[0] < 0.f)
    for (int k = 0; k < 4; ++k) q[k] = -q[k];
}

__global__ void __launch_bounds__(32)
pd_substep_kernel(const float* __restrict__ qpos_in,
                  const float* __restrict__ qvel_in,
                  const float* __restrict__ cmd,
                  const float* __restrict__ damp_in,
                  const float* __restrict__ mass_in,
                  const float* __restrict__ ipos_in,
                  const float* __restrict__ misc,
                  const float* __restrict__ hfield,
                  float* __restrict__ qpos_out, float* __restrict__ qvel_out,
                  float* __restrict__ qacc_out, float* __restrict__ diag_out,
                  const int* __restrict__ it, const float* __restrict__ ft,
                  int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#define ROW(ptr, r) (ptr)[(size_t)(r) * B + b]

  const int nb = it[NB], nv = it[NV], nq = it[NQ], nu = it[NU];
  const int* body = it + it[O_BODY];
  const int* joint = it + it[O_JOINT];
  const int* anc_ptr = it + it[O_ANC_PTR];
  const int* anc = it + it[O_ANC];
  const int* banc_ptr = it + it[O_BANC_PTR];
  const int* banc = it + it[O_BANC];
  const int* bdof_ptr = it + it[O_BDOF_PTR];
  const int* bdof = it + it[O_BDOF];
  const int* dof_body = it + it[O_DOFBODY];
  const float* fbody = ft + it[F_BODY];
  const float* fjoint = ft + it[F_JOINT];
  const float* fc = ft + it[F_CONST];
  const float h = fc[0], k_unit = fc[1], b_unit = fc[2], beta_h = fc[3],
              two_h = fc[4], half_h = fc[5];

  float q[kNq], qd[kNv], damp[kNv];
  for (int i = 0; i < nq; ++i) q[i] = ROW(qpos_in, i);
  for (int d = 0; d < nv; ++d) {
    qd[d] = ROW(qvel_in, d);
    damp[d] = ROW(damp_in, d);
  }

  // ---- actuation: PD law at the actuated joints, actuator clamp ----
  float act_torque[kNu];
  float qfrc_act[kNv];
  for (int d = 0; d < nv; ++d) qfrc_act[d] = 0.f;
  {
    const int* act = it + it[O_ACT];
    const float* fact = ft + it[F_ACT];
    for (int k = 0; k < nu; ++k) {
      const float pt = ROW(cmd, k), dt = ROW(cmd, nu + k);
      const float pg = ROW(cmd, 2 * nu + k), dg = ROW(cmd, 3 * nu + k);
      const float ff = ROW(cmd, 4 * nu + k);
      const float tau = pg * (pt - q[act[2 * k]]) +
                        dg * (dt - qd[act[2 * k + 1]]) + ff;
      const float g = fact[3 * k];
      const float u = min_nan(max_nan(tau / g, fact[3 * k + 1]), fact[3 * k + 2]);
      act_torque[k] = g * u;
      qfrc_act[act[2 * k + 1]] = act_torque[k];
    }
  }

  // ---- forward kinematics ----
  float origin[3] = {0.f, 0.f, 0.f};
  if (it[ROOT_ORIGIN])
    for (int k = 0; k < 3; ++k) origin[k] = q[k];
  float xpos[kNb * 3], xmat[kNb * 9], cdof[kNv * 6];
  for (int i = 0; i < nb; ++i) {
    const int parent = body[4 * i], j0 = body[4 * i + 1],
              nj = body[4 * i + 2], rot_identity = body[4 * i + 3];
    const float* bpos = fbody + 21 * i;
    const float* brot = bpos + 3;
    float p[3], R[9];
    if (parent < 0) {
      for (int k = 0; k < 3; ++k) p[k] = bpos[k] - origin[k];
      for (int k = 0; k < 9; ++k) R[k] = brot[k];
    } else {
      const float* Rp = xmat + 9 * parent;
      for (int a = 0; a < 3; ++a) p[a] = xpos[3 * parent + a];
      for (int k = 0; k < 3; ++k)
        if (bpos[k] != 0.f)
          for (int a = 0; a < 3; ++a) p[a] = p[a] + Rp[3 * a + k] * bpos[k];
      if (rot_identity)
        for (int k = 0; k < 9; ++k) R[k] = Rp[k];
      else
        mat_mul_c(Rp, brot, R);
    }
    for (int jj = j0; jj < j0 + nj; ++jj) {
      const int type = joint[4 * jj], qadr = joint[4 * jj + 1],
                dadr = joint[4 * jj + 2];
      const float* jf = fjoint + 22 * jj;
      if (type == kSlide || type == kHinge) {
        float aw[3];
        matvec_c(R, jf, aw);
        const float t = q[qadr] - jf[3];
        if (type == kSlide) {
          for (int a = 0; a < 3; ++a) p[a] = p[a] + aw[a] * t;
          for (int k = 0; k < 3; ++k) {
            cdof[6 * dadr + k] = 0.f;
            cdof[6 * dadr + 3 + k] = aw[k];
          }
        } else {
          float RK[9], RKK[9];
          mat_mul_c(R, jf + 4, RK);
          mat_mul_c(R, jf + 13, RKK);
          const float s = sinf(t);
          const float c1 = 1.f - cosf(t);
          for (int k = 0; k < 9; ++k) R[k] = R[k] + s * RK[k] + c1 * RKK[k];
          const float neg[3] = {-p[0], -p[1], -p[2]};
          float lin[3];
          cross3(aw, neg, lin);
          for (int k = 0; k < 3; ++k) {
            cdof[6 * dadr + k] = aw[k];
            cdof[6 * dadr + 3 + k] = lin[k];
          }
        }
      } else {  // ball: unit quaternion (w, x, y, z), dofs in the child frame
        const float nrm = rsqrtf(q[qadr] * q[qadr] + q[qadr + 1] * q[qadr + 1] +
                                 q[qadr + 2] * q[qadr + 2] +
                                 q[qadr + 3] * q[qadr + 3]);
        const float w = q[qadr] * nrm, x = q[qadr + 1] * nrm,
                    y = q[qadr + 2] * nrm, z = q[qadr + 3] * nrm;
        const float Rq[9] = {
            1.f - 2.f * (y * y + z * z), 2.f * (x * y - w * z),
            2.f * (x * z + w * y),       2.f * (x * y + w * z),
            1.f - 2.f * (x * x + z * z), 2.f * (y * z - w * x),
            2.f * (x * z - w * y),       2.f * (y * z + w * x),
            1.f - 2.f * (x * x + y * y)};
        float Rn[9];
        for (int a = 0; a < 3; ++a)
          for (int c = 0; c < 3; ++c)
            Rn[3 * a + c] = R[3 * a] * Rq[c] + R[3 * a + 1] * Rq[3 + c] +
                            R[3 * a + 2] * Rq[6 + c];
        for (int k = 0; k < 9; ++k) R[k] = Rn[k];
        const float neg[3] = {-p[0], -p[1], -p[2]};
        for (int k = 0; k < 3; ++k) {
          const float aw[3] = {R[k], R[3 + k], R[6 + k]};
          float lin[3];
          cross3(aw, neg, lin);
          for (int e = 0; e < 3; ++e) {
            cdof[6 * (dadr + k) + e] = aw[e];
            cdof[6 * (dadr + k) + 3 + e] = lin[e];
          }
        }
      }
    }
    for (int k = 0; k < 3; ++k) xpos[3 * i + k] = p[k];
    for (int k = 0; k < 9; ++k) xmat[9 * i + k] = R[k];
  }

  // com positions from the per-env (dyn-rand) body_ipos
  float xipos[kNb * 3];
  for (int i = 0; i < nb; ++i) {
    const float ip0 = ROW(ipos_in, 3 * i), ip1 = ROW(ipos_in, 3 * i + 1),
                ip2 = ROW(ipos_in, 3 * i + 2);
    const float* R = xmat + 9 * i;
    for (int a = 0; a < 3; ++a)
      xipos[3 * i + a] = xpos[3 * i + a] + R[3 * a] * ip0 +
                         R[3 * a + 1] * ip1 + R[3 * a + 2] * ip2;
  }

  // ---- velocity pass: body spatial velocities and cdof_dot ----
  float bvel[kNb * 6], cdd[kNv * 6];
  for (int i = 0; i < nb; ++i) {
    const int parent = body[4 * i];
    float v[6];
    for (int k = 0; k < 6; ++k) v[k] = parent < 0 ? 0.f : bvel[6 * parent + k];
    for (int s = bdof_ptr[i]; s < bdof_ptr[i + 1]; ++s) {
      const int d = bdof[s];
      const float* m = cdof + 6 * d;
      float c0[3], c1[3], c2[3];
      cross3(v, m, c0);
      cross3(v, m + 3, c1);
      cross3(v + 3, m, c2);
      for (int k = 0; k < 3; ++k) {
        cdd[6 * d + k] = c0[k];
        cdd[6 * d + 3 + k] = c1[k] + c2[k];
      }
      for (int k = 0; k < 6; ++k) v[k] = v[k] + m[k] * qd[d];
    }
    for (int k = 0; k < 6; ++k) bvel[6 * i + k] = v[k];
  }

  // ---- spatial inertias about the origin: [[I - m CC, m C], [-m C, m]] ----
  float Ic[kNb * 36];
  for (int i = 0; i < nb; ++i) {
    const float* R = xmat + 9 * i;
    const float* I0 = fbody + 21 * i + 12;
    float T[9], Iw[9];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c) {
        float t = 0.f;
        for (int k = 0; k < 3; ++k)
          if (I0[3 * k + c] != 0.f) t = t + R[3 * a + k] * I0[3 * k + c];
        T[3 * a + c] = t;
      }
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        Iw[3 * a + c] = T[3 * a] * R[3 * c] + T[3 * a + 1] * R[3 * c + 1] +
                        T[3 * a + 2] * R[3 * c + 2];
    const float* cc = xipos + 3 * i;
    const float c2 = cc[0] * cc[0] + cc[1] * cc[1] + cc[2] * cc[2];
    const float m = ROW(mass_in, i);
    const float C3[9] = {0.f, -cc[2], cc[1], cc[2], 0.f, -cc[0],
                         -cc[1], cc[0], 0.f};
    float* A6 = Ic + 36 * i;
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c) {
        const float CC = cc[a] * cc[c] - (a == c ? c2 : 0.f);
        A6[6 * a + c] = Iw[3 * a + c] - m * CC;
        const float mC = m * C3[3 * a + c];
        A6[6 * a + 3 + c] = mC;
        A6[6 * (3 + a) + c] = -mC;
        A6[6 * (3 + a) + 3 + c] = a == c ? m : 0.f;
      }
  }

  // ---- RNEA bias (qacc = 0, gravity as base acceleration) ----
  float F[kNb * 6];
  {
    float bacc[kNb * 6];
    for (int i = 0; i < nb; ++i) {
      const int parent = body[4 * i];
      float a[6];
      for (int k = 0; k < 6; ++k)
        a[k] = parent < 0 ? fc[6 + k] : bacc[6 * parent + k];
      for (int s = bdof_ptr[i]; s < bdof_ptr[i + 1]; ++s) {
        const int d = bdof[s];
        for (int k = 0; k < 6; ++k) a[k] = a[k] + cdd[6 * d + k] * qd[d];
      }
      for (int k = 0; k < 6; ++k) bacc[6 * i + k] = a[k];
      const float* I = Ic + 36 * i;
      const float* v = bvel + 6 * i;
      float Iv[6], Ia[6];
      for (int r = 0; r < 6; ++r) {
        Iv[r] = I[6 * r] * v[0] + I[6 * r + 1] * v[1] + I[6 * r + 2] * v[2] +
                I[6 * r + 3] * v[3] + I[6 * r + 4] * v[4] + I[6 * r + 5] * v[5];
        Ia[r] = I[6 * r] * a[0] + I[6 * r + 1] * a[1] + I[6 * r + 2] * a[2] +
                I[6 * r + 3] * a[3] + I[6 * r + 4] * a[4] + I[6 * r + 5] * a[5];
      }
      float c0[3], c1[3], c2[3];
      cross3(v, Iv, c0);
      cross3(v + 3, Iv + 3, c1);
      cross3(v, Iv + 3, c2);
      for (int k = 0; k < 3; ++k) {
        F[6 * i + k] = Ia[k] + (c0[k] + c1[k]);
        F[6 * i + 3 + k] = Ia[3 + k] + c2[k];
      }
    }
  }
  for (int i = nb - 1; i >= 0; --i) {
    const int parent = body[4 * i];
    if (parent >= 0)
      for (int k = 0; k < 6; ++k) F[6 * parent + k] = F[6 * parent + k] + F[6 * i + k];
  }
  float qfrc_bias[kNv];
  for (int d = 0; d < nv; ++d) {
    const float* c = cdof + 6 * d;
    const float* f = F + 6 * dof_body[d];
    qfrc_bias[d] = c[0] * f[0] + c[1] * f[1] + c[2] * f[2] + c[3] * f[3] +
                   c[4] * f[4] + c[5] * f[5];
  }

  // ---- CRBA: composite inertias, M + hD at the ancestor pairs ----
  for (int i = nb - 1; i >= 0; --i) {
    const int parent = body[4 * i];
    if (parent >= 0)
      for (int k = 0; k < 36; ++k)
        Ic[36 * parent + k] = Ic[36 * parent + k] + Ic[36 * i + k];
  }
  float A[kNv * (kNv + 1) / 2];
  {
    const float* arm = ft + it[F_ARM];
    for (int d = 0; d < nv; ++d) {
      const float* I = Ic + 36 * dof_body[d];
      const float* c = cdof + 6 * d;
      float H[6];
      for (int r = 0; r < 6; ++r)
        H[r] = I[6 * r] * c[0] + I[6 * r + 1] * c[1] + I[6 * r + 2] * c[2] +
               I[6 * r + 3] * c[3] + I[6 * r + 4] * c[4] + I[6 * r + 5] * c[5];
      for (int s = anc_ptr[d]; s <= anc_ptr[d + 1]; ++s) {
        const int w = s < anc_ptr[d + 1] ? anc[s] : d;
        const float* cw = cdof + 6 * w;
        A[tri(d, w)] = H[0] * cw[0] + H[1] * cw[1] + H[2] * cw[2] +
                       H[3] * cw[3] + H[4] * cw[4] + H[5] * cw[5];
      }
      A[tri(d, d)] = A[tri(d, d)] + arm[d] + h * damp[d];
    }
  }

  // ---- LTDL of M + hD, in place: A = L^T D L, L in A's strict lower part --
  float Dinv[kNv];
  for (int k = nv - 1; k >= 0; --k) {
    const float Dk = max_nan(A[tri(k, k)], 1e-12f);
    Dinv[k] = 1.f / Dk;
    for (int s = anc_ptr[k + 1] - 1; s >= anc_ptr[k]; --s) {
      const int i = anc[s];
      const float a_ = A[tri(k, i)] * Dinv[k];
      A[tri(i, i)] = A[tri(i, i)] - a_ * A[tri(k, i)];
      for (int s2 = anc_ptr[i + 1] - 1; s2 >= anc_ptr[i]; --s2) {
        const int j = anc[s2];
        A[tri(i, j)] = A[tri(i, j)] - a_ * A[tri(k, j)];
      }
      A[tri(k, i)] = a_;
    }
  }

  // ---- contact forces (plane / tilted floor) ----
  const float friction = ROW(misc, 0);
  const float fq[4] = {ROW(misc, 1), ROW(misc, 2), ROW(misc, 3), ROW(misc, 4)};
  float n_w[3];
  {
    const float uq[3] = {fq[1], fq[2], fq[3]};
    const float vz[3] = {0.f, 0.f, 1.f};
    float uv[3], uuv[3];
    cross3(uq, vz, uv);
    cross3(uq, uv, uuv);
    for (int k = 0; k < 3; ++k) n_w[k] = vz[k] + 2.f * (fq[0] * uv[k] + uuv[k]);
  }
  const float fpos[3] = {ROW(misc, 5), ROW(misc, 6), ROW(misc, 7)};
  float floor_p[3];
  for (int k = 0; k < 3; ++k) floor_p[k] = fpos[k] - origin[k];
  // terrain of a heightfield model, for this env when it is active
  const bool on_terrain = it[HFIELD] && ROW(misc, 15) > 0.5f;
  const float cellsz = on_terrain ? 2.f * ROW(misc, 14) / (kHfRes - 1) : 0.f;

  float qfrc_con[kNv];
  for (int d = 0; d < nv; ++d) qfrc_con[d] = 0.f;
  const int ncon = it[NCON], ncb = it[NCB];
  float sphere_f[kNcon * 3], sphere_vp[kNcon * 3];
  if (ncon > 0) {
    const int* con = it + it[O_CON];
    const int* cbs = it + it[O_CB];
    const float* fcon = ft + it[F_CON];
    // per contact body: the 6x6 S_b A^-1 S_b^T (symmetric) by 6 restricted
    // solves over the body's ancestry
    float Lam[kNcb * 36];
    for (int c = 0; c < ncb; ++c) {
      const int ub = cbs[c];
      const int* sup = banc + banc_ptr[ub];
      const int n = banc_ptr[ub + 1] - banc_ptr[ub];
      float ts[6 * kNv];
      for (int r = 0; r < 6; ++r) {
        float* x = ts + kNv * r;
        for (int s = 0; s < n; ++s) x[sup[s]] = cdof[6 * sup[s] + r];
        ltdl_solve(A, Dinv, x, sup, n, anc_ptr, anc);
      }
      float* Lb = Lam + 36 * c;
      for (int r = 0; r < 6; ++r)
        for (int cl = r; cl < 6; ++cl) {
          float val = 0.f;
          for (int s = 0; s < n; ++s)
            val = val + ts[kNv * r + sup[s]] * cdof[6 * sup[s] + cl];
          Lb[6 * r + cl] = val;
          Lb[6 * cl + r] = val;
        }
    }

    float Wb[kNcb * 6];
    for (int k = 0; k < 6 * ncb; ++k) Wb[k] = 0.f;
    for (int ci = 0; ci < ncon; ++ci) {
      const int cb = con[2 * ci], cidx = con[2 * ci + 1];
      const float* off = fcon + 4 * ci;
      const float radius = off[3];
      const float* R = xmat + 9 * cb;
      float p[3];
      for (int a = 0; a < 3; ++a) {
        float t = 0.f;
        for (int k = 0; k < 3; ++k)
          if (off[k] != 0.f) t = t + R[3 * a + k] * off[k];
        p[a] = xpos[3 * cb + a] + t;
      }
      float depth =
          radius - ((p[0] - floor_p[0]) * n_w[0] + (p[1] - floor_p[1]) * n_w[1] +
                    (p[2] - floor_p[2]) * n_w[2]);
      const float* nc = n_w;
      float n_h[3];
      if (on_terrain) {
        const float pw[3] = {p[0] + origin[0], p[1] + origin[1], p[2] + origin[2]};
        float hh, dhdx, dhdy;
        hfield_bilinear(hfield, b, B, fpos, cellsz, pw[0], pw[1], &hh, &dhdx,
                        &dhdy);
        const float hnorm = sqrtf(dhdx * dhdx + dhdy * dhdy + 1.f);
        n_h[0] = -dhdx / hnorm;
        n_h[1] = -dhdy / hnorm;
        n_h[2] = 1.f / hnorm;
        depth = radius + (fpos[2] + hh) - pw[2];
        nc = n_h;
      }
      const float* bv = bvel + 6 * cb;
      float wxp[3], vp[3];
      cross3(bv, p, wxp);
      for (int k = 0; k < 3; ++k) vp[k] = bv[3 + k] + wxp[k];
      for (int k = 0; k < 3; ++k) sphere_vp[3 * ci + k] = vp[k];

      // G = Phi Lam Phi^T, Phi = [-skew(p) | I], in the generator's steps
      const float* Lb = Lam + 36 * cidx;
      float PLaa[9], PLaaPT_t[9], PLal[9];
      for (int j = 0; j < 3; ++j) {
        const float col[3] = {Lb[j], Lb[6 + j], Lb[12 + j]};
        float cx[3];
        cross3(p, col, cx);
        for (int r = 0; r < 3; ++r) PLaa[3 * r + j] = -cx[r];
        const float col2[3] = {Lb[3 + j], Lb[9 + j], Lb[15 + j]};
        cross3(p, col2, cx);
        for (int r = 0; r < 3; ++r) PLal[3 * r + j] = -cx[r];
      }
      for (int j = 0; j < 3; ++j) {  // columns of PLaa^T = rows of PLaa
        const float col[3] = {PLaa[3 * j], PLaa[3 * j + 1], PLaa[3 * j + 2]};
        float cx[3];
        cross3(p, col, cx);
        for (int r = 0; r < 3; ++r) PLaaPT_t[3 * r + j] = -cx[r];
      }
      float G[9];
      for (int r = 0; r < 3; ++r)
        for (int cl = 0; cl < 3; ++cl)
          G[3 * r + cl] = PLaaPT_t[3 * cl + r] + PLal[3 * r + cl] +
                          PLal[3 * cl + r] + Lb[6 * (3 + r) + 3 + cl];

      float Gn[3];
      for (int r = 0; r < 3; ++r)
        Gn[r] = G[3 * r] * nc[0] + G[3 * r + 1] * nc[1] + G[3 * r + 2] * nc[2];
      const float g_n = nc[0] * Gn[0] + nc[1] * Gn[1] + nc[2] * Gn[2];
      const float m_n = 1.f / max_nan(g_n, 1e-8f);
      const float vn = vp[0] * nc[0] + vp[1] * nc[1] + vp[2] * nc[2];
      float fn = max_nan(m_n * (k_unit * depth - b_unit * vn), 0.f);
      fn = depth > 0.f ? fn : 0.f;
      float vt[3];
      for (int k = 0; k < 3; ++k) vt[k] = vp[k] - vn * nc[k];
      const float vt_norm = sqrtf(vt[0] * vt[0] + vt[1] * vt[1] + vt[2] * vt[2]) + 1e-9f;
      const float trG = G[0] + G[4] + G[8];
      const float m_t = 1.f / max_nan((trG - g_n) / 2.f, 1e-8f);
      const float f_stick = m_t * vt_norm / two_h;
      const float ft_mag = min_nan(friction * fn, f_stick);
      const float scale = ft_mag / vt_norm;
      float f[3];
      for (int k = 0; k < 3; ++k) f[k] = fn * nc[k] - scale * vt[k];
      for (int k = 0; k < 3; ++k) sphere_f[3 * ci + k] = f[k];
      float pxf[3];
      cross3(p, f, pxf);
      float* W = Wb + 6 * cidx;
      for (int k = 0; k < 3; ++k) {
        W[k] = W[k] + pxf[k];
        W[3 + k] = W[3 + k] + f[k];
      }
    }
    for (int c = 0; c < ncb; ++c) {
      const int ub = cbs[c];
      const float* W = Wb + 6 * c;
      for (int s = banc_ptr[ub]; s < banc_ptr[ub + 1]; ++s) {
        const int d = banc[s];
        const float* cd = cdof + 6 * d;
        qfrc_con[d] = qfrc_con[d] + (cd[0] * W[0] + cd[1] * W[1] + cd[2] * W[2] +
                                     cd[3] * W[3] + cd[4] * W[4] + cd[5] * W[5]);
      }
    }
  }

  // ---- joint limits: effective masses from restricted solves ----
  float qfrc_lim[kNv];
  for (int d = 0; d < nv; ++d) qfrc_lim[d] = 0.f;
  {
    const int* lim = it + it[O_LIM];
    const int* lsup_ptr = it + it[O_LIMSUP_PTR];
    const int* lsup = it + it[O_LIMSUP];
    const float* flim = ft + it[F_LIM];
    for (int li = 0; li < it[NLIM]; ++li) {
      const int d = lim[2 * li], qadr = lim[2 * li + 1];
      const int* sup = lsup + lsup_ptr[li];
      const int n = lsup_ptr[li + 1] - lsup_ptr[li];
      float x[kNv];
      for (int s = 0; s < n; ++s) x[sup[s]] = 0.f;
      x[d] = 1.f;
      ltdl_solve(A, Dinv, x, sup, n, anc_ptr, anc);
      const float m_eff = 1.f / max_nan(x[d], 1e-8f);
      const float qj = q[qadr], qdj = qd[d];
      const float below = flim[2 * li] - qj;
      const float above = qj - flim[2 * li + 1];
      const float f_lo = below > 0.f ? m_eff * (k_unit * below - b_unit * qdj) : 0.f;
      const float f_hi = above > 0.f ? m_eff * (k_unit * above + b_unit * qdj) : 0.f;
      qfrc_lim[d] = qfrc_lim[d] + (max_nan(f_lo, 0.f) - max_nan(f_hi, 0.f));
    }
  }

  // ---- external wrench on the root body ----
  float qfrc_ext[kNv];
  for (int d = 0; d < nv; ++d) qfrc_ext[d] = 0.f;
  {
    const float ext[6] = {ROW(misc, 8),  ROW(misc, 9),  ROW(misc, 10),
                          ROW(misc, 11), ROW(misc, 12), ROW(misc, 13)};
    float xF[3];
    cross3(xpos, ext + 3, xF);
    const float w[6] = {ext[0] + xF[0], ext[1] + xF[1], ext[2] + xF[2],
                        ext[3], ext[4], ext[5]};
    for (int s = banc_ptr[0]; s < banc_ptr[1]; ++s) {
      const int d = banc[s];
      const float* cd = cdof + 6 * d;
      qfrc_ext[d] = cd[0] * w[0] + cd[1] * w[1] + cd[2] * w[2] + cd[3] * w[3] +
                    cd[4] * w[4] + cd[5] * w[5];
    }
  }

  // ---- free acceleration with implicit damping (springs inline) ----
  float vpred[kNv];
  {
    const int* spring_qadr = it + it[O_SPRING];
    const float* spring_k = ft + it[F_SPRING];
    for (int d = 0; d < nv; ++d) {
      float t = -qfrc_bias[d] - damp[d] * qd[d];
      t = t + qfrc_act[d];
      if (spring_k[d] != 0.f) t = t + -spring_k[d] * q[spring_qadr[d]];
      t = t + qfrc_con[d];
      t = t + qfrc_lim[d];
      t = t + qfrc_ext[d];
      vpred[d] = t;
    }
    int all[kNv];
    for (int d = 0; d < nv; ++d) all[d] = d;
    ltdl_solve(A, Dinv, vpred, all, nv, anc_ptr, anc);
    for (int d = 0; d < nv; ++d) vpred[d] = qd[d] + h * vpred[d];
  }

  // ---- loop-closure (connect) impulses ----
  float qvel2[kNv];
  const int neq = it[NEQ];
  if (neq > 0) {
    const int ne = 3 * neq;
    const int* eq = it + it[O_EQ];
    const int* eqsup = it + it[O_EQSUP];
    const int* equ = it + it[O_EQU];
    const int nequ = it[NEQU];
    const float* feq = ft + it[F_EQ];
    float J[kNe * kNv], tsol[kNe * kNv], err[kNe];
    for (int k = 0; k < ne * kNv; ++k) J[k] = 0.f;
    for (int e = 0; e < neq; ++e) {
      const int b1 = eq[4 * e], b2 = eq[4 * e + 1];
      float a1[3], a2[3], p1[3], p2[3];
      matvec_c(xmat + 9 * b1, feq + 6 * e, a1);
      matvec_c(xmat + 9 * b2, feq + 6 * e + 3, a2);
      for (int a = 0; a < 3; ++a) {
        p1[a] = xpos[3 * b1 + a] + a1[a];
        p2[a] = xpos[3 * b2 + a] + a2[a];
      }
      for (int k = 0; k < 3; ++k) err[3 * e + k] = p1[k] - p2[k];
      for (int s = banc_ptr[b1]; s < banc_ptr[b1 + 1]; ++s) {
        const int d = banc[s];
        float c1[3];
        cross3(cdof + 6 * d, p1, c1);
        for (int k = 0; k < 3; ++k)
          J[kNv * (3 * e + k) + d] = c1[k] + cdof[6 * d + 3 + k];
      }
      for (int s = banc_ptr[b2]; s < banc_ptr[b2 + 1]; ++s) {
        const int d = banc[s];
        float c2[3];
        cross3(cdof + 6 * d, p2, c2);
        for (int k = 0; k < 3; ++k)
          J[kNv * (3 * e + k) + d] =
              J[kNv * (3 * e + k) + d] - (c2[k] + cdof[6 * d + 3 + k]);
      }
    }
    // G = J A^-1 J^T by ne solves over the union of the supports
    for (int r = 0; r < ne; ++r) {
      float* x = tsol + kNv * r;
      for (int s = 0; s < nequ; ++s) x[equ[s]] = J[kNv * r + equ[s]];
      ltdl_solve(A, Dinv, x, equ, nequ, anc_ptr, anc);
    }
    float G[kNe * kNe];
    for (int r = 0; r < ne; ++r)
      for (int cl = r; cl < ne; ++cl) {
        const int e = cl / 3;
        const int* sup = eqsup + eq[4 * e + 2];
        const int n = eq[4 * e + 3];
        float val = 0.f;
        for (int s = 0; s < n; ++s)
          val = val + tsol[kNv * r + sup[s]] * J[kNv * cl + sup[s]];
        G[ne * r + cl] = val;
        G[ne * cl + r] = val;
      }
    float dn[kNe], rhs[kNe];
    for (int r = 0; r < ne; ++r) dn[r] = rsqrtf(G[ne * r + r] + 1e-12f);
    float Gs[kNe * kNe];
    for (int r = 0; r < ne; ++r)
      for (int cl = 0; cl < ne; ++cl)
        Gs[ne * r + cl] = dn[r] * G[ne * r + cl] * dn[cl] + (r == cl ? 1e-6f : 0.f);
    for (int r = 0; r < ne; ++r) {
      const int e = r / 3;
      const int* sup = eqsup + eq[4 * e + 2];
      const int n = eq[4 * e + 3];
      float jv = 0.f;
      for (int s = 0; s < n; ++s) jv = jv + J[kNv * r + sup[s]] * vpred[sup[s]];
      rhs[r] = dn[r] * -(jv + beta_h * err[r]);
    }
    // dense Cholesky with a pivot floor, then the two triangular solves
    float Lc[kNe * kNe];
    for (int j = 0; j < ne; ++j) {
      float s = Gs[ne * j + j];
      for (int p = 0; p < j; ++p) s = s - Lc[ne * j + p] * Lc[ne * j + p];
      const float dpv = sqrtf(max_nan(s, 1e-4f));
      Lc[ne * j + j] = dpv;
      for (int i = j + 1; i < ne; ++i) {
        float r_ = Gs[ne * i + j];
        for (int p = 0; p < j; ++p) r_ = r_ - Lc[ne * i + p] * Lc[ne * j + p];
        Lc[ne * i + j] = r_ / dpv;
      }
    }
    float y[kNe], lam[kNe];
    for (int i = 0; i < ne; ++i) {
      float r_ = rhs[i];
      for (int p = 0; p < i; ++p) r_ = r_ - Lc[ne * i + p] * y[p];
      y[i] = r_ / Lc[ne * i + i];
    }
    for (int i = ne - 1; i >= 0; --i) {
      float r_ = y[i];
      for (int p = i + 1; p < ne; ++p) r_ = r_ - Lc[ne * p + i] * lam[p];
      lam[i] = r_ / Lc[ne * i + i];
    }
    for (int r = 0; r < ne; ++r) lam[r] = dn[r] * lam[r];
    float dv[kNv];
    for (int d = 0; d < nv; ++d) dv[d] = 0.f;
    for (int r = 0; r < ne; ++r) {
      const int e = r / 3;
      const int* sup = eqsup + eq[4 * e + 2];
      const int n = eq[4 * e + 3];
      for (int s = 0; s < n; ++s)
        dv[sup[s]] = dv[sup[s]] + J[kNv * r + sup[s]] * lam[r];
    }
    int all[kNv];
    for (int d = 0; d < nv; ++d) all[d] = d;
    ltdl_solve(A, Dinv, dv, all, nv, anc_ptr, anc);
    for (int d = 0; d < nv; ++d) qvel2[d] = vpred[d] + dv[d];
  } else {
    for (int d = 0; d < nv; ++d) qvel2[d] = vpred[d];
  }

  // ---- integrate qpos, write the state ----
  float q2[kNq];
  for (int i = 0; i < nq; ++i) q2[i] = q[i];
  {
    const int* lin = it + it[O_LIN];
    for (int s = 0; s < it[NLIN]; ++s) {
      const int d = lin[2 * s], qa = lin[2 * s + 1];
      q2[qa] = q[qa] + h * qvel2[d];
    }
    const int* ball = it + it[O_BALL];
    for (int s = 0; s < it[NBALL]; ++s) {
      const int qa = ball[2 * s], da = ball[2 * s + 1];
      const float om[3] = {qvel2[da], qvel2[da + 1], qvel2[da + 2]};
      const float ang = sqrtf(om[0] * om[0] + om[1] * om[1] + om[2] * om[2]) * h;
      const float half = 0.5f * ang;
      const bool small = ang < 1e-8f;
      const float kf = small ? half_h : sinf(half) * h / ang;
      const float w2 = cosf(half), x2 = om[0] * kf, y2 = om[1] * kf,
                  z2 = om[2] * kf;
      const float w1 = q[qa], x1 = q[qa + 1], y1 = q[qa + 2], z1 = q[qa + 3];
      const float o[4] = {w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                          w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                          w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                          w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2};
      const float qn = rsqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
      for (int k = 0; k < 4; ++k) q2[qa + k] = o[k] * qn;
    }
  }
  for (int i = 0; i < nq; ++i) ROW(qpos_out, i) = q2[i];
  for (int d = 0; d < nv; ++d) {
    ROW(qvel_out, d) = qvel2[d];
    ROW(qacc_out, d) = (qvel2[d] - qd[d]) / h;
  }

  // ---- diagnostic rows ----
  float diag[kDiagRows];
  for (int r = 0; r < kDiagRows; ++r) diag[r] = 0.f;
  if (it[FEET]) {
    const int lf = it[LF], rf = it[RF];
    const int* lcon = it + it[O_LCON];
    const int* rcon = it + it[O_RCON];
    float l = 0.f, r = 0.f;
    for (int s = 0; s < it[NLCON]; ++s) l = l + sphere_f[3 * lcon[s] + 2];
    for (int s = 0; s < it[NRCON]; ++s) r = r + sphere_f[3 * rcon[s] + 2];
    diag[0] = l;
    diag[1] = r;
    for (int k = 0; k < 3; ++k) {
      diag[2 + k] = xpos[3 * lf + k] + origin[k];
      diag[5 + k] = xpos[3 * rf + k] + origin[k];
      diag[8 + k] = (sphere_vp[3 * lcon[0] + k] + sphere_vp[3 * lcon[1] + k]) / 2.f;
      diag[11 + k] = (sphere_vp[3 * rcon[0] + k] + sphere_vp[3 * rcon[1] + k]) / 2.f;
    }
    mat2quat(xmat + 9 * lf, diag + 14);
    mat2quat(xmat + 9 * rf, diag + 18);
    const int th[4] = {lcon[0], lcon[1], rcon[0], rcon[1]};
    for (int s = 0; s < 4; ++s)
      for (int k = 0; k < 3; ++k) diag[22 + 3 * s + k] = sphere_f[3 * th[s] + k];
  }
  for (int k = 0; k < nu && k < 10; ++k) diag[34 + k] = act_torque[k];
  for (int r = 0; r < kDiagRows; ++r) ROW(diag_out, r) = diag[r];
#undef ROW
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() as an int (0 = ok).
extern "C" int apex_pd_substep(const float* qpos, const float* qvel,
                               const float* cmd, const float* damp,
                               const float* mass, const float* ipos,
                               const float* misc, const float* hfield,
                               float* qpos_out,
                               float* qvel_out, float* qacc_out,
                               float* diag_out, const int* itab,
                               const float* ftab, int B, void* stream) {
  constexpr int kThreads = 32;
  const int blocks = (B + kThreads - 1) / kThreads;
  pd_substep_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      qpos, qvel, cmd, damp, mass, ipos, misc, hfield, qpos_out, qvel_out,
      qacc_out, diag_out, itab, ftab, B);
  return static_cast<int>(cudaGetLastError());
}
