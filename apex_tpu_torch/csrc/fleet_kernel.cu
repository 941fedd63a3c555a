// One whole PD substep of the env fleet, two warps per env (K1).
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
// weights because Mosaic cannot gather per lane; here the contact's lane
// reads the four corners of its cell and combines them in the
// contraction's order (x first, then y), which gives the contraction's
// values: its other terms are exact zeros. Flat models and inactive envs
// run the plane code; the branch is taken per env, by the whole warp. Of
// the env's 4 KB table column, each contact reads the 4 floats of its
// cell's corners and nothing else.
//
// What bounds it. Bytes: (263 input + 143 output) rows x 4 B per env, 1.66
// MB at B = 1024, 0.5 us at 3.35 TB/s. Operations: about 7.3e4 FP32 per env
// (chip_smoke.py counts them from these loops), 75 MFLOP at B = 1024, 1.1
// us at 67 TFLOP/s. In truth neither: the substep is a chain of dependent
// steps along the tree and through the factor of M + hD, each a few shared
// memory loads, an index computation and an FMA, and its time is that
// chain's latency on one warp (scripts/k1_phase_clocks.py times each
// phase). So an env's scratch and both model tables live in shared memory,
// and the lanes take the independent work of each phase:
//   tree passes (FK, com, velocities, cdof_dot, RNEA accelerations): lane =
//     body, level by level from the root (O_LVL), __syncwarp between levels;
//   spatial inertias and RNEA body forces: lane = body, all at once;
//   the sums up the tree (RNEA forces, composite inertias): lane = one of
//     the 42 components, bodies in the serial order;
//   RNEA bias and CRBA: lane = dof (nv <= 32);
//   LTDL: per column k, lane = one (i, j) update of the column's list
//     (O_LTDL), __syncwarp after each column; every update reads the
//     unscaled row k, as the serial loop does, and row k is scaled in the
//     next column's step;
//   Lambda of the contact bodies and the limits (O_TASK: 6 solves per
//     contact body, one per limit, each over a chain of the dof tree): lane
//     = one right-hand side, in rounds of 32, each lane's vector a column of
//     a 16 x 32 block (conflict-free banks); the lane finishes its own rows
//     of Lambda or its limit's force;
//   contacts and the heightfield lookup: lane = contact; wrenches: lane =
//     (contact body, component); generalized forces: lane = dof;
//   the two full solves (free acceleration, connect impulse): lane = dof, a
//     depth of the dof tree per step (L^T pass from the leaves, L pass from
//     the root); the solves' L^T pass pulls each x[i]'s terms from its
//     descendants in the push form's order;
//   integration: lane = joint; diagnostic rows: lane = row.
// A second warp per env takes the connect system once M + hD is factored
// and J built: the 12 rows' solves over the connects' support (lane = a
// dof of one depth and a group of rows, O_DLVL), G = J A^-1 J^T (lane =
// entry), its scaling and Cholesky factor (lane = row), while the main
// warp runs Lambda, the limits, the contacts and the free acceleration;
// the two meet at a named barrier per env before and after.
// Every value is summed by one lane, in the generator's order, so the
// arithmetic of each output is that of the plain version, up to where nvcc
// contracts a product into an FMA. There is no reduction across lanes.
//
// Launch: blocks of kEnvsPerBlock = 2 envs, 4 warps; the warps of an env
// past B return at once, both, after the tables are copied. Shared memory:
// one `Scratch` per env (17,888 B at the capacities below; the tree-pass
// arrays share their space with what the later phases need) and the two
// tables (19,292 B for Cassie), dynamic: 55,068 B per block. The
// per-env barrier's id is a run-time value, so ptxas reserves the block's
// 16 barriers, which allows 4 blocks, 8 envs, per SM: B = 1024 runs in one
// wave over all 132 SMs (1,056 places). The build: 95 registers, a 64-byte
// stack frame, no spills. `apex_pd_substep_info` reports the bytes and the
// envs resident per SM. The batch stays on the minor axis of every row, so
// one env's loads and stores are strided by B: 4 bytes of each 32-byte
// sector, which costs nothing next to the chain.
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
//   O_LVL_PTR/O_LVL     CSR: the bodies at each depth of the tree (NLVL)
//   O_DLVL_PTR/O_DLVL   CSR: the dofs at each depth of the dof tree (their
//                       count of ancestors; DOF_DEPTH depths)
//   O_DESC_PTR/O_DESC   CSR: descendant dofs of each dof (descending)
//   O_LTDL_PTR/O_LTDL   CSR: per column k the LTDL updates of A[i, j], i in
//                       anc[k], j in [i] + anc[i], each one int: the packed
//                       offsets tri(i, j) | tri(k, i) << 10 | tri(k, j) << 20
//   O_TASK    per one-lane restricted solve [kind, index] (NTASK): kind 0 =
//             row r of contact body c's Lambda (index 6c + r), 1 = limit
//   O_BMASK   per body a bit mask of the dofs on its path to the root
//   (HFIELD, a scalar of the header: 1 for a heightfield model; DOF_DEPTH:
//   1 + the most ancestors of a dof; EQU_MASK: the bit mask of O_EQU)
//   F_BODY    per body [pos 3, rot 9, inertia 9]
//   F_JOINT   per joint [axis 3, ref, K 9, K@K 9]   K = skew(axis)
//   F_ARM per dof armature;  F_CON per contact [offset 3, radius]
//   F_LIM per limit [lo, hi];  F_SPRING per dof stiffness
//   F_ACT per actuator [gear, lo, hi];  F_EQ per connect [anchor1 3, anchor2 3]
//   F_CONST   [h, k_unit, b_unit, beta/h, 2h, h/2, a0 (6)]
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// capacity of the per-env scratch (`_LIMITS` in the Python module)
constexpr int kNb = 32;
constexpr int kNv = 32;
constexpr int kNq = 40;
constexpr int kNu = 16;
constexpr int kNcon = 32;
constexpr int kNcb = 16;
constexpr int kNlim = 32;
constexpr int kNe = 12;  // 3 rows per connect, 4 connects
constexpr int kChain = 16;  // dofs of a contact body's path, or of a limit's
constexpr int kDiagRows = 44;
constexpr int kMiscRows = 16;
constexpr int kHfRes = 32;            // HFIELD_RES of the Python modules
constexpr float kHfMax = 30.999f;     // the lookup's clip, HFIELD_RES - 1.001

constexpr int kLanes = 32;
constexpr int kWarpsPerEnv = 2;       // the main warp, and the connect warp
constexpr int kEnvsPerBlock = 2;
constexpr int kThreads = kLanes * kWarpsPerEnv * kEnvsPerBlock;
constexpr int kTri = kNv * (kNv + 1) / 2;
constexpr int kJ = kNv + 1;           // J's row stride: rows on distinct banks
constexpr int kRowGroups = 4;         // a connect-warp lane's rows: g + 4 j

enum Header {
  NB, NV, NQ, NU, NCON, NCB, NEQ, NLIM, NLIN, NBALL, ROOT_ORIGIN, FEET, LF,
  RF, NLCON, NRCON, NEQU, HFIELD, NLVL, NTASK, DOF_DEPTH, EQU_MASK, O_BODY,
  O_JOINT, O_ANC_PTR, O_ANC, O_BANC_PTR, O_BANC, O_BDOF_PTR, O_BDOF,
  O_DOFBODY, O_CON, O_CB, O_LIM, O_LIMSUP_PTR, O_LIMSUP, O_SPRING, O_LIN,
  O_BALL, O_ACT, O_EQ, O_EQSUP, O_EQU, O_LCON, O_RCON, O_LVL_PTR, O_LVL,
  O_DLVL_PTR, O_DLVL, O_DESC_PTR, O_DESC, O_LTDL_PTR, O_LTDL, O_TASK, O_BMASK,
  F_BODY, F_JOINT, F_ARM, F_CON, F_LIM, F_SPRING, F_ACT, F_EQ, F_CONST
};

constexpr int kSlide = 0;
constexpr int kHinge = 1;
constexpr int kTaskLambda = 0;     // else a limit

// One env's scratch in shared memory. The tree-pass arrays are dead once M
// + hD is assembled, and what the later phases need takes their place.
struct Scratch {
  float q[kNq], qd[kNv], damp[kNv], misc[kMiscRows];
  float act_torque[kNu], qfrc_act[kNv];
  float xpos[kNb * 3], xmat[kNb * 9], cdof[kNv * 6], bvel[kNb * 6];
  float qfrc_bias[kNv];
  float A[kTri], Dinv[kNv];     // M + hD, then its LTDL factor, packed
  union {
    struct {
      float Ic[kNb * 36], F[kNb * 6], bacc[kNb * 6], cdd[kNv * 6],
          xipos[kNb * 3], ipos[kNb * 3], mass[kNb];
    } tree;
    struct {
      float xs[kChain * kLanes];  // one chain solve per lane (column)
      float X[kNe * kJ];          // the connect rows' solves
      float Lam[kNcb * 36];
      float J[kNe * kJ], G[kNe * kNe], Gs[kNe * kNe], Lc[kNe * kNe];
      float err[kNe], dn[kNe], rhs[kNe], lam[kNe], p1[kNe], p2[kNe];
      float lim_f[kNlim];
      float sphere_f[kNcon * 3], sphere_vp[kNcon * 3], pxf[kNcon * 3];
      float Wb[kNcb * 6];
      float vpred[kNv], dv[kNv], qvel2[kNv];
      float q2[kNq], quat[8];
    } sol;
  } u;
};

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

// The two warps of env `slot` of the block meet (named barrier 1 + slot):
// shared memory written before it by either is visible to both after it.
__device__ __forceinline__ void env_sync(int slot) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + slot), "r"(kLanes * kWarpsPerEnv)
               : "memory");
}

__device__ __forceinline__ float dot6(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] +
         a[4] * b[4] + a[5] * b[5];
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

// The solves through the factor, x = (M + hD)^-1 x: the L^T pass, the D
// scaling and the L pass of the generator's `solve`, each x[i] updated by
// the same terms in the same order. The L^T pass runs in pull form: x[i]
// takes its descendants' terms, k descending, once each x[k] is final (the
// push form x[i] -= L[k, i] x[k], k descending, gives the same sums); so
// its inner loop has no store for a load to wait on. The D scaling is kept
// a rounded product of its own (__fmul_rn, never contracted into the L
// pass's first FMA).

// x restricted to a support sup[0..n) that is a chain of the dof tree
// (ascending; every entry an ancestor of the ones after it: a body's path
// to the root, a limit's anc[d] + [d]; n <= kChain), by one lane: x is the
// lane's column of the solve block, entry s (x[kLanes * s]) for dof sup[s].
__device__ void ltdl_solve_chain(const float* L, const float* Dinv, float* x,
                                 const int* sup, int n) {
  for (int s = n - 1; s >= 0; --s) {
    const int i = sup[s];
    float acc = x[kLanes * s];
#pragma unroll 4
    for (int s2 = n - 1; s2 > s; --s2)
      acc = acc - L[tri(sup[s2], i)] * x[kLanes * s2];
    x[kLanes * s] = acc;
  }
  for (int s = 0; s < n; ++s) {
    const int k = sup[s];
    float acc = __fmul_rn(x[kLanes * s], Dinv[k]);
#pragma unroll 4
    for (int s2 = 0; s2 < s; ++s2)
      acc = acc - L[tri(k, sup[s2])] * x[kLanes * s2];
    x[kLanes * s] = acc;
  }
}

// x over all nv dofs, by the warp (lane = dof): the L^T pass from the
// deepest dofs up, the L pass from the root down, a depth of the dof tree
// (a dof's count of ancestors) per step, so that every x[k] a dof reads is
// final.
__device__ void ltdl_solve_warp(const float* L, const float* Dinv, float* x,
                                int nv, int depth, const int* anc_ptr,
                                const int* anc, const int* desc_ptr,
                                const int* desc, int lane) {
  const int level = lane < nv ? anc_ptr[lane + 1] - anc_ptr[lane] : -1;
  for (int l = depth - 1; l >= 0; --l) {
    if (level == l) {
      float acc = x[lane];
#pragma unroll 4
      for (int a = desc_ptr[lane]; a < desc_ptr[lane + 1]; ++a) {
        const int k = desc[a];
        acc = acc - L[tri(k, lane)] * x[k];
      }
      x[lane] = acc;
    }
    __syncwarp();
  }
  for (int l = 0; l < depth; ++l) {
    if (level == l) {
      float acc = __fmul_rn(x[lane], Dinv[lane]);
#pragma unroll 4
      for (int a = anc_ptr[lane]; a < anc_ptr[lane + 1]; ++a) {
        const int i = anc[a];
        acc = acc - L[tri(lane, i)] * x[i];
      }
      x[lane] = acc;
    }
    __syncwarp();
  }
}

// The ne connect rows' solves J_r (M + hD)^-1 over the union of the
// connects' supports (dof mask `mask`), by the warp, in the order of
// `ltdl_solve_warp` for each row: a depth of the dof tree per step (its
// dofs dlvl[dlvl_ptr[l]..dlvl_ptr[l + 1])), lane = one dof of the depth
// and one group of rows (g, g + kRowGroups, ...). Row r of X (stride kJ)
// holds J_r on entry and the solution on exit.
__device__ void ltdl_solve_rows(const float* L, const float* Dinv, float* X,
                                int ne, int depth, unsigned mask,
                                const int* anc_ptr, const int* anc,
                                const int* desc_ptr, const int* desc,
                                const int* dlvl_ptr, const int* dlvl,
                                int lane) {
  constexpr int kPer = (kNe + kRowGroups - 1) / kRowGroups;
  float acc[kPer];
  for (int l = depth - 1; l >= 0; --l) {
    for (int t = kRowGroups * dlvl_ptr[l] + lane;
         t < kRowGroups * dlvl_ptr[l + 1]; t += kLanes) {
      const int d = dlvl[t / kRowGroups], g = t % kRowGroups;
      if (!(mask >> d & 1u)) continue;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (g + kRowGroups * j < ne) acc[j] = X[kJ * (g + kRowGroups * j) + d];
      for (int a = desc_ptr[d]; a < desc_ptr[d + 1]; ++a) {
        const int k = desc[a];
        if (mask >> k & 1u) {
          const float Lkd = L[tri(k, d)];
#pragma unroll
          for (int j = 0; j < kPer; ++j)
            if (g + kRowGroups * j < ne)
              acc[j] = acc[j] - Lkd * X[kJ * (g + kRowGroups * j) + k];
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (g + kRowGroups * j < ne) X[kJ * (g + kRowGroups * j) + d] = acc[j];
    }
    __syncwarp();
  }
  for (int l = 0; l < depth; ++l) {
    for (int t = kRowGroups * dlvl_ptr[l] + lane;
         t < kRowGroups * dlvl_ptr[l + 1]; t += kLanes) {
      const int d = dlvl[t / kRowGroups], g = t % kRowGroups;
      if (!(mask >> d & 1u)) continue;
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (g + kRowGroups * j < ne)
          acc[j] = __fmul_rn(X[kJ * (g + kRowGroups * j) + d], Dinv[d]);
      for (int a = anc_ptr[d]; a < anc_ptr[d + 1]; ++a) {
        const int i = anc[a];
        const float Ldi = L[tri(d, i)];
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (g + kRowGroups * j < ne)
            acc[j] = acc[j] - Ldi * X[kJ * (g + kRowGroups * j) + i];
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        if (g + kRowGroups * j < ne) X[kJ * (g + kRowGroups * j) + d] = acc[j];
    }
    __syncwarp();
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

// FK of body i from its parent's frame (the lane's part of a tree level):
// xpos, xmat and the cdof rows of its joints' dofs
__device__ void fk_body(Scratch& s, int i, const int* body, const int* joint,
                        const float* fbody, const float* fjoint,
                        const float* origin) {
  const int parent = body[4 * i], j0 = body[4 * i + 1],
            nj = body[4 * i + 2], rot_identity = body[4 * i + 3];
  const float* bpos = fbody + 21 * i;
  const float* brot = bpos + 3;
  const float* q = s.q;
  float p[3], R[9];
  if (parent < 0) {
    for (int k = 0; k < 3; ++k) p[k] = bpos[k] - origin[k];
    for (int k = 0; k < 9; ++k) R[k] = brot[k];
  } else {
    const float* Rp = s.xmat + 9 * parent;
    for (int a = 0; a < 3; ++a) p[a] = s.xpos[3 * parent + a];
    for (int k = 0; k < 3; ++k)
      if (bpos[k] != 0.f)
        for (int a = 0; a < 3; ++a) p[a] = p[a] + Rp[3 * a + k] * bpos[k];
    if (rot_identity)
      for (int k = 0; k < 9; ++k) R[k] = Rp[k];
    else
      mat_mul_c(Rp, brot, R);
  }
  float* cdof = s.cdof;
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
        const float sn = sinf(t);
        const float c1 = 1.f - cosf(t);
        for (int k = 0; k < 9; ++k) R[k] = R[k] + sn * RK[k] + c1 * RKK[k];
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
  for (int k = 0; k < 3; ++k) s.xpos[3 * i + k] = p[k];
  for (int k = 0; k < 9; ++k) s.xmat[9 * i + k] = R[k];
}

// The spatial inertia of body i about the origin, [[I - m CC, m C], [-m C,
// m]], into Ic, and its RNEA force I a + v x* I v into F
__device__ void body_force(Scratch& s, int i, float m, const float* fbody) {
  const float* R = s.xmat + 9 * i;
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
  const float* cc = s.u.tree.xipos + 3 * i;
  const float c2 = cc[0] * cc[0] + cc[1] * cc[1] + cc[2] * cc[2];
  const float C3[9] = {0.f, -cc[2], cc[1], cc[2], 0.f, -cc[0],
                       -cc[1], cc[0], 0.f};
  float* A6 = s.u.tree.Ic + 36 * i;
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) {
      const float CC = cc[a] * cc[c] - (a == c ? c2 : 0.f);
      A6[6 * a + c] = Iw[3 * a + c] - m * CC;
      const float mC = m * C3[3 * a + c];
      A6[6 * a + 3 + c] = mC;
      A6[6 * (3 + a) + c] = -mC;
      A6[6 * (3 + a) + 3 + c] = a == c ? m : 0.f;
    }
  const float* v = s.bvel + 6 * i;
  const float* acc = s.u.tree.bacc + 6 * i;
  float Iv[6], Ia[6];
  for (int r = 0; r < 6; ++r) {
    Iv[r] = A6[6 * r] * v[0] + A6[6 * r + 1] * v[1] + A6[6 * r + 2] * v[2] +
            A6[6 * r + 3] * v[3] + A6[6 * r + 4] * v[4] + A6[6 * r + 5] * v[5];
    Ia[r] = A6[6 * r] * acc[0] + A6[6 * r + 1] * acc[1] +
            A6[6 * r + 2] * acc[2] + A6[6 * r + 3] * acc[3] +
            A6[6 * r + 4] * acc[4] + A6[6 * r + 5] * acc[5];
  }
  float c0[3], c1[3], cr[3];
  cross3(v, Iv, c0);
  cross3(v + 3, Iv + 3, c1);
  cross3(v, Iv + 3, cr);
  float* F = s.u.tree.F + 6 * i;
  for (int k = 0; k < 3; ++k) {
    F[k] = Ia[k] + (c0[k] + c1[k]);
    F[3 + k] = Ia[3 + k] + cr[k];
  }
}

__global__ void __launch_bounds__(kThreads)
pd_substep_kernel(const float* __restrict__ qpos_in,
                  const float* __restrict__ qvel_in,
                  const float* __restrict__ cmd,
                  const float* __restrict__ damp_in,
                  const float* __restrict__ mass_in,
                  const float* __restrict__ ipos_in,
                  const float* __restrict__ misc_in,
                  const float* __restrict__ hfield,
                  float* __restrict__ qpos_out, float* __restrict__ qvel_out,
                  float* __restrict__ qacc_out, float* __restrict__ diag_out,
                  const int* __restrict__ itab, const float* __restrict__ ftab,
                  int nitab, int nftab, int B) {
  // the block's scratch, then both tables, copied once: every phase below
  // indexes them, and a table read from L1 costs more than the shared
  // memory around it
  extern __shared__ float4 k1_smem[];
  Scratch* scratch = reinterpret_cast<Scratch*>(k1_smem);
  int* it = reinterpret_cast<int*>(scratch + kEnvsPerBlock);
  float* ft = reinterpret_cast<float*>(it + nitab);
  for (int i = threadIdx.x; i < nitab; i += kThreads) it[i] = itab[i];
  for (int i = threadIdx.x; i < nftab; i += kThreads) ft[i] = ftab[i];
  __syncthreads();
  const int lane = threadIdx.x % kLanes;
  const int slot = threadIdx.x / (kLanes * kWarpsPerEnv);
  const bool connect_warp = threadIdx.x / kLanes % kWarpsPerEnv == 1;
  const int b = blockIdx.x * kEnvsPerBlock + slot;
  if (b >= B) return;  // both warps of the env, before any barrier
  Scratch& s = scratch[slot];
  auto& sol = s.u.sol;
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
  const int* bmask = it + it[O_BMASK];
  const int* desc_ptr = it + it[O_DESC_PTR];
  const int* desc = it + it[O_DESC];
  const int* dlvl_ptr = it + it[O_DLVL_PTR];
  const int* dlvl = it + it[O_DLVL];
  const float* fbody = ft + it[F_BODY];
  const float* fjoint = ft + it[F_JOINT];
  const float* fc = ft + it[F_CONST];
  const float h = fc[0], k_unit = fc[1], b_unit = fc[2], beta_h = fc[3],
              two_h = fc[4], half_h = fc[5];
  const int nmisc = it[HFIELD] ? kMiscRows : kMiscRows - 2;
  const int depth = it[DOF_DEPTH];
  const int neq = it[NEQ];
  const int ne = 3 * neq;
  const int* eq = it + it[O_EQ];
  const int* eqsup = it + it[O_EQSUP];

  // ---- the connect warp: once M + hD is factored and J built, the connect
  // system G = J A^-1 J^T, while the main warp solves for Lambda, the
  // limits, the contacts and the free acceleration; the ne solves by the
  // warp, then G's entries (lane = entry, r <= cl), each summed over
  // connect cl's support in the generator's order
  if (connect_warp) {
    env_sync(slot);
    if (neq > 0) {
      float* X = sol.X;
      for (int t = lane; t < ne * kJ; t += kLanes) X[t] = sol.J[t];
      __syncwarp();
      ltdl_solve_rows(s.A, s.Dinv, X, ne, depth, it[EQU_MASK], anc_ptr, anc,
                      desc_ptr, desc, dlvl_ptr, dlvl, lane);
      for (int t = lane; t < ne * ne; t += kLanes) {
        const int r = t / ne, cl = t % ne;
        if (cl < r) continue;
        const int e = cl / 3;
        const int* csup = eqsup + eq[4 * e + 2];
        const int cn = eq[4 * e + 3];
        float val = 0.f;
#pragma unroll 4
        for (int a = 0; a < cn; ++a)
          val = val + X[kJ * r + csup[a]] * sol.J[kJ * cl + csup[a]];
        sol.G[ne * r + cl] = val;
        sol.G[ne * cl + r] = val;
      }
      __syncwarp();
      // G scaled to a unit diagonal, and its dense Cholesky factor with a
      // pivot floor, column by column (lane = row): none of it needs the
      // main warp's free velocity
      if (lane < ne) sol.dn[lane] = rsqrtf(sol.G[ne * lane + lane] + 1e-12f);
      __syncwarp();
      for (int t = lane; t < ne * ne; t += kLanes) {
        const int r = t / ne, cl = t % ne;
        sol.Gs[t] = sol.dn[r] * sol.G[t] * sol.dn[cl] + (r == cl ? 1e-6f : 0.f);
      }
      __syncwarp();
      for (int j = 0; j < ne; ++j) {
        float sj = sol.Gs[ne * j + j];
        for (int p = 0; p < j; ++p)
          sj = sj - sol.Lc[ne * j + p] * sol.Lc[ne * j + p];
        const float dpv = sqrtf(max_nan(sj, 1e-4f));
        const int i = lane;
        if (i == j) sol.Lc[ne * j + j] = dpv;
        if (i > j && i < ne) {
          float r_ = sol.Gs[ne * i + j];
          for (int p = 0; p < j; ++p)
            r_ = r_ - sol.Lc[ne * i + p] * sol.Lc[ne * j + p];
          sol.Lc[ne * i + j] = r_ / dpv;
        }
        __syncwarp();
      }
    }
    env_sync(slot);
    return;
  }

  for (int i = lane; i < nq; i += kLanes) s.q[i] = ROW(qpos_in, i);
  for (int d = lane; d < nv; d += kLanes) {
    s.qd[d] = ROW(qvel_in, d);
    s.damp[d] = ROW(damp_in, d);
  }
  if (lane < nmisc) s.misc[lane] = ROW(misc_in, lane);
  for (int i = lane; i < nb; i += kLanes) s.u.tree.mass[i] = ROW(mass_in, i);
  for (int i = lane; i < 3 * nb; i += kLanes)
    s.u.tree.ipos[i] = ROW(ipos_in, i);
  __syncwarp();

  // ---- actuation: PD law at the actuated joints, actuator clamp ----
  const int* act = it + it[O_ACT];
  for (int k = lane; k < nu; k += kLanes) {
    const float* fact = ft + it[F_ACT];
    const float pt = ROW(cmd, k), dt = ROW(cmd, nu + k);
    const float pg = ROW(cmd, 2 * nu + k), dg = ROW(cmd, 3 * nu + k);
    const float ff = ROW(cmd, 4 * nu + k);
    const float tau = pg * (pt - s.q[act[2 * k]]) +
                      dg * (dt - s.qd[act[2 * k + 1]]) + ff;
    const float g = fact[3 * k];
    const float u = min_nan(max_nan(tau / g, fact[3 * k + 1]), fact[3 * k + 2]);
    s.act_torque[k] = g * u;
  }
  __syncwarp();
  for (int d = lane; d < nv; d += kLanes) {
    float f = 0.f;
    for (int k = 0; k < nu; ++k)
      if (act[2 * k + 1] == d) f = s.act_torque[k];
    s.qfrc_act[d] = f;
  }

  // ---- tree pass, level by level (lane = body): FK, com, velocities,
  // cdof_dot, RNEA accelerations (qacc = 0, gravity as base acceleration)
  float origin[3] = {0.f, 0.f, 0.f};
  if (it[ROOT_ORIGIN])
    for (int k = 0; k < 3; ++k) origin[k] = s.q[k];
  {
    const int* lvl_ptr = it + it[O_LVL_PTR];
    const int* lvl = it + it[O_LVL];
    for (int l = 0; l < it[NLVL]; ++l) {
      for (int t = lvl_ptr[l] + lane; t < lvl_ptr[l + 1]; t += kLanes) {
        const int i = lvl[t];
        fk_body(s, i, body, joint, fbody, fjoint, origin);
        const float* ip = s.u.tree.ipos + 3 * i;
        const float ip0 = ip[0], ip1 = ip[1], ip2 = ip[2];
        const float* R = s.xmat + 9 * i;
        for (int a = 0; a < 3; ++a)
          s.u.tree.xipos[3 * i + a] = s.xpos[3 * i + a] + R[3 * a] * ip0 +
                                      R[3 * a + 1] * ip1 + R[3 * a + 2] * ip2;
        const int parent = body[4 * i];
        float v[6], acc[6];
        for (int k = 0; k < 6; ++k) {
          v[k] = parent < 0 ? 0.f : s.bvel[6 * parent + k];
          acc[k] = parent < 0 ? fc[6 + k] : s.u.tree.bacc[6 * parent + k];
        }
        for (int e = bdof_ptr[i]; e < bdof_ptr[i + 1]; ++e) {
          const int d = bdof[e];
          const float* m = s.cdof + 6 * d;
          float* cdd = s.u.tree.cdd + 6 * d;
          float c0[3], c1[3], c2[3];
          cross3(v, m, c0);
          cross3(v, m + 3, c1);
          cross3(v + 3, m, c2);
          for (int k = 0; k < 3; ++k) {
            cdd[k] = c0[k];
            cdd[3 + k] = c1[k] + c2[k];
          }
          for (int k = 0; k < 6; ++k) v[k] = v[k] + m[k] * s.qd[d];
        }
        for (int e = bdof_ptr[i]; e < bdof_ptr[i + 1]; ++e) {
          const int d = bdof[e];
          for (int k = 0; k < 6; ++k)
            acc[k] = acc[k] + s.u.tree.cdd[6 * d + k] * s.qd[d];
        }
        for (int k = 0; k < 6; ++k) {
          s.bvel[6 * i + k] = v[k];
          s.u.tree.bacc[6 * i + k] = acc[k];
        }
      }
      __syncwarp();
    }
  }

  // ---- spatial inertias and RNEA body forces (lane = body) ----
  for (int i = lane; i < nb; i += kLanes)
    body_force(s, i, s.u.tree.mass[i], fbody);
  __syncwarp();

  // ---- sums up the tree: RNEA forces and composite inertias (lane = one
  // of their 42 components, children in the serial order)
  for (int c = lane; c < 42; c += kLanes) {
    float* X = c < 36 ? s.u.tree.Ic + c : s.u.tree.F + (c - 36);
    const int stride = c < 36 ? 36 : 6;
    for (int i = nb - 1; i >= 0; --i) {
      const int parent = body[4 * i];
      if (parent >= 0)
        X[stride * parent] = X[stride * parent] + X[stride * i];
    }
  }
  __syncwarp();

  // ---- RNEA bias and CRBA: M + hD at the ancestor pairs (lane = dof) ----
  if (lane < nv) {
    const int d = lane;
    const float* c = s.cdof + 6 * d;
    s.qfrc_bias[d] = dot6(c, s.u.tree.F + 6 * dof_body[d]);
    const float* I = s.u.tree.Ic + 36 * dof_body[d];
    float H[6];
    for (int r = 0; r < 6; ++r)
      H[r] = I[6 * r] * c[0] + I[6 * r + 1] * c[1] + I[6 * r + 2] * c[2] +
             I[6 * r + 3] * c[3] + I[6 * r + 4] * c[4] + I[6 * r + 5] * c[5];
    for (int e = anc_ptr[d]; e <= anc_ptr[d + 1]; ++e) {
      const int w = e < anc_ptr[d + 1] ? anc[e] : d;
      const float* cw = s.cdof + 6 * w;
      s.A[tri(d, w)] = H[0] * cw[0] + H[1] * cw[1] + H[2] * cw[2] +
                       H[3] * cw[3] + H[4] * cw[4] + H[5] * cw[5];
    }
    const float* arm = ft + it[F_ARM];
    s.A[tri(d, d)] = s.A[tri(d, d)] + arm[d] + h * s.damp[d];
  }
  __syncwarp();

  // ---- LTDL of M + hD, in place: A = L^T D L, L in A's strict lower part.
  // Column k: every update A[i, j] -= (A[k, i] / D[k]) A[k, j] reads the
  // unscaled row k; row k is scaled in the next column's step, which
  // neither reads nor writes it. A lane's updates of a column write
  // distinct entries and read none that another writes, so all of their
  // operands are loaded before any store.
  {
    const int* lt_ptr = it + it[O_LTDL_PTR];
    const int* lt = it + it[O_LTDL];
    float* A = s.A;
    float dinv_prev = 0.f;
    for (int k = nv - 1; k >= -1; --k) {
      const float dinv = k >= 0 ? 1.f / max_nan(A[tri(k, k)], 1e-12f) : 0.f;
      for (int e0 = k >= 0 ? lt_ptr[k] : 0; e0 < (k >= 0 ? lt_ptr[k + 1] : 0);
           e0 += 4 * kLanes) {
        int t[4];
        float aij[4], aki[4], akj[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + lane + u * kLanes;
          t[u] = e < lt_ptr[k + 1] ? lt[e] : -1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (t[u] >= 0) {
            aij[u] = A[t[u] & 1023];
            aki[u] = A[t[u] >> 10 & 1023];
            akj[u] = A[t[u] >> 20];
          }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (t[u] >= 0) {
            const float a_ = aki[u] * dinv;
            A[t[u] & 1023] = aij[u] - a_ * akj[u];
          }
      }
      if (k + 1 < nv) {  // scale row k + 1
        const int kp = k + 1;
        for (int e = anc_ptr[kp] + lane; e < anc_ptr[kp + 1]; e += kLanes) {
          const int i = anc[e];
          A[tri(kp, i)] = A[tri(kp, i)] * dinv_prev;
        }
      }
      if (lane == 0 && k >= 0) s.Dinv[k] = dinv;
      dinv_prev = dinv;
      __syncwarp();
    }
  }

  // ---- connect jacobian rows and errors (lane = connect, then dof) ----
  if (lane < neq) {
    const int e = lane;
    const float* feq = ft + it[F_EQ];
    const int b1 = eq[4 * e], b2 = eq[4 * e + 1];
    float a1[3], a2[3];
    matvec_c(s.xmat + 9 * b1, feq + 6 * e, a1);
    matvec_c(s.xmat + 9 * b2, feq + 6 * e + 3, a2);
    for (int a = 0; a < 3; ++a) {
      sol.p1[3 * e + a] = s.xpos[3 * b1 + a] + a1[a];
      sol.p2[3 * e + a] = s.xpos[3 * b2 + a] + a2[a];
    }
    for (int k = 0; k < 3; ++k)
      sol.err[3 * e + k] = sol.p1[3 * e + k] - sol.p2[3 * e + k];
  }
  __syncwarp();
  if (lane < nv) {
    const int d = lane;
    const float* cd = s.cdof + 6 * d;
    for (int e = 0; e < neq; ++e) {
      const int b1 = eq[4 * e], b2 = eq[4 * e + 1];
      float Jd[3] = {0.f, 0.f, 0.f};
      if ((bmask[b1] >> d) & 1) {
        float c1[3];
        cross3(cd, sol.p1 + 3 * e, c1);
        for (int k = 0; k < 3; ++k) Jd[k] = c1[k] + cd[3 + k];
      }
      if ((bmask[b2] >> d) & 1) {
        float c2[3];
        cross3(cd, sol.p2 + 3 * e, c2);
        for (int k = 0; k < 3; ++k) Jd[k] = Jd[k] - (c2[k] + cd[3 + k]);
      }
      for (int k = 0; k < 3; ++k) sol.J[kJ * (3 * e + k) + d] = Jd[k];
    }
  }
  __syncwarp();

  env_sync(slot);  // the connect warp takes over G

  // ---- the restricted solves (lane = one right-hand side), in rounds:
  // Lambda of the contact bodies, S_b A^-1 S_b^T (symmetric), and the
  // limits' effective masses and forces ----
  const int ncon = it[NCON], ncb = it[NCB];
  const int* con = it + it[O_CON];
  const int* cbs = it + it[O_CB];
  {
    const int* task = it + it[O_TASK];
    const int* lim = it + it[O_LIM];
    const int* lsup_ptr = it + it[O_LIMSUP_PTR];
    const int* lsup = it + it[O_LIMSUP];
    const float* flim = ft + it[F_LIM];
    float* x = sol.xs + lane;
    for (int t0 = 0; t0 < it[NTASK]; t0 += kLanes) {
      const int t = t0 + lane;
      if (t < it[NTASK]) {
        const int kind = task[2 * t], idx = task[2 * t + 1];
        const int* sup;
        int n;
        if (kind == kTaskLambda) {
          const int ub = cbs[idx / 6], r = idx % 6;
          sup = banc + banc_ptr[ub];
          n = banc_ptr[ub + 1] - banc_ptr[ub];
          for (int e = 0; e < n; ++e)
            x[kLanes * e] = s.cdof[6 * sup[e] + r];
        } else {  // the limit's dof is the last of its support
          sup = lsup + lsup_ptr[idx];
          n = lsup_ptr[idx + 1] - lsup_ptr[idx];
          for (int e = 0; e < n; ++e) x[kLanes * e] = e == n - 1 ? 1.f : 0.f;
        }
        ltdl_solve_chain(s.A, s.Dinv, x, sup, n);
        if (kind == kTaskLambda) {
          const int r = idx % 6;
          float* Lb = sol.Lam + 36 * (idx / 6);
          for (int cl = r; cl < 6; ++cl) {
            float val = 0.f;
#pragma unroll 4
            for (int e = 0; e < n; ++e)
              val = val + x[kLanes * e] * s.cdof[6 * sup[e] + cl];
            Lb[6 * r + cl] = val;
            Lb[6 * cl + r] = val;
          }
        } else {
          const int d = lim[2 * idx], qadr = lim[2 * idx + 1];
          const float m_eff = 1.f / max_nan(x[kLanes * (n - 1)], 1e-8f);
          const float qj = s.q[qadr], qdj = s.qd[d];
          const float below = flim[2 * idx] - qj;
          const float above = qj - flim[2 * idx + 1];
          const float f_lo = below > 0.f ? m_eff * (k_unit * below - b_unit * qdj) : 0.f;
          const float f_hi = above > 0.f ? m_eff * (k_unit * above + b_unit * qdj) : 0.f;
          sol.lim_f[idx] = max_nan(f_lo, 0.f) - max_nan(f_hi, 0.f);
        }
      }
      __syncwarp();
    }
  }

  // ---- contact forces (plane / tilted floor, or terrain), lane = contact
  const float friction = s.misc[0];
  const float* fq = s.misc + 1;
  const float* fpos = s.misc + 5;
  // terrain of a heightfield model, for this env when it is active
  const bool on_terrain = it[HFIELD] && s.misc[15] > 0.5f;
  if (lane < ncon) {
    const int ci = lane;
    float n_w[3];
    {
      const float uq[3] = {fq[1], fq[2], fq[3]};
      const float vz[3] = {0.f, 0.f, 1.f};
      float uv[3], uuv[3];
      cross3(uq, vz, uv);
      cross3(uq, uv, uuv);
      for (int k = 0; k < 3; ++k) n_w[k] = vz[k] + 2.f * (fq[0] * uv[k] + uuv[k]);
    }
    float floor_p[3];
    for (int k = 0; k < 3; ++k) floor_p[k] = fpos[k] - origin[k];
    const float* fcon = ft + it[F_CON];
    const int cb = con[2 * ci], cidx = con[2 * ci + 1];
    const float* off = fcon + 4 * ci;
    const float radius = off[3];
    const float* R = s.xmat + 9 * cb;
    float p[3];
    for (int a = 0; a < 3; ++a) {
      float t = 0.f;
      for (int k = 0; k < 3; ++k)
        if (off[k] != 0.f) t = t + R[3 * a + k] * off[k];
      p[a] = s.xpos[3 * cb + a] + t;
    }
    float depth_c =
        radius - ((p[0] - floor_p[0]) * n_w[0] + (p[1] - floor_p[1]) * n_w[1] +
                  (p[2] - floor_p[2]) * n_w[2]);
    const float* nc = n_w;
    float n_h[3];
    if (on_terrain) {
      const float cellsz = 2.f * s.misc[14] / (kHfRes - 1);
      const float pw[3] = {p[0] + origin[0], p[1] + origin[1], p[2] + origin[2]};
      float hh, dhdx, dhdy;
      hfield_bilinear(hfield, b, B, fpos, cellsz, pw[0], pw[1], &hh, &dhdx,
                      &dhdy);
      const float hnorm = sqrtf(dhdx * dhdx + dhdy * dhdy + 1.f);
      n_h[0] = -dhdx / hnorm;
      n_h[1] = -dhdy / hnorm;
      n_h[2] = 1.f / hnorm;
      depth_c = radius + (fpos[2] + hh) - pw[2];
      nc = n_h;
    }
    const float* bv = s.bvel + 6 * cb;
    float wxp[3], vp[3];
    cross3(bv, p, wxp);
    for (int k = 0; k < 3; ++k) vp[k] = bv[3 + k] + wxp[k];
    for (int k = 0; k < 3; ++k) sol.sphere_vp[3 * ci + k] = vp[k];

    // G = Phi Lam Phi^T, Phi = [-skew(p) | I], in the generator's steps
    const float* Lb = sol.Lam + 36 * cidx;
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
    float fn = max_nan(m_n * (k_unit * depth_c - b_unit * vn), 0.f);
    fn = depth_c > 0.f ? fn : 0.f;
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
    for (int k = 0; k < 3; ++k) sol.sphere_f[3 * ci + k] = f[k];
    float pxf[3];
    cross3(p, f, pxf);
    for (int k = 0; k < 3; ++k) sol.pxf[3 * ci + k] = pxf[k];
  }
  __syncwarp();
  // wrench on each contact body, its contacts in order (lane = body and
  // component)
  for (int t = lane; t < 6 * ncb; t += kLanes) {
    const int c = t / 6, k = t % 6;
    float w = 0.f;
    for (int ci = 0; ci < ncon; ++ci)
      if (con[2 * ci + 1] == c)
        w = w + (k < 3 ? sol.pxf[3 * ci + k] : sol.sphere_f[3 * ci + k - 3]);
    sol.Wb[t] = w;
  }
  __syncwarp();

  // ---- generalized forces and the free acceleration with implicit
  // damping, springs inline (lane = dof), then the full solve ----
  if (lane < nv) {
    const int d = lane;
    const float* cd = s.cdof + 6 * d;
    float qfrc_con = 0.f;
    for (int c = 0; c < ncb; ++c)
      if ((bmask[cbs[c]] >> d) & 1) {
        const float* W = sol.Wb + 6 * c;
        qfrc_con = qfrc_con + (cd[0] * W[0] + cd[1] * W[1] + cd[2] * W[2] +
                               cd[3] * W[3] + cd[4] * W[4] + cd[5] * W[5]);
      }
    float qfrc_lim = 0.f;
    const int* lim = it + it[O_LIM];
    for (int li = 0; li < it[NLIM]; ++li)
      if (lim[2 * li] == d) qfrc_lim = qfrc_lim + sol.lim_f[li];
    // external wrench on the root body
    float qfrc_ext = 0.f;
    if (bmask[0] & 1u << d) {
      const float* ext = s.misc + 8;
      float xF[3];
      cross3(s.xpos, ext + 3, xF);
      const float w[6] = {ext[0] + xF[0], ext[1] + xF[1], ext[2] + xF[2],
                          ext[3], ext[4], ext[5]};
      qfrc_ext = cd[0] * w[0] + cd[1] * w[1] + cd[2] * w[2] + cd[3] * w[3] +
                 cd[4] * w[4] + cd[5] * w[5];
    }
    const int* spring_qadr = it + it[O_SPRING];
    const float* spring_k = ft + it[F_SPRING];
    float t = -s.qfrc_bias[d] - s.damp[d] * s.qd[d];
    t = t + s.qfrc_act[d];
    if (spring_k[d] != 0.f) t = t + -spring_k[d] * s.q[spring_qadr[d]];
    t = t + qfrc_con;
    t = t + qfrc_lim;
    t = t + qfrc_ext;
    sol.vpred[d] = t;
  }
  __syncwarp();
  ltdl_solve_warp(s.A, s.Dinv, sol.vpred, nv, depth, anc_ptr, anc, desc_ptr,
                  desc, lane);
  if (lane < nv) sol.vpred[lane] = s.qd[lane] + h * sol.vpred[lane];
  __syncwarp();

  // ---- loop-closure (connect) impulses ----
  env_sync(slot);  // G is ready
  if (neq > 0) {
    if (lane < ne) {
      const int r = lane, e = r / 3;
      const int* sup = eqsup + eq[4 * e + 2];
      const int n = eq[4 * e + 3];
      float jv = 0.f;
      for (int a = 0; a < n; ++a)
        jv = jv + sol.J[kJ * r + sup[a]] * sol.vpred[sup[a]];
      sol.rhs[r] = sol.dn[r] * -(jv + beta_h * sol.err[r]);
    }
    __syncwarp();
    // the two triangular solves, by one lane, y and lam in registers
    if (lane == 0) {
      const float* Lc = sol.Lc;
      float y[kNe], lam[kNe];
#pragma unroll
      for (int i = 0; i < kNe; ++i)
        if (i < ne) {
          float r_ = sol.rhs[i];
#pragma unroll
          for (int p = 0; p < i; ++p) r_ = r_ - Lc[ne * i + p] * y[p];
          y[i] = r_ / Lc[ne * i + i];
        }
#pragma unroll
      for (int i = kNe - 1; i >= 0; --i)
        if (i < ne) {
          float r_ = y[i];
#pragma unroll
          for (int p = i + 1; p < kNe; ++p)
            if (p < ne) r_ = r_ - Lc[ne * p + i] * lam[p];
          lam[i] = r_ / Lc[ne * i + i];
        }
#pragma unroll
      for (int r = 0; r < kNe; ++r)
        if (r < ne) sol.lam[r] = sol.dn[r] * lam[r];
    }
    __syncwarp();
    if (lane < nv) {
      const int d = lane;
      float dv = 0.f;
      for (int r = 0; r < ne; ++r) {
        const int e = r / 3;
        if (((bmask[eq[4 * e]] | bmask[eq[4 * e + 1]]) >> d) & 1)
          dv = dv + sol.J[kJ * r + d] * sol.lam[r];
      }
      sol.dv[d] = dv;
    }
    __syncwarp();
    ltdl_solve_warp(s.A, s.Dinv, sol.dv, nv, depth, anc_ptr, anc, desc_ptr,
                    desc, lane);
    if (lane < nv) sol.qvel2[lane] = sol.vpred[lane] + sol.dv[lane];
  } else if (lane < nv) {
    sol.qvel2[lane] = sol.vpred[lane];
  }
  for (int i = lane; i < nq; i += kLanes) sol.q2[i] = s.q[i];
  __syncwarp();

  // ---- integrate qpos (lane = hinge/slide, then ball), write the state --
  {
    const int nlin = it[NLIN];
    const int* lin = it + it[O_LIN];
    const int* ball = it + it[O_BALL];
    for (int t = lane; t < nlin + it[NBALL]; t += kLanes) {
      if (t < nlin) {
        const int d = lin[2 * t], qa = lin[2 * t + 1];
        sol.q2[qa] = s.q[qa] + h * sol.qvel2[d];
        continue;
      }
      const int qa = ball[2 * (t - nlin)], da = ball[2 * (t - nlin) + 1];
      const float om[3] = {sol.qvel2[da], sol.qvel2[da + 1], sol.qvel2[da + 2]};
      const float ang = sqrtf(om[0] * om[0] + om[1] * om[1] + om[2] * om[2]) * h;
      const float half = 0.5f * ang;
      const bool small = ang < 1e-8f;
      const float kf = small ? half_h : sinf(half) * h / ang;
      const float w2 = cosf(half), x2 = om[0] * kf, y2 = om[1] * kf,
                  z2 = om[2] * kf;
      const float w1 = s.q[qa], x1 = s.q[qa + 1], y1 = s.q[qa + 2],
                  z1 = s.q[qa + 3];
      const float o[4] = {w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                          w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                          w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                          w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2};
      const float qn = rsqrtf(o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3]);
      for (int k = 0; k < 4; ++k) sol.q2[qa + k] = o[k] * qn;
    }
  }
  const bool feet = it[FEET];
  const int lf = it[LF], rf = it[RF];
  if (feet && lane < 2) mat2quat(s.xmat + 9 * (lane ? rf : lf), sol.quat + 4 * lane);
  __syncwarp();
  for (int i = lane; i < nq; i += kLanes) ROW(qpos_out, i) = sol.q2[i];
  for (int d = lane; d < nv; d += kLanes) {
    ROW(qvel_out, d) = sol.qvel2[d];
    ROW(qacc_out, d) = (sol.qvel2[d] - s.qd[d]) / h;
  }

  // ---- diagnostic rows (lane = row) ----
  const int* lcon = it + it[O_LCON];
  const int* rcon = it + it[O_RCON];
  for (int r = lane; r < kDiagRows; r += kLanes) {
    float v = 0.f;
    if (r >= 34) {
      if (r - 34 < nu) v = s.act_torque[r - 34];
    } else if (feet) {
      if (r < 2) {
        const int* cs = r ? rcon : lcon;
        for (int e = 0; e < it[r ? NRCON : NLCON]; ++e)
          v = v + sol.sphere_f[3 * cs[e] + 2];
      } else if (r < 8) {
        const int k = (r - 2) % 3;
        v = s.xpos[3 * (r < 5 ? lf : rf) + k] + origin[k];
      } else if (r < 14) {
        const int k = (r - 8) % 3;
        const int* cs = r < 11 ? lcon : rcon;
        v = (sol.sphere_vp[3 * cs[0] + k] + sol.sphere_vp[3 * cs[1] + k]) / 2.f;
      } else if (r < 22) {
        v = sol.quat[r - 14];
      } else {
        const int th[4] = {lcon[0], lcon[1], rcon[0], rcon[1]};
        v = sol.sphere_f[3 * th[(r - 22) / 3] + (r - 22) % 3];
      }
    }
    ROW(diag_out, r) = v;
  }
#undef ROW
}

}  // namespace

// Shared memory of a block for tables of nitab ints and nftab floats, and
// the kernel's limit raised to it.
static cudaError_t k1_smem(int nitab, int nftab, int* bytes) {
  static_assert(kEnvsPerBlock < 16, "one named barrier per env");
  *bytes = static_cast<int>(sizeof(Scratch)) * kEnvsPerBlock +
           4 * (nitab + nftab);
  return cudaFuncSetAttribute(pd_substep_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *bytes);
}

// Launches K1 on `stream`; returns the CUDA error as an int (0 = ok).
extern "C" int apex_pd_substep(const float* qpos, const float* qvel,
                               const float* cmd, const float* damp,
                               const float* mass, const float* ipos,
                               const float* misc, const float* hfield,
                               float* qpos_out,
                               float* qvel_out, float* qacc_out,
                               float* diag_out, const int* itab,
                               const float* ftab, int nitab, int nftab, int B,
                               void* stream) {
  int smem = 0;
  const cudaError_t err = k1_smem(nitab, nftab, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (B + kEnvsPerBlock - 1) / kEnvsPerBlock;
  pd_substep_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      qpos, qvel, cmd, damp, mass, ipos, misc, hfield, qpos_out, qvel_out,
      qacc_out, diag_out, itab, ftab, nitab, nftab, B);
  return static_cast<int>(cudaGetLastError());
}

// K1's launch shape for tables of nitab ints and nftab floats, into
// out[0..4): shared memory bytes per block, envs per block, blocks resident
// per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and envs resident
// per SM; returns the CUDA error as an int (0 = ok).
extern "C" int apex_pd_substep_info(int nitab, int nftab, int* out) {
  int smem = 0;
  cudaError_t err = k1_smem(nitab, nftab, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, pd_substep_kernel, kThreads, smem);
  out[0] = smem;
  out[1] = kEnvsPerBlock;
  out[2] = blocks;
  out[3] = blocks * kEnvsPerBlock;
  return static_cast<int>(err);
}
