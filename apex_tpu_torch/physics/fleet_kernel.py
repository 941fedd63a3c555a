"""K1: one whole PD substep of the fleet, as a CUDA kernel.

Counterpart of `apex_tpu/physics/fleet_kernel.py`, whose Pallas kernel is
straight-line code generated per model (`_gen_kernel`) and runs the whole
0.5 ms substep -- PD law, FK, RNEA, CRBA, the fill-in-free LTDL of M + hD,
penalty contacts, limits, springs, the root wrench, the free-acceleration
solve, the loop-closure impulses, integration and the 44 diagnostic rows --
in one program. Here:

- `pd_substep_plain` is the same math on (B,) rows in plain PyTorch, in the
  phase order and the formula order of `_gen_kernel` (as the JAX package's
  `emulated_pd_substep` runs it);
- `csrc/fleet_kernel.cu` is one fixed CUDA source for any tree model, two
  warps per env with its scratch in shared memory, that reads the model as
  tables (`_k1_tables`) built once per model and loops over them in that
  same order, the lanes over the independent work of each phase (the
  schedule tables of `k1_schedule`, and the dof depths of O_DLVL);
- `pd_substep` takes the plain version for CPU tensors only; for CUDA
  tensors it launches the kernel or raises;
- `partitioned_pd_substep` is K1-part, the JAX package's
  `_partitioned_invoke` (fleet_kernel.py:999): K1 launched by one rank of
  a process group on its local shard of the fleet (`partitioned`). K1 is
  lane-wise, one env per warp pair, so a shard's launch equals the full
  launch's columns bit for bit and needs no source of its own.

Batch-last throughout: qpos (nq, B), qvel (nv, B), cmd rows (5 nu, B)
stacked [p_target; d_target; p_gain; d_gain; ff_torque]. Flat or tilted
ground, and for a model with `enable_hfield` the heightfield branch: each
env's own 32 x 32 terrain table, (1024, B) rows, looked up bilinearly at
every contact sphere, and a per-env `hfield_active` select between the
terrain and the plane.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops import cuda_build
from apex_tpu_torch.physics.engine import (
    BAUMGARTE_BETA,
    HFIELD_RES,
    PhysParams,
    _Structure,
    hfield_bilinear,
)
from apex_tpu_torch.physics.spec import DOF_WIDTH, JointType, PhysModel

DIAG_ROWS = 44
MISC_ROWS = 14
HFIELD_MISC_ROWS = 16     # + hfield_radius, hfield_active

# width (envs) of the last substep through `pd_substep`, on either device:
# under a partition, the rank's local shard (fleet_kernel.py:64-66)
LAST_KERNEL_BATCH = None


# ---------------------------------------------------------------------------
# static metadata
# ---------------------------------------------------------------------------

class _KernelMeta:
    """Tree metadata of the kernel (`apex_tpu/physics/fleet_kernel.py`
    `_KernelMeta`), from the port's `_Structure`."""

    def __init__(self, model: PhysModel):
        st = _Structure.of(model)
        self.st = st
        nv, nb = model.nv, model.nbody
        # ancestor dof lists (ascending, excluding self)
        self.anc = [[w for w in range(d) if st.crba_mask[d, w] > 0]
                    for d in range(nv)]
        # per-body dof list (address order) and body ancestry dofs
        self.body_dofs = []
        for b in range(nb):
            dofs = []
            for jidx in model.body_joints[b]:
                j = model.joints[jidx]
                dofs.extend(range(j.dofadr, j.dofadr + DOF_WIDTH[j.jtype]))
            self.body_dofs.append(dofs)
        self.body_anc = [
            [d for d in range(nv) if st.ancestor_mask[b, d] > 0]
            for b in range(nb)]
        self.dof_body = st.dof_body
        # contact groups (0 = left foot, 1 = right foot)
        self.lcon = [i for i, c in enumerate(model.contacts) if c.group == 0]
        self.rcon = [i for i, c in enumerate(model.contacts) if c.group == 1]
        self.con_bodies = sorted(set(int(c.body) for c in model.contacts))
        # actuator -> dof map
        self.act_dof = [model.joints[a.joint].dofadr for a in model.actuators]
        # the support of each connect's jacobian rows, in the order the
        # generator inserts them (body1's ancestry, then body2's new dofs),
        # and the union of all supports (ancestor-closed)
        self.eq_sup = []
        for eq in model.equalities:
            sup = list(self.body_anc[eq.body1])
            sup += [d for d in self.body_anc[eq.body2] if d not in sup]
            self.eq_sup.append(sup)
        self.eq_union = sorted(set(d for s in self.eq_sup for d in s))
        try:
            self.feet = (model.body_id("left-foot"),
                         model.body_id("right-foot"))
        except (KeyError, ValueError):
            self.feet = None


def meta_of(model: PhysModel) -> _KernelMeta:
    m = model.__dict__.get("_kernel_meta")
    if m is None:
        m = _KernelMeta(model)
        object.__setattr__(model, "_kernel_meta", m)
    return m


def _constants(model: PhysModel) -> Dict[str, float]:
    """The scalar constants of the substep, as the generator derives them
    (Python doubles, rounded to f32 where they meet the rows)."""
    h = float(model.timestep)
    tau_c = float(model.solref_timeconst)
    zeta = float(model.solref_dampratio)
    return dict(h=h, k_unit=1.0 / (tau_c * tau_c * zeta * zeta),
                b_unit=2.0 / tau_c, beta_h=BAUMGARTE_BETA / h,
                two_h=2.0 * h, half_h=0.5 * h)


def misc_rows(model: PhysModel, params: PhysParams, B: int) -> torch.Tensor:
    """(14, B): friction(1) floor_quat(4) floor_pos(3) ext_force(6); for a
    heightfield model (16, B), + hfield_radius(1) hfield_active(1) (the
    JAX package's `_misc_rows`, fleet_kernel.py:928-941)."""
    rows = [params.friction.reshape(1, B), params.floor_quat,
            params.floor_pos, params.ext_force]
    if model.enable_hfield:
        rows += [params.hfield_radius.reshape(1, B),
                 params.hfield_active.reshape(1, B)]
    return torch.cat(rows, dim=0)


def static_rows(model: PhysModel, params: PhysParams
                ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """K1's per-env inputs that stay fixed over a scan: body_ipos as
    (nbody * 3, B) rows, `misc_rows`, and for a heightfield model the
    terrain table as (HFIELD_RES^2, B) rows, row ix * HFIELD_RES + iy (None
    for a flat model). Built once per scan, as `_megakernel_pd_scan` stacks
    its rows once (cassie_sim.py:402-404)."""
    B = params.body_mass.shape[-1]
    hf = (params.hfield.reshape(HFIELD_RES * HFIELD_RES, B).contiguous()
          if model.enable_hfield else None)
    return (params.body_ipos.reshape(model.nbody * 3, B),
            misc_rows(model, params, B), hf)


# ---------------------------------------------------------------------------
# plain version: `_gen_kernel`'s body on (B,) rows
# ---------------------------------------------------------------------------

def pd_substep_plain(model: PhysModel, params: PhysParams, qpos: torch.Tensor,
                     qvel: torch.Tensor, cmd_rows: torch.Tensor
                     ) -> Tuple[torch.Tensor, ...]:
    """One PD substep, K1's math in plain PyTorch. Returns (qpos2 (nq, B),
    qvel2 (nv, B), qacc (nv, B), diag (44, B))."""
    meta = meta_of(model)
    st = meta.st
    nb, nv, nq, nu = model.nbody, model.nv, model.nq, model.nu
    B = qpos.shape[-1]
    k = _constants(model)
    h, k_unit, b_unit = k["h"], k["k_unit"], k["b_unit"]
    grav = np.asarray(model.gravity, dtype=np.float64)
    ipos, misc, hf = static_rows(model, params)

    zero = torch.zeros_like(qpos[0])
    one = torch.ones_like(qpos[0])
    q = list(qpos.unbind(0))
    qd = list(qvel.unbind(0))
    damp = list(params.dof_damping.unbind(0))
    mass = list(params.body_mass.unbind(0))
    fric = misc[0]
    fquat = [misc[1 + i] for i in range(4)]
    fpos = [misc[5 + i] for i in range(3)]
    ext = [misc[8 + i] for i in range(6)]

    def c(x):
        return x * one if isinstance(x, float) else x

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def mat_mul_c(R, C):
        out = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for j in range(3):
                t = None
                for kk in range(3):
                    cc = float(C[kk, j])
                    if cc == 0.0:
                        continue
                    term = R[i][kk] if cc == 1.0 else R[i][kk] * cc
                    t = term if t is None else t + term
                out[i][j] = zero if t is None else t
        return out

    def matvec_c(R, v):
        out = [None] * 3
        for i in range(3):
            t = None
            for kk in range(3):
                cc = float(v[kk])
                if cc == 0.0:
                    continue
                term = R[i][kk] if cc == 1.0 else R[i][kk] * cc
                t = term if t is None else t + term
            out[i] = zero if t is None else t
        return out

    # ---- actuation: PD law at the actuated joints, actuator clamp ----
    act_torque = [zero] * nu
    qfrc_act: List[Optional[torch.Tensor]] = [None] * nv
    for kk, a in enumerate(model.actuators):
        jnt = model.joints[a.joint]
        pt, dt = cmd_rows[kk], cmd_rows[nu + kk]
        pg, dg, ff = cmd_rows[2 * nu + kk], cmd_rows[3 * nu + kk], \
            cmd_rows[4 * nu + kk]
        tau = pg * (pt - q[jnt.qposadr]) + dg * (dt - qd[jnt.dofadr]) + ff
        g = float(st.act_gear[kk])
        u = torch.clamp(tau / g, float(st.act_lo[kk]), float(st.act_hi[kk]))
        act_torque[kk] = g * u
        qfrc_act[meta.act_dof[kk]] = act_torque[kk]

    # ---- forward kinematics ----
    origin = [q[0], q[1], q[2]] if nv >= 3 else [zero] * 3
    xpos: List = [None] * nb
    xmat: List = [None] * nb
    cdof: List = [None] * nv         # 6-lists [ang(3), lin(3)]
    for i in range(nb):
        p = int(model.body_parent[i])
        bp = model.body_pos[i]
        if p == -1:
            pos = [c(float(bp[kk])) - origin[kk] for kk in range(3)]
            C0 = st.body_rot[i]
            R = [[c(float(C0[a, b_])) for b_ in range(3)] for a in range(3)]
        else:
            pos = list(xpos[p])
            for kk in range(3):
                if bp[kk] != 0.0:
                    for a in range(3):
                        pos[a] = pos[a] + xmat[p][a][kk] * float(bp[kk])
            if st.body_rot_identity[i]:
                R = [r[:] for r in xmat[p]]
            else:
                R = mat_mul_c(xmat[p], st.body_rot[i])
        for jidx in model.body_joints[i]:
            j = model.joints[jidx]
            if j.jtype == JointType.SLIDE:
                axis_w = matvec_c(R, np.asarray(j.axis))
                t = q[j.qposadr] - j.ref
                pos = [pos[kk] + axis_w[kk] * t for kk in range(3)]
                cdof[j.dofadr] = [zero, zero, zero] + axis_w
            elif j.jtype == JointType.HINGE:
                axis_w = matvec_c(R, np.asarray(j.axis))
                angle = q[j.qposadr] - j.ref
                K, KK = st.joint_K[jidx]
                RK = mat_mul_c(R, K)
                RKK = mat_mul_c(R, KK)
                s = torch.sin(angle)
                c1 = 1.0 - torch.cos(angle)
                R = [[R[a][b_] + s * RK[a][b_] + c1 * RKK[a][b_]
                      for b_ in range(3)] for a in range(3)]
                neg = [-pos[0], -pos[1], -pos[2]]
                cdof[j.dofadr] = axis_w + cross(axis_w, neg)
            else:  # BALL
                qj = [q[j.qposadr + kk] for kk in range(4)]
                nrm = torch.rsqrt(qj[0] * qj[0] + qj[1] * qj[1]
                                  + qj[2] * qj[2] + qj[3] * qj[3])
                w, x, y, z = [qk * nrm for qk in qj]
                Rq = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                       2 * (x * z + w * y)],
                      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                       2 * (y * z - w * x)],
                      [2 * (x * z - w * y), 2 * (y * z + w * x),
                       1 - 2 * (x * x + y * y)]]
                R = [[R[a][0] * Rq[0][b_] + R[a][1] * Rq[1][b_]
                      + R[a][2] * Rq[2][b_] for b_ in range(3)]
                     for a in range(3)]
                neg = [-pos[0], -pos[1], -pos[2]]
                for kk in range(3):
                    axis_w = [R[0][kk], R[1][kk], R[2][kk]]
                    cdof[j.dofadr + kk] = axis_w + cross(axis_w, neg)
        xpos[i], xmat[i] = pos, R

    # com positions from the per-env (dyn-rand) body_ipos
    xipos = []
    for i in range(nb):
        ip = [ipos[i * 3 + kk] for kk in range(3)]
        xipos.append([xpos[i][a] + xmat[i][a][0] * ip[0]
                      + xmat[i][a][1] * ip[1] + xmat[i][a][2] * ip[2]
                      for a in range(3)])

    # ---- velocity pass: body spatial velocities and cdof_dot ----
    body_vel: List = [None] * nb
    cdof_dot: List = [None] * nv
    for i in range(nb):
        p = int(model.body_parent[i])
        v = [zero] * 6 if p == -1 else list(body_vel[p])
        for d in meta.body_dofs[i]:
            w_, vl = v[:3], v[3:]
            mw, ml = cdof[d][:3], cdof[d][3:]
            cdof_dot[d] = (cross(w_, mw)
                           + [a + b_ for a, b_ in
                              zip(cross(w_, ml), cross(vl, mw))])
            v = [v[kk] + cdof[d][kk] * qd[d] for kk in range(6)]
        body_vel[i] = v

    # ---- spatial inertias about the origin ----
    I_sp: List = [None] * nb
    for i in range(nb):
        I0 = np.asarray(model.body_inertia[i], dtype=np.float64)
        R = xmat[i]
        T = [[None] * 3 for _ in range(3)]
        for a in range(3):
            for b_ in range(3):
                t = 0
                for kk in range(3):
                    if I0[kk, b_] != 0.0:
                        t = t + R[a][kk] * float(I0[kk, b_])
                T[a][b_] = zero if isinstance(t, int) else t
        Iw = [[T[a][0] * R[b_][0] + T[a][1] * R[b_][1] + T[a][2] * R[b_][2]
               for b_ in range(3)] for a in range(3)]
        cc_ = xipos[i]
        c2 = cc_[0] * cc_[0] + cc_[1] * cc_[1] + cc_[2] * cc_[2]
        m = mass[i]
        A6 = [[None] * 6 for _ in range(6)]
        for a in range(3):
            for b_ in range(3):
                CCab = cc_[a] * cc_[b_] - (c2 if a == b_ else 0.0)
                A6[a][b_] = Iw[a][b_] - m * CCab
        C3 = [[zero, -cc_[2], cc_[1]],
              [cc_[2], zero, -cc_[0]],
              [-cc_[1], cc_[0], zero]]
        for a in range(3):
            for b_ in range(3):
                mC = m * C3[a][b_]
                A6[a][3 + b_] = mC
                A6[3 + a][b_] = -mC
        for a in range(3):
            for b_ in range(3):
                A6[3 + a][3 + b_] = m if a == b_ else zero
        I_sp[i] = A6

    def mat6vec(Ai, v):
        return [Ai[r][0] * v[0] + Ai[r][1] * v[1] + Ai[r][2] * v[2]
                + Ai[r][3] * v[3] + Ai[r][4] * v[4] + Ai[r][5] * v[5]
                for r in range(6)]

    # ---- RNEA bias (qacc = 0, gravity as base acceleration) ----
    a0 = [c(0.0)] * 3 + [c(-float(g)) for g in grav]
    body_acc: List = [None] * nb
    for i in range(nb):
        p = int(model.body_parent[i])
        a = a0[:] if p == -1 else list(body_acc[p])
        for d in meta.body_dofs[i]:
            a = [a[kk] + cdof_dot[d][kk] * qd[d] for kk in range(6)]
        body_acc[i] = a
    body_frc: List = [None] * nb
    for i in range(nb):
        Iv = mat6vec(I_sp[i], body_vel[i])
        Ia = mat6vec(I_sp[i], body_acc[i])
        w_, vl = body_vel[i][:3], body_vel[i][3:]
        tau3, F3 = Iv[:3], Iv[3:]
        fcross = ([a + b_ for a, b_ in zip(cross(w_, tau3), cross(vl, F3))]
                  + cross(w_, F3))
        body_frc[i] = [Ia[kk] + fcross[kk] for kk in range(6)]
    F_acc = [list(body_frc[i]) for i in range(nb)]
    for i in reversed(range(nb)):
        p = int(model.body_parent[i])
        if p >= 0:
            for kk in range(6):
                F_acc[p][kk] = F_acc[p][kk] + F_acc[i][kk]
    qfrc_bias = [None] * nv
    for d in range(nv):
        b_ = int(meta.dof_body[d])
        qfrc_bias[d] = (cdof[d][0] * F_acc[b_][0] + cdof[d][1] * F_acc[b_][1]
                        + cdof[d][2] * F_acc[b_][2]
                        + cdof[d][3] * F_acc[b_][3]
                        + cdof[d][4] * F_acc[b_][4]
                        + cdof[d][5] * F_acc[b_][5])

    # ---- CRBA: composite inertias, M at the ancestor pairs ----
    Ic = [[row[:] for row in I_sp[i]] for i in range(nb)]
    for i in reversed(range(nb)):
        p = int(model.body_parent[i])
        if p >= 0:
            for r in range(6):
                for cl in range(6):
                    Ic[p][r][cl] = Ic[p][r][cl] + Ic[i][r][cl]
    A: Dict[Tuple[int, int], torch.Tensor] = {}
    for d in range(nv):
        Hd = mat6vec(Ic[int(meta.dof_body[d])], cdof[d])
        for w_ in meta.anc[d] + [d]:
            A[(d, w_)] = (Hd[0] * cdof[w_][0] + Hd[1] * cdof[w_][1]
                          + Hd[2] * cdof[w_][2] + Hd[3] * cdof[w_][3]
                          + Hd[4] * cdof[w_][4] + Hd[5] * cdof[w_][5])
        A[(d, d)] = (A[(d, d)] + float(model.dof_armature[d])
                     + h * damp[d])

    # ---- sparse LTDL of M + hD (fill-in free on the tree ordering) ----
    Lf: Dict[Tuple[int, int], torch.Tensor] = {}
    Dinv = [None] * nv
    for kk in reversed(range(nv)):
        Dk = torch.clamp(A[(kk, kk)], min=1e-12)
        Dinv[kk] = 1.0 / Dk
        for i in reversed(meta.anc[kk]):
            a_ = A[(kk, i)] * Dinv[kk]
            for j in [i] + list(reversed(meta.anc[i])):
                A[(i, j)] = A[(i, j)] - a_ * A[(kk, j)]
            Lf[(kk, i)] = a_

    def solve(b, out_support=None):
        """x = (M + hD)^-1 b through the factor; None is a structural
        zero; the L pass runs over out_support (ancestor-closed) only."""
        x = list(b)
        for kk in reversed(range(nv)):
            if x[kk] is None:
                continue
            for i in meta.anc[kk]:
                t = Lf[(kk, i)] * x[kk]
                x[i] = -t if x[i] is None else x[i] - t
        for kk in range(nv):
            if x[kk] is not None:
                x[kk] = x[kk] * Dinv[kk]
        ks = range(nv) if out_support is None else out_support
        for kk in ks:
            acc = x[kk]
            for i in meta.anc[kk]:
                if x[i] is not None:
                    t = Lf[(kk, i)] * x[i]
                    acc = -t if acc is None else acc - t
            x[kk] = acc
        if out_support is not None:
            keep = set(out_support)
            x = [x[kk] if kk in keep else None for kk in range(nv)]
        return x

    # ---- contact forces (plane / tilted floor) ----
    uq = [fquat[1], fquat[2], fquat[3]]
    vz = [zero, zero, one]
    uv = cross(uq, vz)
    uuv = cross(uq, uv)
    n_w = [vz[kk] + 2.0 * (fquat[0] * uv[kk] + uuv[kk]) for kk in range(3)]
    floor_p = [fpos[kk] - origin[kk] for kk in range(3)]
    if model.enable_hfield:
        rad_h, act_h = misc[14], misc[15]
        cellsz = 2.0 * rad_h / (HFIELD_RES - 1)

    qfrc_con: List[Optional[torch.Tensor]] = [None] * nv
    ncon = len(model.contacts)
    sphere_f: List = [None] * ncon
    sphere_vp: List = [None] * ncon
    if ncon:
        # per-contact-body spatial inverse inertia S_b A^-1 S_b^T
        Lam = {}
        for ub in meta.con_bodies:
            sup = meta.body_anc[ub]
            ts = []
            for r in range(6):
                b_vec: List[Optional[torch.Tensor]] = [None] * nv
                for d in sup:
                    b_vec[d] = cdof[d][r]
                ts.append(solve(b_vec, out_support=sup))
            Lb = [[None] * 6 for _ in range(6)]
            for r in range(6):
                for cl in range(r, 6):
                    val = 0
                    for d in sup:
                        val = val + ts[r][d] * cdof[d][cl]
                    Lb[r][cl] = val
                    Lb[cl][r] = val
            Lam[ub] = Lb

        def skew_apply(pv, X):
            out = [[None] * 3 for _ in range(3)]
            for jcol in range(3):
                cx = cross(pv, [X[0][jcol], X[1][jcol], X[2][jcol]])
                for r in range(3):
                    out[r][jcol] = cx[r]
            return out

        Wb = {ub: [zero] * 6 for ub in meta.con_bodies}
        for ci, con in enumerate(model.contacts):
            cb = int(con.body)
            p_ = []
            for a in range(3):
                t = 0
                for kk in range(3):
                    if con.offset[kk] != 0.0:
                        t = t + xmat[cb][a][kk] * float(con.offset[kk])
                p_.append(xpos[cb][a] + t)
            depth = float(con.radius) - (
                0 + (p_[0] - floor_p[0]) * n_w[0]
                + (p_[1] - floor_p[1]) * n_w[1]
                + (p_[2] - floor_p[2]) * n_w[2])
            n_c = n_w
            if model.enable_hfield:
                # terrain: depth below the bilinear height along z, normal
                # from the height gradient (fleet_kernel.py:536-547)
                pw = [p_[kk] + origin[kk] for kk in range(3)]
                hh, dhdx, dhdy = hfield_bilinear(hf, fpos, cellsz, pw[0],
                                                 pw[1])
                hnorm = torch.sqrt(dhdx * dhdx + dhdy * dhdy + 1.0)
                n_h = [-dhdx / hnorm, -dhdy / hnorm, 1.0 / hnorm]
                depth_h = float(con.radius) + (fpos[2] + hh) - pw[2]
                hact = act_h > 0.5
                depth = torch.where(hact, depth_h, depth)
                n_c = [torch.where(hact, n_h[kk], n_w[kk])
                       for kk in range(3)]
            bv = body_vel[cb]
            wxp = cross(bv[:3], p_)
            v_p = [bv[3 + kk] + wxp[kk] for kk in range(3)]
            sphere_vp[ci] = v_p

            # G_c = Phi Lam Phi^T, Phi = [-skew(p) | I]
            Lb = Lam[cb]
            Laa = [[Lb[r][cl] for cl in range(3)] for r in range(3)]
            Lal = [[Lb[r][3 + cl] for cl in range(3)] for r in range(3)]
            Lll = [[Lb[3 + r][3 + cl] for cl in range(3)] for r in range(3)]
            PLaa = [[-v for v in row] for row in skew_apply(p_, Laa)]
            PLaaT = [[PLaa[cl][r] for cl in range(3)] for r in range(3)]
            PLaaPT_t = [[-v for v in row] for row in skew_apply(p_, PLaaT)]
            PLaaPT = [[PLaaPT_t[cl][r] for cl in range(3)] for r in range(3)]
            PLal = [[-v for v in row] for row in skew_apply(p_, Lal)]
            G = [[PLaaPT[r][cl] + PLal[r][cl] + PLal[cl][r] + Lll[r][cl]
                  for cl in range(3)] for r in range(3)]

            Gn = [G[r][0] * n_c[0] + G[r][1] * n_c[1] + G[r][2] * n_c[2]
                  for r in range(3)]
            g_n = n_c[0] * Gn[0] + n_c[1] * Gn[1] + n_c[2] * Gn[2]
            m_n = 1.0 / torch.clamp(g_n, min=1e-8)
            vn = dot3(v_p, n_c)
            fn = torch.clamp(m_n * (k_unit * depth - b_unit * vn), min=0.0)
            fn = torch.where(depth > 0, fn, 0.0)

            vt = [v_p[kk] - vn * n_c[kk] for kk in range(3)]
            vt_norm = torch.sqrt(dot3(vt, vt)) + 1e-9
            trG = G[0][0] + G[1][1] + G[2][2]
            m_t = 1.0 / torch.clamp((trG - g_n) / 2.0, min=1e-8)
            f_stick = m_t * vt_norm / k["two_h"]
            ft_mag = torch.minimum(fric * fn, f_stick)
            scale = ft_mag / vt_norm
            f_ = [fn * n_c[kk] - scale * vt[kk] for kk in range(3)]
            sphere_f[ci] = f_

            pxf = cross(p_, f_)
            W = Wb[cb]
            for kk in range(3):
                W[kk] = W[kk] + pxf[kk]
                W[3 + kk] = W[3 + kk] + f_[kk]

        for ub in meta.con_bodies:
            W = Wb[ub]
            for d in meta.body_anc[ub]:
                t = (cdof[d][0] * W[0] + cdof[d][1] * W[1]
                     + cdof[d][2] * W[2] + cdof[d][3] * W[3]
                     + cdof[d][4] * W[4] + cdof[d][5] * W[5])
                qfrc_con[d] = t if qfrc_con[d] is None else qfrc_con[d] + t

    # ---- joint limit forces (diagonal of A^-1 by restricted solves) ----
    qfrc_lim: List[Optional[torch.Tensor]] = [None] * nv
    for li in range(len(st.lim_dof)):
        d = int(st.lim_dof[li])
        b_vec = [None] * nv
        b_vec[d] = one
        xd = solve(b_vec, out_support=meta.anc[d] + [d])
        m_eff = 1.0 / torch.clamp(xd[d], min=1e-8)
        qj = q[int(st.lim_qadr[li])]
        qdj = qd[d]
        below = float(st.lim_lo[li]) - qj
        above = qj - float(st.lim_hi[li])
        f_lo = torch.where(below > 0,
                           m_eff * (k_unit * below - b_unit * qdj), 0.0)
        f_hi = torch.where(above > 0,
                           m_eff * (k_unit * above + b_unit * qdj), 0.0)
        f_ = torch.clamp(f_lo, min=0.0) - torch.clamp(f_hi, min=0.0)
        qfrc_lim[d] = f_ if qfrc_lim[d] is None else qfrc_lim[d] + f_

    # ---- springs ----
    qfrc_spring: List[Optional[torch.Tensor]] = [None] * nv
    for d in range(nv):
        k_ = float(st.spring_k[d])
        if k_ != 0.0:
            qfrc_spring[d] = -k_ * q[int(st.spring_qadr[d])]

    # ---- external wrench on the root body ----
    qfrc_ext: List[Optional[torch.Tensor]] = [None] * nv
    tau3, F3 = ext[:3], ext[3:]
    xF = cross(xpos[0], F3)
    w_ext = [tau3[kk] + xF[kk] for kk in range(3)] + F3
    for d in meta.body_anc[0]:
        qfrc_ext[d] = (cdof[d][0] * w_ext[0] + cdof[d][1] * w_ext[1]
                       + cdof[d][2] * w_ext[2] + cdof[d][3] * w_ext[3]
                       + cdof[d][4] * w_ext[4] + cdof[d][5] * w_ext[5])

    # ---- free acceleration with implicit damping ----
    rhs = [None] * nv
    for d in range(nv):
        t = -qfrc_bias[d] - damp[d] * qd[d]
        for src in (qfrc_act[d], qfrc_spring[d], qfrc_con[d], qfrc_lim[d],
                    qfrc_ext[d]):
            if src is not None:
                t = t + src
        rhs[d] = t
    qacc_free = solve(rhs)
    v_pred = [qd[d] + h * qacc_free[d] for d in range(nv)]

    # ---- loop-closure (connect) impulses ----
    if model.equalities:
        ne = 3 * len(model.equalities)
        J: List[Dict[int, torch.Tensor]] = []
        err: List[torch.Tensor] = []
        for eq in model.equalities:
            b1, b2 = eq.body1, eq.body2
            a1 = matvec_c(xmat[b1], np.asarray(eq.anchor1))
            a2 = matvec_c(xmat[b2], np.asarray(eq.anchor2))
            p1 = [xpos[b1][a] + a1[a] for a in range(3)]
            p2 = [xpos[b2][a] + a2[a] for a in range(3)]
            err.extend([p1[kk] - p2[kk] for kk in range(3)])
            rows = [dict(), dict(), dict()]
            for d in meta.body_anc[b1]:
                c1 = cross(cdof[d][:3], p1)
                for kk in range(3):
                    rows[kk][d] = c1[kk] + cdof[d][3 + kk]
            for d in meta.body_anc[b2]:
                c2 = cross(cdof[d][:3], p2)
                for kk in range(3):
                    v = c2[kk] + cdof[d][3 + kk]
                    rows[kk][d] = rows[kk].get(d, zero) - v
            J.extend(rows)

        tsol = []
        for krow in range(ne):
            b_vec = [None] * nv
            for d, v in J[krow].items():
                b_vec[d] = v
            tsol.append(solve(b_vec, out_support=meta.eq_union))
        G = [[None] * ne for _ in range(ne)]
        for r in range(ne):
            for cl in range(r, ne):
                val = 0
                for d, v in J[cl].items():
                    val = val + tsol[r][d] * v
                G[r][cl] = val
                G[cl][r] = val

        dnorm = [torch.rsqrt(G[r][r] + 1e-12) for r in range(ne)]
        Gs = [[dnorm[r] * G[r][cl] * dnorm[cl] + (1e-6 if r == cl else 0.0)
               for cl in range(ne)] for r in range(ne)]
        rhs_s = []
        for r in range(ne):
            jv = 0
            for d in J[r]:
                jv = jv + J[r][d] * v_pred[d]
            rhs_s.append(dnorm[r] * -(jv + k["beta_h"] * err[r]))

        # dense Cholesky with a pivot floor
        Lc = [[None] * ne for _ in range(ne)]
        for jcol in range(ne):
            s = Gs[jcol][jcol]
            for p_ in range(jcol):
                s = s - Lc[jcol][p_] * Lc[jcol][p_]
            dpv = torch.sqrt(torch.clamp(s, min=1e-4))
            Lc[jcol][jcol] = dpv
            for i in range(jcol + 1, ne):
                r_ = Gs[i][jcol]
                for p_ in range(jcol):
                    r_ = r_ - Lc[i][p_] * Lc[jcol][p_]
                Lc[i][jcol] = r_ / dpv
        y = [None] * ne
        for i in range(ne):
            r_ = rhs_s[i]
            for p_ in range(i):
                r_ = r_ - Lc[i][p_] * y[p_]
            y[i] = r_ / Lc[i][i]
        lam = [None] * ne
        for i in reversed(range(ne)):
            r_ = y[i]
            for p_ in range(i + 1, ne):
                r_ = r_ - Lc[p_][i] * lam[p_]
            lam[i] = r_ / Lc[i][i]
        lam = [dnorm[r] * lam[r] for r in range(ne)]

        jt_lam: List[Optional[torch.Tensor]] = [None] * nv
        for r in range(ne):
            for d, v in J[r].items():
                t = v * lam[r]
                jt_lam[d] = t if jt_lam[d] is None else jt_lam[d] + t
        dv = solve(jt_lam)
        new_qvel = [v_pred[d] + (dv[d] if dv[d] is not None else zero)
                    for d in range(nv)]
    else:
        new_qvel = v_pred

    qacc = [(new_qvel[d] - qd[d]) / h for d in range(nv)]

    # ---- integrate qpos ----
    new_q = list(q)
    for idx in range(len(st.lin_dof)):
        d = int(st.lin_dof[idx])
        qa = int(st.lin_qadr[idx])
        new_q[qa] = q[qa] + h * new_qvel[d]
    for qadr, dofadr in st.balls:
        quat = [q[qadr + kk] for kk in range(4)]
        om = [new_qvel[dofadr + kk] for kk in range(3)]
        ang = torch.sqrt(om[0] * om[0] + om[1] * om[1] + om[2] * om[2]) * h
        half = 0.5 * ang
        small = ang < 1e-8
        kf = torch.where(small, k["half_h"],
                         torch.sin(half) * h / torch.where(small, 1.0, ang))
        dq = [torch.cos(half)] + [om[kk] * kf for kk in range(3)]
        w1, x1, y1, z1 = quat
        w2, x2, y2, z2 = dq
        out_q = [w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                 w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                 w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                 w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2]
        qn = torch.rsqrt(out_q[0] * out_q[0] + out_q[1] * out_q[1]
                         + out_q[2] * out_q[2] + out_q[3] * out_q[3])
        for kk in range(4):
            new_q[qadr + kk] = out_q[kk] * qn

    # ---- diagnostic rows ----
    diag = [zero] * DIAG_ROWS
    if meta.feet is not None and meta.lcon and meta.rcon:
        lf, rf = meta.feet
        diag[0] = _sum_rows([sphere_f[i][2] for i in meta.lcon])
        diag[1] = _sum_rows([sphere_f[i][2] for i in meta.rcon])
        for kk in range(3):
            diag[2 + kk] = xpos[lf][kk] + origin[kk]
            diag[5 + kk] = xpos[rf][kk] + origin[kk]
        for kk in range(3):
            diag[8 + kk] = (sphere_vp[meta.lcon[0]][kk]
                            + sphere_vp[meta.lcon[1]][kk]) / 2.0
            diag[11 + kk] = (sphere_vp[meta.rcon[0]][kk]
                             + sphere_vp[meta.rcon[1]][kk]) / 2.0
        ql, qr = _mat2quat_rows(xmat[lf]), _mat2quat_rows(xmat[rf])
        for kk in range(4):
            diag[14 + kk] = ql[kk]
            diag[18 + kk] = qr[kk]
        th = [meta.lcon[0], meta.lcon[1], meta.rcon[0], meta.rcon[1]]
        for s_, ci in enumerate(th):
            for kk in range(3):
                diag[22 + 3 * s_ + kk] = sphere_f[ci][kk]
    for kk in range(min(nu, 10)):
        diag[34 + kk] = act_torque[kk]

    return (torch.stack(new_q), torch.stack(new_qvel), torch.stack(qacc),
            torch.stack(diag))


# ---------------------------------------------------------------------------
# the bound K1 is held to against its plain version
# ---------------------------------------------------------------------------

# diag rows holding contact forces: foot_frc_z (0:2), toe_heel_force (22:34)
FORCE_DIAG_ROWS = [0, 1] + list(range(22, 34))


def plain_spread(model: PhysModel, params: PhysParams, qpos: torch.Tensor,
                 qvel: torch.Tensor, cmd_rows: torch.Tensor,
                 gen: torch.Generator, draws: int = 3):
    """`pd_substep_plain`'s outputs, and for each output the largest
    change of every element when qpos and qvel change by random factors
    1 +- 1e-7 (f32 rounding of the inputs), over `draws` draws. `gen` is a
    CPU generator."""
    base = pd_substep_plain(model, params, qpos, qvel, cmd_rows)
    spread = [torch.zeros_like(x) for x in base]
    for _ in range(draws):
        jitter = lambda x: x * (1.0 + 1e-7 * (torch.randint(
            0, 2, x.shape, generator=gen) * 2.0 - 1.0).to(x.device))
        out = pd_substep_plain(model, params, jitter(qpos), jitter(qvel),
                               cmd_rows)
        spread = [torch.maximum(e, (o - b).abs())
                  for e, o, b in zip(spread, out, base)]
    return base, spread


def kernel_bounds(ref, spread):
    """Elementwise bounds on |K1 - plain| for (qpos, qvel, qacc, diag),
    given the plain outputs `ref` and their `plain_spread`.

    The kinematic diag rows: 1e-5 absolute plus 1e-5 relative (f32
    rounding of FK; FMA contraction and CUDA's sinf/rsqrtf within 2 ulp).
    qvel, qacc and the contact-force rows: 4x the row's largest spread over
    the envs, plus 1e-6 of the element's magnitude. The solves through
    M + hD amplify rounding unevenly across dofs, and the kernel rounds
    inside the factorisation, which input changes reach unevenly across
    envs: taken per env or per element, the spread understates the
    kernel's difference by up to 2.5x and 40x (H100), so the row is the
    unit. A fleet of calm envs therefore gets a tight bound, one chaotic
    env a loose one for its whole row. qpos: the larger of the kinematic
    bound and the spread bound, since its integration step carries h times
    the velocity error."""
    def loose(r, e):
        return 4 * e.amax(1, keepdim=True) + 1e-6 * (1.0 + r.abs())

    strict = [1e-5 + 1e-5 * r.abs() for r in ref]
    bq = torch.maximum(strict[0], loose(ref[0], spread[0]))
    bd = strict[3].clone()
    bd[FORCE_DIAG_ROWS] = loose(ref[3][FORCE_DIAG_ROWS],
                                spread[3][FORCE_DIAG_ROWS])
    return (bq, loose(ref[1], spread[1]), loose(ref[2], spread[2]), bd)


def _sum_rows(rows):
    """Python's sum of a list of rows (0 + r0 + r1 + ...), in order."""
    t = 0
    for r in rows:
        t = t + r
    return t


def _mat2quat_rows(Rm):
    """Branch-free max-trace rotation -> unit quaternion (w >= 0) on rows,
    the generator's `mat2quat`."""
    m00, m01, m02 = Rm[0]
    m10, m11, m12 = Rm[1]
    m20, m21, m22 = Rm[2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) / 2.0
    q0 = [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
          (m10 - m01) / (4 * qw0)]
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2.0
    q1 = [(m21 - m12) / s1, s1 / 4.0, (m01 + m10) / s1, (m02 + m20) / s1]
    s2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 2.0
    q2 = [(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4.0, (m12 + m21) / s2]
    s3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 2.0
    q3 = [(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, s3 / 4.0]
    c0 = tr > 0.0
    c1 = (m00 >= m11) & (m00 >= m22)
    c2 = m11 >= m22
    qq = [torch.where(c0, q0[kk],
                      torch.where(c1, q1[kk], torch.where(c2, q2[kk],
                                                          q3[kk])))
          for kk in range(4)]
    qn = torch.rsqrt(qq[0] * qq[0] + qq[1] * qq[1] + qq[2] * qq[2]
                     + qq[3] * qq[3])
    qq = [v * qn for v in qq]
    neg = qq[0] < 0
    return [torch.where(neg, -v, v) for v in qq]


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

# Header of the int table: scalars, then the start of every section of the
# int table (O_*) and of the float table (F_*). The order is the enum of
# csrc/fleet_kernel.cu and must stay the same.
_HEADER = (
    "NB", "NV", "NQ", "NU", "NCON", "NCB", "NEQ", "NLIM", "NLIN", "NBALL",
    "ROOT_ORIGIN", "FEET", "LF", "RF", "NLCON", "NRCON", "NEQU", "HFIELD",
    "NLVL", "NTASK", "DOF_DEPTH", "EQU_MASK", "O_BODY", "O_JOINT",
    "O_ANC_PTR", "O_ANC", "O_BANC_PTR", "O_BANC", "O_BDOF_PTR", "O_BDOF",
    "O_DOFBODY", "O_CON", "O_CB", "O_LIM", "O_LIMSUP_PTR", "O_LIMSUP",
    "O_SPRING", "O_LIN", "O_BALL", "O_ACT", "O_EQ", "O_EQSUP", "O_EQU",
    "O_LCON", "O_RCON", "O_LVL_PTR", "O_LVL", "O_DLVL_PTR", "O_DLVL",
    "O_DESC_PTR", "O_DESC", "O_LTDL_PTR", "O_LTDL", "O_TASK", "O_BMASK",
    "F_BODY", "F_JOINT", "F_ARM", "F_CON", "F_LIM", "F_SPRING", "F_ACT",
    "F_EQ", "F_CONST",
)
# capacity of the kernel's per-env scratch in shared memory
# (csrc/fleet_kernel.cu); nv is also the warp's 32 lanes
_LIMITS = dict(nbody=32, nv=32, nq=40, nu=16, ncon=32, ncb=16, neq=4,
               nlim=32, chain=16)
# the kinds of the one-lane restricted solves of the O_TASK table
TASK_LAMBDA, TASK_LIMIT = 0, 1


def k1_schedule(model: PhysModel):
    """The lane schedule of the kernel's main warp, from the tree (the
    O_LVL, O_LTDL and O_TASK tables of `_k1_tables`):

    - `levels`: the bodies at each depth of the tree, ascending; a level's
      bodies are the lanes of one tree step, after all of their parents;
    - `ltdl`: per column k of the LTDL, in the serial loop's order, the
      updates (i, j) of A[i, j] by row k: i in anc[k] descending, then j in
      [i] + anc[i] descending; the lanes of column k (the table packs each
      as tri(i, j) | tri(k, i) << 10 | tri(k, j) << 20);
    - `tasks`: the one-lane restricted solves as (kind, index, support): 6
      per contact body (index 6 c + r, row r of Lambda over the body's
      ancestry), one per limit (anc[d] + [d]), both chains of the dof tree;
      heaviest first, so that each round of 32 lanes holds solves of like
      length. (The connect rows' solves run on the env's second warp, lane
      = a dof of one depth and a group of rows.)
    """
    meta = meta_of(model)
    st = meta.st
    depth = [0] * model.nbody
    for i in range(model.nbody):
        p = int(model.body_parent[i])
        depth[i] = 0 if p < 0 else depth[p] + 1
    levels = [[i for i in range(model.nbody) if depth[i] == lv]
              for lv in range(max(depth, default=-1) + 1)]
    ltdl = [[(i, j) for i in reversed(meta.anc[k])
             for j in [i] + list(reversed(meta.anc[i]))]
            for k in range(model.nv)]
    cost = lambda sup: sum(1 + 2 * len(meta.anc[k]) for k in sup)
    tasks = [(TASK_LAMBDA, 6 * c + r, meta.body_anc[ub])
             for c, ub in enumerate(meta.con_bodies) for r in range(6)]
    tasks += [(TASK_LIMIT, li, meta.anc[int(d)] + [int(d)])
              for li, d in enumerate(st.lim_dof)]
    tasks.sort(key=lambda t: -cost(t[2]))
    return levels, ltdl, tasks


def _tri(d: int, w: int) -> int:
    """Offset of entry (d, w), w <= d, in the packed lower triangle."""
    return d * (d + 1) // 2 + w


def _bits(dofs) -> int:
    """The int32 bit pattern of a set of dofs (nv <= 32)."""
    return int(np.uint32(sum(1 << d for d in dofs)).view(np.int32))


def _k1_tables(model: PhysModel, device: torch.device):
    """(itab int32, ftab float32) describing the model to the kernel;
    layout in csrc/fleet_kernel.cu. Built once per model and device."""
    cache = model.__dict__.setdefault("_k1_tables", {})
    if device in cache:
        return cache[device]
    meta = meta_of(model)
    st = meta.st
    nb, nv = model.nbody, model.nv
    sizes = dict(nbody=nb, nv=nv, nq=model.nq, nu=model.nu,
                 ncon=len(model.contacts), ncb=len(meta.con_bodies),
                 neq=len(model.equalities), nlim=len(st.lim_dof),
                 chain=max([len(meta.body_anc[b]) for b in meta.con_bodies]
                           + [len(meta.anc[int(d)]) + 1 for d in st.lim_dof],
                           default=0))
    over = {k: v for k, v in sizes.items() if v > _LIMITS[k]}
    if over:
        raise ValueError(f"model exceeds the kernel's capacity {_LIMITS}: "
                         f"{over}")
    hdr = dict(
        NB=nb, NV=nv, NQ=model.nq, NU=model.nu, NCON=len(model.contacts),
        NCB=len(meta.con_bodies), NEQ=len(model.equalities),
        NLIM=len(st.lim_dof), NLIN=len(st.lin_dof), NBALL=len(st.balls),
        ROOT_ORIGIN=int(nv >= 3),
        FEET=int(meta.feet is not None and bool(meta.lcon)
                 and bool(meta.rcon)),
        LF=meta.feet[0] if meta.feet else 0,
        RF=meta.feet[1] if meta.feet else 0,
        NLCON=len(meta.lcon), NRCON=len(meta.rcon),
        NEQU=len(meta.eq_union), HFIELD=int(model.enable_hfield),
        DOF_DEPTH=1 + max((len(a) for a in meta.anc), default=-1),
        EQU_MASK=_bits(meta.eq_union))
    levels, ltdl, tasks = k1_schedule(model)
    hdr.update(NLVL=len(levels), NTASK=len(tasks))
    ints: List[int] = [0] * len(_HEADER)
    floats: List[float] = []

    def isec(name, values):
        hdr[name] = len(ints)
        ints.extend(int(v) for v in values)

    def fsec(name, values):
        hdr[name] = len(floats)
        floats.extend(float(v) for v in values)

    def csr(lists):
        ptr = [0]
        for lst in lists:
            ptr.append(ptr[-1] + len(lst))
        return ptr, [v for lst in lists for v in lst]

    jstart = np.cumsum([0] + [len(bj) for bj in model.body_joints])
    isec("O_BODY", [v for i in range(nb) for v in (
        model.body_parent[i], jstart[i], len(model.body_joints[i]),
        st.body_rot_identity[i])])
    isec("O_JOINT", [v for j in model.joints
                     for v in (int(j.jtype), j.qposadr, j.dofadr, 0)])
    for name, lists in (("ANC", meta.anc), ("BANC", meta.body_anc),
                        ("BDOF", meta.body_dofs),
                        ("LIMSUP", [meta.anc[int(d)] + [int(d)]
                                    for d in st.lim_dof])):
        ptr, flat = csr(lists)
        isec(f"O_{name}_PTR", ptr)
        isec(f"O_{name}", flat)
    isec("O_DOFBODY", meta.dof_body)
    cb_index = {b: i for i, b in enumerate(meta.con_bodies)}
    isec("O_CON", [v for c in model.contacts
                   for v in (c.body, cb_index[int(c.body)])])
    isec("O_CB", meta.con_bodies)
    isec("O_LIM", [v for d, qa in zip(st.lim_dof, st.lim_qadr)
                   for v in (d, qa)])
    isec("O_SPRING", st.spring_qadr)
    isec("O_LIN", [v for d, qa in zip(st.lin_dof, st.lin_qadr)
                   for v in (d, qa)])
    isec("O_BALL", [v for qa, da in st.balls for v in (qa, da)])
    isec("O_ACT", [v for a in model.actuators
                   for v in (model.joints[a.joint].qposadr,
                             model.joints[a.joint].dofadr)])
    eq_ptr, eq_flat = csr(meta.eq_sup)
    isec("O_EQ", [v for e, eq in enumerate(model.equalities)
                  for v in (eq.body1, eq.body2, eq_ptr[e],
                            len(meta.eq_sup[e]))])
    isec("O_EQSUP", eq_flat)
    isec("O_EQU", meta.eq_union)
    isec("O_LCON", meta.lcon)
    isec("O_RCON", meta.rcon)
    ptr, flat = csr(levels)
    isec("O_LVL_PTR", ptr)
    isec("O_LVL", flat)
    ptr, flat = csr([[d for d in range(nv) if len(meta.anc[d]) == lv]
                     for lv in range(hdr["DOF_DEPTH"])])
    isec("O_DLVL_PTR", ptr)
    isec("O_DLVL", flat)
    ptr, flat = csr([sorted((k for k in range(nv) if d in meta.anc[k]),
                            reverse=True) for d in range(nv)])
    isec("O_DESC_PTR", ptr)
    isec("O_DESC", flat)
    ptr, _ = csr(ltdl)
    isec("O_LTDL_PTR", ptr)
    isec("O_LTDL", [_tri(i, j) | _tri(k, i) << 10 | _tri(k, j) << 20
                    for k in range(nv) for i, j in ltdl[k]])
    isec("O_TASK", [v for kind, idx, _ in tasks for v in (kind, idx)])
    # dof bit masks of the body ancestries, as int32 bit patterns
    isec("O_BMASK", [_bits(meta.body_anc[b]) for b in range(nb)])

    fsec("F_BODY", [v for i in range(nb) for v in (
        *model.body_pos[i], *st.body_rot[i].reshape(-1),
        *np.asarray(model.body_inertia[i]).reshape(-1))])
    fsec("F_JOINT", [v for jidx, j in enumerate(model.joints) for v in (
        *j.axis, j.ref, *st.joint_K[jidx][0].reshape(-1),
        *st.joint_K[jidx][1].reshape(-1))])
    fsec("F_ARM", model.dof_armature)
    fsec("F_CON", [v for c in model.contacts for v in (*c.offset, c.radius)])
    fsec("F_LIM", [v for lo, hi in zip(st.lim_lo, st.lim_hi)
                   for v in (lo, hi)])
    fsec("F_SPRING", st.spring_k)
    fsec("F_ACT", [v for g, lo, hi in zip(st.act_gear, st.act_lo, st.act_hi)
                   for v in (g, lo, hi)])
    fsec("F_EQ", [v for eq in model.equalities
                  for v in (*eq.anchor1, *eq.anchor2)])
    k = _constants(model)
    grav = np.asarray(model.gravity, dtype=np.float64)
    fsec("F_CONST", [k["h"], k["k_unit"], k["b_unit"], k["beta_h"],
                     k["two_h"], k["half_h"], 0.0, 0.0, 0.0, *(-grav)])
    for i, name in enumerate(_HEADER):
        ints[i] = int(hdr[name])
    itab = torch.tensor(ints, dtype=torch.int32, device=device)
    ftab = torch.tensor(np.asarray(floats, np.float32), device=device)
    cache[device] = (itab, ftab)
    return itab, ftab


def pd_substep(model: PhysModel, params: PhysParams, qpos: torch.Tensor,
               qvel: torch.Tensor, cmd_rows: torch.Tensor, static=None
               ) -> Tuple[torch.Tensor, ...]:
    """One PD substep of the fleet: the CUDA kernel for CUDA tensors,
    `pd_substep_plain` for CPU tensors. `static` is `static_rows(model,
    params)`, passed by a scan that builds it once; None builds it here.
    A heightfield model runs the kernel's heightfield branch (or raises).
    Returns (qpos2, qvel2, qacc, diag (44, B))."""
    global LAST_KERNEL_BATCH
    LAST_KERNEL_BATCH = qpos.shape[-1]
    if qpos.device.type == "cpu":
        return pd_substep_plain(model, params, qpos, qvel, cmd_rows)
    if qpos.device.type != "cuda":
        raise ValueError(f"pd_substep: unsupported device {qpos.device}")
    nb, nv, nq, nu = model.nbody, model.nv, model.nq, model.nu
    B = qpos.shape[-1]
    ipos, misc, hf = static_rows(model, params) if static is None else static
    ins = (("qpos", qpos, (nq, B)), ("qvel", qvel, (nv, B)),
           ("cmd_rows", cmd_rows, (5 * nu, B)),
           ("dof_damping", params.dof_damping, (nv, B)),
           ("body_mass", params.body_mass, (nb, B)),
           ("body_ipos", ipos, (nb * 3, B)),
           ("misc", misc, (HFIELD_MISC_ROWS if model.enable_hfield
                           else MISC_ROWS, B)))
    if model.enable_hfield:
        ins += (("hfield", hf, (HFIELD_RES * HFIELD_RES, B)),)
    for name, x, shape in ins:
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous() or x.device != qpos.device:
            raise ValueError(
                f"pd_substep: {name} must be a contiguous float32 {shape} "
                f"tensor on {qpos.device}, got {x.dtype} {tuple(x.shape)} "
                f"contiguous={x.is_contiguous()} on {x.device}")
    itab, ftab = _k1_tables(model, qpos.device)
    new = lambda rows: torch.empty((rows, B), dtype=qpos.dtype,
                                   device=qpos.device)
    outs = (new(nq), new(nv), new(nv), new(DIAG_ROWS))
    lib = cuda_build.library()
    err = lib.apex_pd_substep(
        *(x.data_ptr() for _, x, _ in ins[:7]),
        hf.data_ptr() if model.enable_hfield else None,
        *(o.data_ptr() for o in outs), itab.data_ptr(), ftab.data_ptr(),
        itab.numel(), ftab.numel(), B,
        torch.cuda.current_stream(qpos.device).cuda_stream)
    cuda_build.check(err, "apex_pd_substep")
    pd_substep.launches += 1
    pd_substep.hfield_launches += int(model.enable_hfield)
    return outs


@dataclasses.dataclass(frozen=True)
class Partition:
    """A fleet of `global_batch` envs split evenly over the `world` ranks
    of a process group: each rank steps `global_batch // world` of them."""
    world: int
    global_batch: int

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.world


_PARTITION: Optional[Partition] = None


@contextlib.contextmanager
def partitioned(world: int, global_batch: int):
    """Within the block, the megakernel PD scan runs on this rank's shard
    of a fleet of `global_batch` envs split over `world` ranks, through
    `partitioned_pd_substep`. Partitions do not nest: the JAX package's
    Manual-axis guard (cassie_sim.py:362-367) keeps a scan inside
    shard_map from being split again."""
    global _PARTITION
    if _PARTITION is not None:
        raise RuntimeError(f"the fleet is already partitioned: "
                           f"{_PARTITION}")
    if global_batch % world:
        raise ValueError(f"{global_batch} envs do not split evenly over "
                         f"{world} ranks")
    _PARTITION = Partition(world, global_batch)
    try:
        yield _PARTITION
    finally:
        _PARTITION = None


def active_partition() -> Optional[Partition]:
    """The partition the PD scan runs under, or None."""
    return _PARTITION


def partitioned_pd_substep(model: PhysModel, params: PhysParams,
                           qpos: torch.Tensor, qvel: torch.Tensor,
                           cmd_rows: torch.Tensor, static=None
                           ) -> Tuple[torch.Tensor, ...]:
    """K1-part: inside `partitioned`, one K1 launch on this rank's shard,
    counted apart (and as a K1 launch). The shard must be the partition's
    `local_batch` envs wide: a fleet that is already a rank's shard is
    never split again."""
    part = _PARTITION
    if part is None:
        raise RuntimeError("partitioned_pd_substep outside `partitioned`")
    if qpos.shape[-1] != part.local_batch:
        raise ValueError(
            f"K1-part: a shard of {qpos.shape[-1]} envs, want "
            f"{part.local_batch} ({part.global_batch} envs over "
            f"{part.world} ranks)")
    out = pd_substep(model, params, qpos, qvel, cmd_rows, static)
    if qpos.device.type == "cuda":
        partitioned_pd_substep.launches += 1
    return out


def launch_info(model: PhysModel) -> Dict[str, int]:
    """K1's launch shape for `model` on the current card: shared memory per
    block (the envs' scratch and the model's tables), envs per block (two
    warps each), blocks and envs resident per SM."""
    itab, ftab = _k1_tables(model, torch.device("cuda"))
    out = (ctypes.c_int * 4)()
    cuda_build.check(cuda_build.library().apex_pd_substep_info(
        itab.numel(), ftab.numel(), out), "apex_pd_substep_info")
    return dict(smem_bytes_per_block=out[0], envs_per_block=out[1],
                blocks_per_sm=out[2], envs_per_sm=out[3])


# launches of the kernel, and how many of them ran a heightfield model
pd_substep.launches = 0
pd_substep.hfield_launches = 0
# launches on a rank's shard
partitioned_pd_substep.launches = 0
