"""Batch-last fleet physics: the whole env fleet through one substep.

Port of `apex_tpu/physics/fleet.py`, flat, tilted and heightfield ground:
every array is shape + (B,). Forward kinematics goes through the CUDA kernel K2
(`fleet_fk.fleet_fk`) and the per-substep inverse of M + hD through K3
(`ops.pallas_linalg.spd_inverse_bt`); everything else is plain PyTorch.

Eager PyTorch pays one launch per operation, where XLA fuses the JAX
version's unrolled loops. So the tree recursions are products with
constant masks (`_mm_left`), the 3- and 6-wide contractions are
broadcast products summed over one axis, and the per-body, per-contact
and per-equality work is batched over a leading axis instead of unrolled
in Python. The math and its order per element are those of the JAX
fleet step; only the summation order of the contractions differs.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from apex_tpu_torch.ops.pallas_linalg import spd_inverse_bt
from apex_tpu_torch.physics.engine import (
    BAUMGARTE_BETA,
    HFIELD_RES,
    PhysParams,
    _Structure,
    hfield_bilinear,
)
from apex_tpu_torch.physics.fleet_fk import FleetKin, fleet_fk
from apex_tpu_torch.physics.spec import PhysModel
from apex_tpu_torch.utils.quaternion import mat2quat, quat_integrate, quat_rotate

__all__ = ["FleetKin", "FleetDyn", "FleetContact", "fleet_step"]


# ---------------------------------------------------------------------------
# batch-last helpers: arrays are shape + (B,)
# ---------------------------------------------------------------------------

def _cross_bt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over axis -2 of (..., 3, B) arrays (broadcasting)."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-2)


def _cross_motion_bt(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v x m for (..., 6, B) motion vectors: [w x mw, w x ml + vl x mw]."""
    w, vl = v[..., :3, :], v[..., 3:, :]
    mw, ml = m[..., :3, :], m[..., 3:, :]
    out = _cross_bt(w.unsqueeze(-3), m.unflatten(-2, (2, 3)))
    out[..., 1, :, :] += _cross_bt(vl, mw)
    return out.flatten(-3, -2)


def _cross_force_bt(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """v x* f for (..., 6, B) force vectors: [w x tau + vl x F, w x F]."""
    w, vl = v[..., :3, :], v[..., 3:, :]
    F = f[..., 3:, :]
    out = _cross_bt(w.unsqueeze(-3), f.unflatten(-2, (2, 3)))
    out[..., 0, :, :] += _cross_bt(vl, F)
    return out.flatten(-3, -2)


def _mm_left(Mc: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Constant (m, k) @ X (k, ..., B): one dense matmul over the flattened
    trailing dims, shared by the whole fleet (fp32: TF32 is off)."""
    k = X.shape[0]
    return (Mc @ X.reshape(k, -1)).reshape((Mc.shape[0],) + X.shape[1:])


def _bmm_bt(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Per-env matrix product (..., i, k, B) @ (..., k, j, B)."""
    return torch.sum(X.unsqueeze(-2) * Y.unsqueeze(-4), dim=-3)


def _skew_bt(c: torch.Tensor, levi: torch.Tensor) -> torch.Tensor:
    """skew(c) (..., 3, 3, B) of (..., 3, B) vectors: skew(c)[i, j] =
    -sum_k eps_ijk c_k."""
    return -torch.sum(levi[..., None] * c.unsqueeze(-3).unsqueeze(-3), dim=-2)


def _mat2quat_bt(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3, B) -> (..., 4, B) wxyz, w >= 0."""
    lead = m.dim() - 3
    perm = (lead, lead + 1) + tuple(range(lead)) + (m.dim() - 1,)
    q = mat2quat(m.permute(perm))                        # (4, ..., B)
    return q.permute(tuple(range(1, lead + 1)) + (0, m.dim() - 2))


# ---------------------------------------------------------------------------
# constants per (model, device)
# ---------------------------------------------------------------------------

class _Consts:
    """The model's constant masks, tables and index maps as tensors on one
    device, built once from `_Structure` (cached on the model)."""

    def __init__(self, model: PhysModel, device: torch.device):
        st = _Structure.of(model)
        nv = model.nv
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=device)
        idx = lambda x: torch.as_tensor(np.asarray(x, np.int64),
                                        device=device)
        self.A = f32(st.ancestor_mask)                       # (nb, nv)
        self.AT = f32(st.ancestor_mask.T)                    # (nv, nb)
        self.strict = f32(st.crba_mask - np.eye(nv))         # (nv, nv)
        self.crba_mask = f32(st.crba_mask)[:, :, None]       # (nv, nv, 1)
        self.I0 = f32(model.body_inertia)                    # (nb, 3, 3)
        self.armature = f32(model.dof_armature)[None, :]     # (1, nv)
        grav = np.asarray(model.gravity)
        self.a0 = f32(np.concatenate([np.zeros(3), -grav]))[None, :, None]
        self.eye3 = f32(np.eye(3))[:, :, None]               # (3, 3, 1)
        levi = np.zeros((3, 3, 3))
        for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            levi[i, j, k], levi[i, k, j] = 1.0, -1.0
        self.levi = f32(levi)                                # (3, 3, 3)
        self.ez = f32([0.0, 0.0, 1.0])[:, None]              # (3, 1)

        # joint limits, springs, actuators
        self.lim_dof = idx(st.lim_dof)
        self.lim_qadr = idx(st.lim_qadr)
        self.lim_flat = idx(st.lim_dof * (nv + 1))
        self.lim_lo = f32(st.lim_lo)[:, None]
        self.lim_hi = f32(st.lim_hi)[:, None]
        self.spring_k = f32(st.spring_k)[:, None]
        self.spring_qadr = idx(st.spring_qadr)
        self.act_dof = idx(st.act_dof)
        self.act_gear = f32(st.act_gear)[:, None]
        self.act_lo = f32(st.act_lo)[:, None]
        self.act_hi = f32(st.act_hi)[:, None]
        self.root_mask = f32(st.ancestor_mask[0])[:, None]   # (nv, 1)

        # contacts: per sphere, and per unique contact body
        cb = [int(b) for b in st.con_body]
        ubodies = sorted(set(cb))
        slot = [ubodies.index(b) for b in cb]
        self.con_body = idx(cb)
        self.con_offset = f32(st.con_offset)[:, None, :, None]  # (nc,1,3,1)
        self.con_radius = f32(st.con_radius)[:, None]            # (nc, 1)
        self.ub_mask = f32(st.ancestor_mask[ubodies])            # (nub, nv)
        self.slot = idx(slot)
        onehot = np.zeros((len(ubodies), len(cb)), np.float32)
        onehot[slot, np.arange(len(cb))] = 1.0
        self.slot_onehot = f32(onehot)                           # (nub, nc)

        # loop-closure connects
        eqs = model.equalities
        self.neq = len(eqs)
        self.eq_b1 = idx([e.body1 for e in eqs])
        self.eq_b2 = idx([e.body2 for e in eqs])
        anchors = lambda k: f32(np.reshape(
            [getattr(e, k) for e in eqs], (-1, 3)))[:, None, :, None]
        self.eq_anchor1 = anchors("anchor1")                     # (ne,1,3,1)
        self.eq_anchor2 = anchors("anchor2")
        self.eq_mask1 = f32(np.reshape(
            [st.ancestor_mask[e.body1] for e in eqs], (-1, nv)))
        self.eq_mask2 = f32(np.reshape(
            [st.ancestor_mask[e.body2] for e in eqs], (-1, nv)))

        # qpos integration
        self.lin_dof = idx(st.lin_dof)
        self.lin_qadr = idx(st.lin_qadr)
        self.ball_qadr = idx([[q + k for k in range(4)] for q, _ in st.balls])
        self.ball_dof = idx([[d + k for k in range(3)] for _, d in st.balls])

    @staticmethod
    def of(model: PhysModel, device: torch.device) -> "_Consts":
        cache = model.__dict__.setdefault("_torch_consts", {})
        c = cache.get(device)
        if c is None:
            c = cache[device] = _Consts(model, device)
        return c


# ---------------------------------------------------------------------------
# dynamics (batch-last mirror of engine.compute_dynamics)
# ---------------------------------------------------------------------------

class FleetDyn(NamedTuple):
    kin: FleetKin
    body_vel: torch.Tensor   # (nb, 6, B)
    cdof_dot: torch.Tensor   # (nv, 6, B)
    M: torch.Tensor          # (nv, nv, B)
    Minv: torch.Tensor       # (nv, nv, B) -- (M + h D)^-1
    qfrc_bias: torch.Tensor  # (nv, B)


def _dynamics_bt(model: PhysModel, params_bt: PhysParams, qpos: torch.Tensor,
                 qvel: torch.Tensor) -> FleetDyn:
    c = _Consts.of(model, qpos.device)
    kin = fleet_fk(model, params_bt.body_ipos, qpos)

    wdof = kin.cdof * qvel[:, None, :]                   # (nv, 6, B)
    body_vel = _mm_left(c.A, wdof)                       # (nb, 6, B)
    v_pre = _mm_left(c.strict, wdof)                     # (nv, 6, B)
    cdof_dot = _cross_motion_bt(v_pre, kin.cdof)

    # spatial inertias about the origin: R I0 R^T, skew-square closed form
    R = kin.ximat                                        # (nb, 3, 3, B)
    T = torch.sum(R.unsqueeze(-2) * c.I0[:, None, :, :, None], dim=2)
    I_world = torch.sum(T.unsqueeze(2) * R.unsqueeze(1), dim=3)
    cpos = kin.xipos                                     # (nb, 3, B)
    ccT = cpos[:, :, None, :] * cpos[:, None, :, :]
    cc = torch.sum(cpos * cpos, dim=1)                   # (nb, B)
    CC = ccT - cc[:, None, None, :] * c.eye3
    C = _skew_bt(cpos, c.levi)                           # (nb, 3, 3, B)
    m4 = params_bt.body_mass[:, None, None, :]
    mC = m4 * C
    inertias = torch.cat([
        torch.cat([I_world - m4 * CC, mC], dim=2),
        torch.cat([-mC, m4 * c.eye3], dim=2),
    ], dim=1)                                            # (nb, 6, 6, B)

    # RNEA bias (qacc = 0, gravity as base acceleration)
    body_acc = c.a0 + _mm_left(c.A, cdof_dot * qvel[:, None, :])
    Iv = torch.sum(inertias * body_vel[:, None, :, :], dim=2)
    body_frc = (torch.sum(inertias * body_acc[:, None, :, :], dim=2)
                + _cross_force_bt(body_vel, Iv))         # (nb, 6, B)
    F_sub = _mm_left(c.AT, body_frc)                     # (nv, 6, B)
    qfrc_bias = torch.sum(kin.cdof * F_sub, dim=1)

    # CRBA: composite inertias per dof
    Ic_dof = _mm_left(c.AT, inertias)                    # (nv, 6, 6, B)
    H = torch.sum(Ic_dof * kin.cdof[:, None, :, :], dim=2)          # (nv, 6, B)
    M_full = torch.sum(H[:, None, :, :] * kin.cdof[None, :, :, :], dim=2)
    Ml = M_full * c.crba_mask
    M = Ml + Ml.transpose(0, 1)
    M.diagonal(dim1=0, dim2=1).copy_(
        Ml.diagonal(dim1=0, dim2=1) + c.armature)        # (B, nv) views
    Md = M.clone()
    Md.diagonal(dim1=0, dim2=1).add_(model.timestep * params_bt.dof_damping.T)
    Minv = spd_inverse_bt(Md)

    return FleetDyn(kin=kin, body_vel=body_vel, cdof_dot=cdof_dot, M=M,
                    Minv=Minv, qfrc_bias=qfrc_bias)


# ---------------------------------------------------------------------------
# constraint forces
# ---------------------------------------------------------------------------

class FleetContact(NamedTuple):
    force: torch.Tensor      # (nc, 3, B)
    depth: torch.Tensor      # (nc, B)
    pos: torch.Tensor        # (nc, 3, B)
    vel: torch.Tensor        # (nc, 3, B)


def _constraint_forces_bt(model: PhysModel, params_bt: PhysParams,
                          dyn: FleetDyn
                          ) -> Tuple[torch.Tensor, FleetContact]:
    """Penalty contacts of the spheres with the (tilted) floor plane or,
    for a heightfield model's envs with hfield_active, the terrain, with
    the spatial Delassus formulation of the JAX fleet: Lambda_b =
    S_b (M + hD)^-1 S_b^T once per contact body, G_c = Phi_c Lambda_b
    Phi_c^T per sphere with Phi_c = [-skew(p_c) | I3]."""
    kin = dyn.kin
    c = _Consts.of(model, kin.origin.device)
    B = kin.origin.shape[-1]
    tau_c = model.solref_timeconst
    zeta = model.solref_dampratio
    k_unit = 1.0 / (tau_c * tau_c * zeta * zeta)
    b_unit = 2.0 / tau_c

    n_w = quat_rotate(params_bt.floor_quat, c.ez.expand(3, B))
    floor_p = params_bt.floor_pos - kin.origin           # (3, B)

    cb = c.con_body
    xmat_c = kin.ximat[cb]                               # (nc, 3, 3, B)
    p = kin.xpos[cb] + torch.sum(xmat_c * c.con_offset, dim=2)   # (nc, 3, B)
    depth = c.con_radius - torch.sum((p - floor_p) * n_w, dim=1)  # (nc, B)
    p_world = p + kin.origin
    n_c = n_w.expand(p.shape)
    if model.enable_hfield:
        cell = 2.0 * params_bt.hfield_radius / (HFIELD_RES - 1)  # (B,)
        h, dhdx, dhdy = hfield_bilinear(
            params_bt.hfield.reshape(HFIELD_RES ** 2, B),
            params_bt.floor_pos, cell, p_world[:, 0, :], p_world[:, 1, :])
        n_h = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=1)
        n_h = n_h / torch.sqrt(torch.sum(n_h * n_h, dim=1, keepdim=True))
        depth_h = (c.con_radius + (params_bt.floor_pos[2] + h)
                   - p_world[:, 2, :])
        active = params_bt.hfield_active > 0.5               # (B,)
        depth = torch.where(active, depth_h, depth)
        n_c = torch.where(active, n_h, n_c)

    bv = dyn.body_vel[cb]                                # (nc, 6, B)
    v_p = bv[:, 3:, :] + _cross_bt(bv[:, :3, :], p)      # (nc, 3, B)

    # Lambda_b = S_b Minv S_b^T with S_b the ancestry-masked cdof
    S = kin.cdof[None] * c.ub_mask[:, :, None, None]     # (nub, nv, 6, B)
    T = torch.einsum("uvxb,vwb->uxwb", S, dyn.Minv)      # (nub, 6, nv, B)
    Lam = torch.einsum("uxwb,uwyb->uxyb", T, S)          # (nub, 6, 6, B)
    Phi = torch.cat([-_skew_bt(p, c.levi), c.eye3.expand(p.shape[0], 3, 3, B)],
                    dim=2)                               # (nc, 3, 6, B)
    G = _bmm_bt(_bmm_bt(Phi, Lam[c.slot]), Phi.transpose(1, 2))  # (nc,3,3,B)

    g_n = torch.sum(n_c * torch.sum(G * n_c[:, None, :, :], dim=2), dim=1)
    m_n = 1.0 / torch.clamp(g_n, min=1e-8)
    vn = torch.sum(v_p * n_c, dim=1)                     # (nc, B)
    fn = torch.clamp(m_n * (k_unit * depth - b_unit * vn), min=0.0)
    fn = torch.where(depth > 0, fn, 0.0)

    vt = v_p - vn[:, None, :] * n_c
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=1)) + 1e-9
    trG = torch.diagonal(G, dim1=1, dim2=2).sum(-1)      # (nc, B)
    m_t = 1.0 / torch.clamp((trG - g_n) / 2.0, min=1e-8)
    f_stick = m_t * vt_norm / (2.0 * model.timestep)
    ft_mag = torch.minimum(params_bt.friction[None] * fn, f_stick)
    ft = -(ft_mag / vt_norm)[:, None, :] * vt
    f = fn[:, None, :] * n_c + ft                        # (nc, 3, B)

    # qfrc = J^T f = S_b^T (Phi^T f): total wrench per contact body,
    # projected through the masked cdof
    wrench = torch.cat([_cross_bt(p, f), f], dim=1)      # (nc, 6, B)
    W = _mm_left(c.slot_onehot, wrench)                  # (nub, 6, B)
    qfrc = torch.sum(kin.cdof * _mm_left(c.ub_mask.T, W), dim=1)
    return qfrc, FleetContact(force=f, depth=depth, pos=p_world, vel=v_p)


def _joint_limit_forces_bt(model: PhysModel, dyn: FleetDyn,
                           qpos: torch.Tensor, qvel: torch.Tensor
                           ) -> torch.Tensor:
    c = _Consts.of(model, qpos.device)
    B = qpos.shape[-1]
    nv = model.nv
    tau_c = model.solref_timeconst
    zeta = model.solref_dampratio
    k_unit = 1.0 / (tau_c * tau_c * zeta * zeta)
    b_unit = 2.0 / tau_c

    q = qpos[c.lim_qadr]                                 # (nl, B)
    qd = qvel[c.lim_dof]
    diag_dof = dyn.Minv.reshape(nv * nv, B)[c.lim_flat]  # (nl, B)
    m_eff = 1.0 / torch.clamp(diag_dof, min=1e-8)
    below = c.lim_lo - q
    above = q - c.lim_hi
    f_lo = torch.where(below > 0, m_eff * (k_unit * below - b_unit * qd), 0.0)
    f_hi = torch.where(above > 0, m_eff * (k_unit * above + b_unit * qd), 0.0)
    f = torch.clamp(f_lo, min=0.0) - torch.clamp(f_hi, min=0.0)
    return qpos.new_zeros((nv, B)).index_add_(0, c.lim_dof, f)


def _equality_jacobian_bt(model: PhysModel, dyn: FleetDyn
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """J_eq (3*neq, nv, B), err (3*neq, B): all connects at once."""
    kin = dyn.kin
    c = _Consts.of(model, kin.origin.device)
    nv, B = model.nv, kin.origin.shape[-1]
    p1 = kin.xpos[c.eq_b1] + torch.sum(kin.ximat[c.eq_b1] * c.eq_anchor1,
                                       dim=2)            # (ne, 3, B)
    p2 = kin.xpos[c.eq_b2] + torch.sum(kin.ximat[c.eq_b2] * c.eq_anchor2,
                                       dim=2)
    ang = kin.cdof[None, :, :3, :]                       # (1, nv, 3, B)
    lin = kin.cdof[None, :, 3:, :]
    # point jacobians (ne, nv, 3, B), masked by each body's ancestry
    c1 = (_cross_bt(ang, p1[:, None]) + lin) * c.eq_mask1[:, :, None, None]
    c2 = (_cross_bt(ang, p2[:, None]) + lin) * c.eq_mask2[:, :, None, None]
    J = (c1 - c2).transpose(1, 2).reshape(3 * c.neq, nv, B)
    return J, (p1 - p2).reshape(3 * c.neq, B)


def _chol_solve_bt(A: torch.Tensor, b: torch.Tensor,
                   pivot_floor: float = 1e-4) -> torch.Tensor:
    """Cholesky solve for small (k, k, B) systems, batch-last, written as
    its square-root-free twin A = L D L^T (L unit lower, D = the squared
    pivots) so that each column costs three launches: the same factors,
    since the Cholesky factor is L sqrt(D), and the same floor, on the
    squared pivot. Column j of L below the diagonal overwrites S[j+1:, j].

    pivot_floor defaults to 1e-4 because the only caller solves the
    Jacobi-normalized (unit-diagonal) equality Delassus system: a smaller
    pivot is a numerically singular direction, and letting it through
    cascades 1/d factors that overflow f32."""
    k = A.shape[0]
    S = A.clone()
    d = []
    for j in range(k):
        d.append(torch.clamp(S[j, j], min=pivot_floor))
        if j + 1 < k:
            below = S[j + 1:, j].clone()
            col = S[j + 1:, j].div_(d[j])
            S[j + 1:, j + 1:].addcmul_(below[:, None], col[None, :],
                                       value=-1.0)
    y = b.clone()
    for i in range(k - 1):                               # L y = b
        y[i + 1:].addcmul_(S[i + 1:, i], y[i][None], value=-1.0)
    y = y / torch.stack(d)                               # D z = y
    for i in reversed(range(1, k)):                      # L^T x = z
        y[:i].addcmul_(S[i, :i], y[i][None], value=-1.0)
    return y


def _passive_forces_bt(model: PhysModel, qpos: torch.Tensor) -> torch.Tensor:
    c = _Consts.of(model, qpos.device)
    return -c.spring_k * qpos[c.spring_qadr]


def _actuator_forces_bt(model: PhysModel, ctrl: torch.Tensor) -> torch.Tensor:
    """ctrl (nu, B) -> qfrc (nv, B)."""
    c = _Consts.of(model, ctrl.device)
    u = torch.minimum(torch.maximum(ctrl, c.act_lo), c.act_hi)
    return ctrl.new_zeros((model.nv, ctrl.shape[-1])).index_add_(
        0, c.act_dof, c.act_gear * u)


def _external_wrench_bt(model: PhysModel, dyn: FleetDyn,
                        wrench: torch.Tensor) -> torch.Tensor:
    """wrench (6, B) [torque, force] at the root body origin."""
    kin = dyn.kin
    c = _Consts.of(model, wrench.device)
    tau, F = wrench[:3], wrench[3:]
    w = torch.cat([tau + _cross_bt(kin.xpos[0], F), F], dim=0)
    return torch.sum(kin.cdof * w[None], dim=1) * c.root_mask


def _integrate_qpos_bt(model: PhysModel, qpos: torch.Tensor,
                       qvel: torch.Tensor, h: float) -> torch.Tensor:
    c = _Consts.of(model, qpos.device)
    new_qpos = qpos.index_add(0, c.lin_qadr, h * qvel[c.lin_dof])
    if len(c.ball_qadr):
        q = qpos[c.ball_qadr].transpose(0, 1)           # (4, nball, B)
        w = qvel[c.ball_dof].transpose(0, 1)            # (3, nball, B)
        new_q = quat_integrate(q, w, h).transpose(0, 1)  # (nball, 4, B)
        new_qpos[c.ball_qadr.reshape(-1)] = new_q.reshape(-1, qpos.shape[-1])
    return new_qpos


# ---------------------------------------------------------------------------
# the fleet substep
# ---------------------------------------------------------------------------

def fleet_step(model: PhysModel, params_bt: PhysParams, qpos: torch.Tensor,
               qvel: torch.Tensor, ctrl: torch.Tensor):
    """One substep of the whole fleet: qpos (nq, B), qvel (nv, B), ctrl
    (nu, B); params_bt batch-last. Returns (dyn, contact, qpos, qvel, qacc,
    actuator torque), as `apex_tpu.physics.fleet.fleet_step`."""
    c = _Consts.of(model, qpos.device)
    dyn = _dynamics_bt(model, params_bt, qpos, qvel)

    qfrc_con, contact = _constraint_forces_bt(model, params_bt, dyn)
    qfrc_lim = _joint_limit_forces_bt(model, dyn, qpos, qvel)
    qfrc_spring = _passive_forces_bt(model, qpos)
    qfrc_act = _actuator_forces_bt(model, ctrl)
    qfrc_ext = _external_wrench_bt(model, dyn, params_bt.ext_force)

    qfrc = (qfrc_act + qfrc_spring + qfrc_con + qfrc_lim + qfrc_ext
            - dyn.qfrc_bias)
    h = model.timestep
    Ainv = dyn.Minv

    def matvec(Mbt, x):
        """(nv, nv, B) @ (nv, B)."""
        return torch.sum(Mbt * x[None, :, :], dim=1)

    qacc_free = matvec(Ainv, qfrc - params_bt.dof_damping * qvel)
    v_pred = qvel + h * qacc_free

    if model.equalities:
        J_eq, err = _equality_jacobian_bt(model, dyn)      # (e, nv, B)
        e = J_eq.shape[0]
        T = torch.einsum("kvb,vwb->kwb", J_eq, Ainv)
        G = torch.einsum("kwb,lwb->klb", T, J_eq)          # (e, e, B)
        d = torch.rsqrt(torch.diagonal(G, dim1=0, dim2=1).T + 1e-12)  # (e, B)
        Gs = d[:, None, :] * G * d[None, :, :]
        Gs.diagonal(dim1=0, dim2=1).add_(1e-6)
        rhs = -(torch.sum(J_eq * v_pred[None], dim=1)
                + (BAUMGARTE_BETA / h) * err)
        lam = d * _chol_solve_bt(Gs, d * rhs)
        jt_lam = torch.sum(J_eq * lam[:, None, :], dim=0)
        new_qvel = v_pred + matvec(Ainv, jt_lam)
    else:
        new_qvel = v_pred

    qacc = (new_qvel - qvel) / h
    new_qpos = _integrate_qpos_bt(model, qpos, new_qvel, h)

    act_torque = c.act_gear * torch.minimum(torch.maximum(ctrl, c.act_lo),
                                            c.act_hi)
    return dyn, contact, new_qpos, new_qvel, qacc, act_torque
