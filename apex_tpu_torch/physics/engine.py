"""The rigid-body engine: model metadata, parameters and the per-env tier.

Port of `apex_tpu/physics/engine.py`: the dynamic `PhysParams` (batch-last
tensors, as the fleet tiers take them), the engine constants, the numpy
tree metadata `_Structure` (copied verbatim) from which the fleet step
builds its constant masks and the FK kernel its tables, and the per-env
pipeline -- the JAX package's reference tier, which it runs under
`jax.vmap(_step_single)` with APEX_TPU_NO_FLEET=1 and against which its
own tests hold the fleet and K1.

The per-env pipeline is written batch-first: every function takes tensors
with a leading env axis and does per env what the JAX function does under
vmap, in the JAX function's order of operations (the mul-reduce forms it
chose over einsums included), so the CPU parity stays tight. Its params
are batch-first too: `params_batch_first` converts the batch-last
`PhysParams` once per call. Forward kinematics is plain PyTorch (no K2, as
JAX's per-env FK is plain XLA); the inverse of M + hD goes through
`ops.linalg.batched_spd_inverse`, which launches K3's batch-first route on
the card; everything else is plain PyTorch, one launch per operation.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from apex_tpu_torch.device import const
from apex_tpu_torch.ops.linalg import batched_spd_inverse, spd_solve
from apex_tpu_torch.physics.spec import DOF_WIDTH, JointType, PhysModel
from apex_tpu_torch.utils.quaternion import (
    mat2quat,
    quat2mat,
    quat_integrate,
    quat_rotate,
)

HFIELD_RES = 32
BAUMGARTE_BETA = 0.2   # per-substep fraction of connect error corrected


@dataclasses.dataclass
class PhysParams:
    """Dynamics parameters mutable at reset time (dynamics randomization),
    batch-last: every field is the JAX `PhysParams` shape + (B,).

    Mirrors what the reference mutates through cassie_sim_set_* + set_const
    (cassie.py:634-650). The heightfield fields are read by a model with
    `enable_hfield`: each env's terrain table, centred on floor_pos and
    spanning +- hfield_radius, replaces the plane where hfield_active."""
    body_mass: torch.Tensor      # (nbody, B)
    body_ipos: torch.Tensor      # (nbody, 3, B)
    dof_damping: torch.Tensor    # (nv, B)
    friction: torch.Tensor       # (B,) translational mu
    floor_quat: torch.Tensor     # (4, B) floor plane orientation
    floor_pos: torch.Tensor      # (3, B) point on the floor plane
    ext_force: torch.Tensor      # (6, B) [torque, force] world wrench on root
    hfield: torch.Tensor         # (HFIELD_RES, HFIELD_RES, B)
    hfield_radius: torch.Tensor  # (B,)
    hfield_active: torch.Tensor  # (B,)

    @staticmethod
    def from_model(model: PhysModel, batch: int,
                   device: torch.device) -> "PhysParams":
        def bt(x):
            x = const(np.asarray(x, np.float32), device)
            return x[..., None].expand(*x.shape, batch).contiguous()

        return PhysParams(
            body_mass=bt(model.body_mass),
            body_ipos=bt(model.body_ipos),
            dof_damping=bt(model.dof_damping),
            friction=bt(1.0),
            floor_quat=bt(model.floor_quat),
            floor_pos=bt(model.floor_pos),
            ext_force=bt(np.zeros(6)),
            hfield=bt(np.zeros((HFIELD_RES, HFIELD_RES))),
            hfield_radius=bt(10.0),
            hfield_active=bt(0.0),
        )


def hfield_bilinear(hf: torch.Tensor, fpos, cellsz: torch.Tensor,
                    pwx: torch.Tensor, pwy: torch.Tensor):
    """Height and gradient (h, dh/dx, dh/dy) of every env's terrain at the
    world points (pwx, pwy), each (..., B); hf is the (HFIELD_RES^2, B)
    table, row ix * HFIELD_RES + iy, centred on the floor position fpos
    (3, B), cellsz (B,). The lookup of the fleet tier and of K1's plain
    version.

    The TPU kernel contracts the table with tent weights (Mosaic cannot
    gather per lane, fleet_kernel.py:455-505); the only nonzero terms of
    that contraction are the four corners H[ix, iy], H[ix+1, iy],
    H[ix, iy+1], H[ix+1, iy+1], and adding an exact zero changes no
    rounded sum. So the corners are gathered here and combined in the
    contraction's order, which gives its values: x first, then y. The JAX
    fleet's product-form lookup (`fleet._hfield_lookup_bt`) agrees to
    rounding."""
    ng = HFIELD_RES
    ux = torch.clamp((pwx - fpos[0]) / cellsz + (ng - 1) / 2.0, 0.0,
                     ng - 1.001)
    uy = torch.clamp((pwy - fpos[1]) / cellsz + (ng - 1) / 2.0, 0.0,
                     ng - 1.001)
    i0x, i0y = torch.floor(ux), torch.floor(uy)
    fx, fy = ux - i0x, uy - i0y
    # a NaN coordinate reads corner 0; its weights are NaN all the same
    base = (torch.nan_to_num(i0x).long() * ng
            + torch.nan_to_num(i0y).long())
    idx = base.reshape(-1, hf.shape[-1])
    h00, h01, h10, h11 = (torch.gather(hf, 0, idx + off).reshape(base.shape)
                          for off in (0, 1, ng, ng + 1))
    acc0 = h00 * (1.0 - fx) + h10 * fx          # row iy, x contracted
    acc1 = h01 * (1.0 - fx) + h11 * fx          # row iy + 1
    hh = acc0 * (1.0 - fy) + acc1 * fy
    dhx = (h10 - h00) * (1.0 - fy) + (h11 - h01) * fy
    dhy = acc1 - acc0
    return hh, dhx / cellsz, dhy / cellsz


class _Structure:
    """Static index/mask structure derived from the kinematic tree, used to
    vectorize CRBA / jacobian / scatter passes into masked matmuls (keeps the
    XLA graph small: thousands of dynamic-update-slices collapse into a few
    einsums)."""

    def __init__(self, model: PhysModel):
        nb, nv = model.nbody, model.nv
        dof_body = np.zeros(nv, dtype=np.int32)
        for j in model.joints:
            for k in range(DOF_WIDTH[j.jtype]):
                dof_body[j.dofadr + k] = j.body
        # ancestor_mask[b, d] = 1 if dof d lies on the path from body b to
        # the root (including b's own dofs)
        ancestor_mask = np.zeros((nb, nv), dtype=np.float32)
        for b in range(nb):
            cur = b
            while cur != -1:
                for jidx in model.body_joints[cur]:
                    j = model.joints[jidx]
                    ancestor_mask[b, j.dofadr:j.dofadr + DOF_WIDTH[j.jtype]] = 1.0
                cur = int(model.body_parent[cur])
        # crba_mask[d1, d2] = 1 if d2 is an ancestor dof of body(d1) and
        # d2 <= d1 (strict lower wedge + diagonal)
        crba_mask = np.zeros((nv, nv), dtype=np.float32)
        for d1 in range(nv):
            for d2 in range(nv):
                if d2 <= d1 and ancestor_mask[dof_body[d1], d2]:
                    crba_mask[d1, d2] = 1.0

        # passive springs: per-dof stiffness vector + qpos gather index
        spring_k = np.zeros(nv, dtype=np.float32)
        spring_qadr = np.zeros(nv, dtype=np.int32)
        for j in model.joints:
            if j.stiffness != 0.0 and j.jtype != JointType.BALL:
                spring_k[j.dofadr] = j.stiffness
                spring_qadr[j.dofadr] = j.qposadr

        # joint limits
        lim_dof, lim_qadr, lim_lo, lim_hi = [], [], [], []
        for j in model.joints:
            if j.limited and j.jtype != JointType.BALL:
                lim_dof.append(j.dofadr)
                lim_qadr.append(j.qposadr)
                lim_lo.append(j.range[0])
                lim_hi.append(j.range[1])
        self.lim_dof = np.asarray(lim_dof, dtype=np.int32)
        self.lim_qadr = np.asarray(lim_qadr, dtype=np.int32)
        self.lim_lo = np.asarray(lim_lo, dtype=np.float32)
        self.lim_hi = np.asarray(lim_hi, dtype=np.float32)

        # actuators
        self.act_dof = np.asarray(
            [model.joints[a.joint].dofadr for a in model.actuators], np.int32)
        self.act_gear = np.asarray([a.gear for a in model.actuators],
                                   np.float32)
        self.act_lo = np.asarray([a.ctrlrange[0] for a in model.actuators],
                                 np.float32)
        self.act_hi = np.asarray([a.ctrlrange[1] for a in model.actuators],
                                 np.float32)

        self.dof_body = dof_body
        self.ancestor_mask = ancestor_mask
        self.crba_mask = crba_mask
        self.spring_k = spring_k
        self.spring_qadr = spring_qadr

        # contacts, stacked for vectorized collision/jacobian math
        nc = len(model.contacts)
        self.ncon = nc
        self.con_body = np.asarray([c.body for c in model.contacts], np.int32)
        self.con_offset = (np.stack([c.offset for c in model.contacts])
                           if nc else np.zeros((0, 3)))
        self.con_radius = np.asarray([c.radius for c in model.contacts],
                                     np.float32)
        self.con_mask = (ancestor_mask[self.con_body]
                         if nc else np.zeros((0, nv), np.float32))

        # qpos integration index maps (hinge/slide in one scatter)
        lin_dof, lin_qadr, ball_list = [], [], []
        for j in model.joints:
            if j.jtype == JointType.BALL:
                ball_list.append((j.qposadr, j.dofadr))
            else:
                lin_dof.append(j.dofadr)
                lin_qadr.append(j.qposadr)
        self.lin_dof = np.asarray(lin_dof, np.int32)
        self.lin_qadr = np.asarray(lin_qadr, np.int32)
        self.balls = ball_list

        # FK constants: body-frame rotation matrices and per-joint Rodrigues
        # skews (keeps the traced FK to ~15 eqns per body)
        def _np_quat2mat(q):
            w, x, y, z = q
            return np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ])

        self.body_rot = np.stack([_np_quat2mat(model.body_quat[b])
                                  for b in range(nb)])
        self.body_rot_identity = [
            bool(np.allclose(self.body_rot[b], np.eye(3)))
            for b in range(nb)]
        self.joint_K = {}
        for jidx, j in enumerate(model.joints):
            a = np.asarray(j.axis, float)
            K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                          [-a[1], a[0], 0]])
            self.joint_K[jidx] = (K, K @ K)
            if np.linalg.norm(j.pos) > 0:
                raise NotImplementedError(
                    "joints with nonzero anchor not supported by the fast FK")

    @classmethod
    def of(cls, model: PhysModel) -> "_Structure":
        # Cached on the model instance itself (object.__setattr__ bypasses
        # the frozen-dataclass guard): an id()-keyed module dict let a new
        # model silently reuse a GC'd model's structure when CPython
        # recycled the address.
        st = model.__dict__.get("_structure")
        if st is None:
            st = cls(model)
            object.__setattr__(model, "_structure", st)
        return st


# ---------------------------------------------------------------------------
# the per-env tier, batch-first: every tensor has a leading env axis (B, ...)
# ---------------------------------------------------------------------------

def params_batch_first(params: PhysParams) -> PhysParams:
    """The batch-last `params` as batch-first tensors, each field JAX's
    per-env shape behind a leading (B,): the layout of the per-env engine.
    Callers convert once per call, not once per substep."""
    return PhysParams(**{
        f.name: torch.movedim(getattr(params, f.name), -1, 0).contiguous()
        for f in dataclasses.fields(PhysParams)})


def hfield_lookup(params: PhysParams, xy: torch.Tensor):
    """Bilinear terrain height and gradient at world points xy (B, n, 2),
    with batch-first params: the product form of the JAX per-env lookup
    (engine.py:99-118), not the fleet's contraction order."""
    n = HFIELD_RES
    B = xy.shape[0]
    cell = (2.0 * params.hfield_radius / (n - 1))[:, None]      # (B, 1)
    u = (xy - params.floor_pos[:, None, 0:2]) / cell[..., None] \
        + (n - 1) / 2.0
    u = torch.clamp(u, 0.0, n - 1.001)
    i0 = torch.floor(u)
    f = u - i0
    # a NaN coordinate reads cell 0; its weights are NaN all the same
    ix, iy = torch.nan_to_num(i0).long().unbind(-1)
    table = params.hfield.reshape(B, n * n)
    at = lambda dx, dy: torch.gather(table, 1, (ix + dx) * n + iy + dy)
    h00, h10, h01, h11 = at(0, 0), at(1, 0), at(0, 1), at(1, 1)
    fx, fy = f[..., 0], f[..., 1]
    h = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
         + h01 * (1 - fx) * fy + h11 * fx * fy)
    dhdx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / cell
    dhdy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / cell
    return h, dhdx, dhdy


class Kinematics(NamedTuple):
    xpos: torch.Tensor    # (B, nbody, 3) body frame origins, origin-shifted
    xquat: torch.Tensor   # (B, nbody, 4)
    ximat: torch.Tensor   # (B, nbody, 3, 3) rotation matrices
    xipos: torch.Tensor   # (B, nbody, 3) com positions, origin-shifted
    cdof: torch.Tensor    # (B, nv, 6) spatial motion axes [ang, lin]
    origin: torch.Tensor  # (B, 3) spatial-algebra origin (root position)


class Dynamics(NamedTuple):
    kin: Kinematics
    body_vel: torch.Tensor   # (B, nbody, 6) [ang, lin@origin]
    cdof_dot: torch.Tensor   # (B, nv, 6)
    M: torch.Tensor          # (B, nv, nv) mass matrix (with armature)
    Minv: torch.Tensor       # (B, nv, nv) (M + hD)^-1
    qfrc_bias: torch.Tensor  # (B, nv) coriolis + gravity


class ContactInfo(NamedTuple):
    force: torch.Tensor      # (B, ncon, 3) world-frame force on the body
    depth: torch.Tensor      # (B, ncon) penetration depth (> 0 touching)
    pos: torch.Tensor        # (B, ncon, 3) contact point, world
    vel: torch.Tensor        # (B, ncon, 3) contact point velocity


class StepOut(NamedTuple):
    qpos: torch.Tensor
    qvel: torch.Tensor
    qacc: torch.Tensor
    contact: ContactInfo
    kin: Kinematics
    actuator_torque: torch.Tensor  # (B, nu) joint-level torques applied


class _EnvConsts:
    """The per-env tier's constants of one model on one device, built once
    from `_Structure` (cached on the model)."""

    def __init__(self, model: PhysModel, device: torch.device):
        st = _Structure.of(model)
        nv = model.nv
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                        device=device)
        idx = lambda x: torch.as_tensor(np.asarray(x, np.int64),
                                        device=device)
        self.body_pos = [f32(p) for p in model.body_pos]
        self.body_rot = [f32(r) for r in st.body_rot]
        self.axis = [f32(j.axis) for j in model.joints]
        self.K = [(f32(st.joint_K[k][0]), f32(st.joint_K[k][1]))
                  for k in range(len(model.joints))]
        self.eye3 = f32(np.eye(3))
        self.zeros3 = f32(np.zeros(3))
        self.A = f32(st.ancestor_mask)                    # (nb, nv)
        self.AT = f32(st.ancestor_mask.T)
        self.strict = f32(st.crba_mask - np.eye(nv))
        self.crba_mask = f32(st.crba_mask)
        self.I0 = f32(model.body_inertia)
        self.armature = f32(model.dof_armature)
        self.gravity = f32(model.gravity)
        self.a0 = f32(np.concatenate([np.zeros(3), -np.asarray(
            model.gravity)]))
        self.ez = f32([0.0, 0.0, 1.0])
        self.con_body = idx(st.con_body)
        self.con_offset = f32(st.con_offset)              # (nc, 3)
        self.con_radius = f32(st.con_radius)
        self.con_mask = f32(st.con_mask)                  # (nc, nv)
        self.eq_anchor = [(f32(e.anchor1), f32(e.anchor2))
                          for e in model.equalities]
        self.lim_dof = idx(st.lim_dof)
        self.lim_qadr = idx(st.lim_qadr)
        self.lim_lo = f32(st.lim_lo)
        self.lim_hi = f32(st.lim_hi)
        self.spring_k = f32(st.spring_k)
        self.spring_qadr = idx(st.spring_qadr)
        self.act_dof = idx(st.act_dof)
        self.act_gear = f32(st.act_gear)
        self.act_lo = f32(st.act_lo)
        self.act_hi = f32(st.act_hi)
        self.lin_dof = idx(st.lin_dof)
        self.lin_qadr = idx(st.lin_qadr)

    @staticmethod
    def of(model: PhysModel, device: torch.device) -> "_EnvConsts":
        cache = model.__dict__.setdefault("_torch_env_consts", {})
        c = cache.get(device)
        if c is None:
            c = cache[device] = _EnvConsts(model, device)
        return c


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _cross_motion_batch(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Rowwise v x m for (..., 6) motion vectors."""
    w, vl = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([_cross(w, mw), _cross(w, ml) + _cross(vl, mw)], dim=-1)


def _cross_force_batch(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Rowwise v x* f for (..., 6) force vectors."""
    w, vl = v[..., :3], v[..., 3:]
    tau, F = f[..., :3], f[..., 3:]
    return torch.cat([_cross(w, tau) + _cross(vl, F), _cross(w, F)], dim=-1)


def _skew(c: torch.Tensor) -> torch.Tensor:
    """skew(c) (..., 3, 3) of (..., 3) vectors."""
    cx, cy, cz = c.unbind(-1)
    z = torch.zeros_like(cx)
    return torch.stack([torch.stack([z, -cz, cy], -1),
                        torch.stack([cz, z, -cx], -1),
                        torch.stack([-cy, cx, z], -1)], -2)


def forward_kinematics(model: PhysModel, params: PhysParams,
                       qpos: torch.Tensor) -> Kinematics:
    """Position pass of the per-env tier: params batch-first, qpos (B, nq)."""
    return _forward_kinematics_single(model, params.body_ipos, qpos)


def _forward_kinematics_single(model: PhysModel, body_ipos: torch.Tensor,
                               qpos: torch.Tensor) -> Kinematics:
    """engine.py:375-438 per env: rotations propagated as 3x3 matrices with
    constant body frames and Rodrigues joint rotations, origin-shifted to
    the root position. body_ipos (B, nbody, 3)."""
    c = _EnvConsts.of(model, qpos.device)
    st = _Structure.of(model)
    nb, nv = model.nbody, model.nv
    B = qpos.shape[0]
    xpos: List = [None] * nb
    xmat: List = [None] * nb
    cdof_rows: List = [None] * nv
    origin = qpos[:, 0:3] if nv >= 3 else qpos.new_zeros((B, 3))

    for i in range(nb):
        p = int(model.body_parent[i])
        if p == -1:
            pos = c.body_pos[i] - origin
            R = c.body_rot[i].expand(B, 3, 3)
        else:
            pos = xpos[p] + xmat[p] @ c.body_pos[i]
            R = xmat[p] if st.body_rot_identity[i] else xmat[p] @ c.body_rot[i]
        for jidx in model.body_joints[i]:
            j = model.joints[jidx]
            if j.jtype == JointType.SLIDE:
                axis_w = R @ c.axis[jidx]
                pos = pos + axis_w * (qpos[:, j.qposadr] - j.ref)[:, None]
                cdof_rows[j.dofadr] = torch.cat(
                    [c.zeros3.expand(B, 3), axis_w], dim=-1)
            elif j.jtype == JointType.HINGE:
                axis_w = R @ c.axis[jidx]
                angle = (qpos[:, j.qposadr] - j.ref)[:, None, None]
                K, KK = c.K[jidx]
                Rj = c.eye3 + torch.sin(angle) * K \
                    + (1.0 - torch.cos(angle)) * KK
                R = R @ Rj
                cdof_rows[j.dofadr] = torch.cat(
                    [axis_w, _cross(axis_w, -pos)], dim=-1)
            else:  # BALL: qvel in the child (post-joint) frame
                q_j = qpos[:, j.qposadr:j.qposadr + 4]
                q_j = q_j / torch.linalg.vector_norm(q_j, dim=-1,
                                                     keepdim=True)
                R = R @ quat2mat(q_j.T).permute(2, 0, 1)
                for k in range(3):
                    axis_w = R[:, :, k]
                    cdof_rows[j.dofadr + k] = torch.cat(
                        [axis_w, _cross(axis_w, -pos)], dim=-1)
        xpos[i], xmat[i] = pos, R

    xpos_a = torch.stack(xpos, dim=1)
    ximat = torch.stack(xmat, dim=1)
    xquat = mat2quat(ximat.permute(2, 3, 0, 1)).permute(1, 2, 0)
    xipos = xpos_a + torch.sum(ximat * body_ipos[..., None, :], dim=-1)
    return Kinematics(xpos=xpos_a, xquat=xquat, ximat=ximat, xipos=xipos,
                      cdof=torch.stack(cdof_rows, dim=1), origin=origin)


def compute_dynamics(model: PhysModel, params: PhysParams,
                     qpos: torch.Tensor, qvel: torch.Tensor) -> Dynamics:
    """Velocities, mass matrix and bias forces (engine.py:479-563) as masked
    products over the static ancestor structure; Minv = (M + hD)^-1 through
    `batched_spd_inverse` (K3-bf on the card)."""
    kin = forward_kinematics(model, params, qpos)
    c = _EnvConsts.of(model, qpos.device)
    B, nb = qpos.shape[0], model.nbody

    wdof = kin.cdof * qvel[:, :, None]                    # (B, nv, 6)
    body_vel = c.A @ wdof                                 # (B, nb, 6)
    v_pre = c.strict @ wdof
    cdof_dot = _cross_motion_batch(v_pre, kin.cdof)

    # spatial inertias about the origin, R I0 R^T and the skew square as
    # broadcast-multiply-reduce forms (engine.py:511-529)
    R = kin.ximat
    T = torch.sum(R[..., :, :, None] * c.I0[..., None, :, :], dim=-2)
    I_world = torch.sum(T[..., :, None, :] * R[..., None, :, :], dim=-1)
    cpos = kin.xipos
    ccT = cpos[..., :, None] * cpos[..., None, :]
    cc = torch.sum(cpos * cpos, dim=-1)
    CC = ccT - cc[..., None, None] * c.eye3
    C = _skew(cpos)
    mass = params.body_mass[:, :, None, None]             # (B, nb, 1, 1)
    upper_left = I_world - mass * CC
    mC = mass * C
    inertias = torch.cat([
        torch.cat([upper_left, mC], dim=-1),
        torch.cat([-mC, mass * c.eye3.expand(B, nb, 3, 3)], dim=-1),
    ], dim=-2)                                            # (B, nb, 6, 6)

    # RNEA bias with qacc = 0, gravity as base acceleration
    body_acc = c.a0 + c.A @ (cdof_dot * qvel[:, :, None])
    Iv = torch.sum(inertias * body_vel[..., None, :], dim=-1)
    body_frc = torch.sum(inertias * body_acc[..., None, :], dim=-1) \
        + _cross_force_batch(body_vel, Iv)
    F_sub = c.AT @ body_frc                               # (B, nv, 6)
    qfrc_bias = torch.sum(kin.cdof * F_sub, dim=-1)

    # CRBA: composite inertia per dof
    Ic_dof = torch.einsum("bv,nbij->nvij", c.A, inertias)
    H = torch.sum(Ic_dof * kin.cdof[:, :, None, :], dim=-1)
    M_full = torch.sum(H[:, :, None, :] * kin.cdof[:, None, :, :], dim=-1)
    Ml = M_full * c.crba_mask
    M = Ml + Ml.transpose(1, 2) - torch.diag_embed(
        torch.diagonal(Ml, dim1=1, dim2=2))
    M = M + torch.diag(c.armature)

    Minv = batched_spd_inverse(
        M + torch.diag_embed(model.timestep * params.dof_damping))
    return Dynamics(kin=kin, body_vel=body_vel, cdof_dot=cdof_dot, M=M,
                    Minv=Minv, qfrc_bias=qfrc_bias)


def _point_jacobian(model: PhysModel, kin: Kinematics, body: int,
                    point: torch.Tensor) -> torch.Tensor:
    """(B, 3, nv) translational jacobian of the origin-shifted world point
    (B, 3) on `body`."""
    c = _EnvConsts.of(model, point.device)
    cols = _cross(kin.cdof[..., :3], point[:, None, :]) + kin.cdof[..., 3:]
    return (c.A[body][:, None] * cols).transpose(1, 2)


def constraint_forces(model: PhysModel, params: PhysParams, dyn: Dynamics,
                      qvel: torch.Tensor) -> Tuple[torch.Tensor, ContactInfo]:
    """Contacts as soft constraints scaled by the diagonal Delassus
    approximation m_eff = 1 / diag(J Minv J^T) (engine.py:585-663)."""
    kin = dyn.kin
    c = _EnvConsts.of(model, qvel.device)
    B, nv = qvel.shape
    tau_c = model.solref_timeconst
    zeta = model.solref_dampratio
    k_unit = 1.0 / (tau_c * tau_c * zeta * zeta)
    b_unit = 2.0 / tau_c

    qfrc = qvel.new_zeros((B, nv))
    nc = len(model.contacts)
    if not nc:
        z = qvel.new_zeros
        return qfrc, ContactInfo(force=z((B, 0, 3)), depth=z((B, 0)),
                                 pos=z((B, 0, 3)), vel=z((B, 0, 3)))

    n_w = quat_rotate(params.floor_quat.T, c.ez[:, None].expand(3, B)).T
    floor_p = params.floor_pos - kin.origin               # (B, 3)
    cb = c.con_body
    p = kin.xpos[:, cb] + torch.sum(
        kin.ximat[:, cb] * c.con_offset[:, None, :], dim=-1)     # (B, nc, 3)
    radius = c.con_radius
    depth_plane = radius - torch.sum((p - floor_p[:, None]) * n_w[:, None],
                                     dim=-1)
    p_world = p + kin.origin[:, None]
    if model.enable_hfield:
        h, dhdx, dhdy = hfield_lookup(params, p_world[..., 0:2])
        n_h = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=-1)
        n_h = n_h / torch.linalg.vector_norm(n_h, dim=-1, keepdim=True)
        depth_h = radius + (params.floor_pos[:, 2:3] + h) - p_world[..., 2]
        active = (params.hfield_active > 0.5)[:, None]
        depth = torch.where(active, depth_h, depth_plane)
        n_c = torch.where(active[..., None], n_h,
                          n_w[:, None].expand(n_h.shape))
    else:
        depth = depth_plane
        n_c = n_w[:, None].expand(B, nc, 3)

    bv = dyn.body_vel[:, cb]                              # (B, nc, 6)
    v_p = bv[..., 3:] + _cross(bv[..., :3], p)

    cols = (_cross(kin.cdof[:, None, :, :3], p[:, :, None, :])
            + kin.cdof[:, None, :, 3:])                   # (B, nc, nv, 3)
    J = c.con_mask[:, :, None] * cols
    JM = torch.einsum("bcvi,bvw->bcwi", J, dyn.Minv)
    G = torch.einsum("bcwi,bcwj->bcij", JM, J)            # (B, nc, 3, 3)
    g_n = torch.einsum("bci,bcij,bcj->bc", n_c, G, n_c)
    m_n = 1.0 / torch.clamp(g_n, min=1e-8)
    vn = torch.sum(v_p * n_c, dim=-1)
    fn = torch.clamp(m_n * (k_unit * depth - b_unit * vn), min=0.0)
    fn = torch.where(depth > 0, fn, 0.0)

    vt = v_p - vn[..., None] * n_c
    vt_norm = torch.linalg.vector_norm(vt, dim=-1) + 1e-9
    trG = G[..., 0, 0] + G[..., 1, 1] + G[..., 2, 2]
    m_t = 1.0 / torch.clamp((trG - g_n) / 2.0, min=1e-8)
    # stiction cap: the force that would stop sliding within ~2 steps
    f_stick = m_t * vt_norm / (2.0 * model.timestep)
    ft_mag = torch.minimum(params.friction[:, None] * fn, f_stick)
    ft = -(ft_mag / vt_norm)[..., None] * vt

    f = fn[..., None] * n_c + ft                          # (B, nc, 3)
    qfrc = qfrc + torch.einsum("bcvi,bci->bv", J, f)
    return qfrc, ContactInfo(force=f, depth=depth, pos=p_world, vel=v_p)


def equality_jacobian(model: PhysModel, dyn: Dynamics
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(J_eq (B, 3 neq, nv), err (B, 3 neq)) of the loop-closure connects
    (engine.py:666-688)."""
    kin = dyn.kin
    c = _EnvConsts.of(model, kin.origin.device)
    rows, errs = [], []
    for eq, (a1, a2) in zip(model.equalities, c.eq_anchor):
        b1, b2 = eq.body1, eq.body2
        p1 = kin.xpos[:, b1] + kin.ximat[:, b1] @ a1
        p2 = kin.xpos[:, b2] + kin.ximat[:, b2] @ a2
        errs.append(p1 - p2)
        rows.append(_point_jacobian(model, kin, b1, p1)
                    - _point_jacobian(model, kin, b2, p2))
    return torch.cat(rows, dim=1), torch.cat(errs, dim=1)


def joint_limit_forces(model: PhysModel, params: PhysParams, dyn: Dynamics,
                       qpos: torch.Tensor, qvel: torch.Tensor
                       ) -> torch.Tensor:
    """Soft joint-limit torques on the limited hinges and slides."""
    c = _EnvConsts.of(model, qpos.device)
    B = qpos.shape[0]
    if len(c.lim_dof) == 0:
        return qpos.new_zeros((B, model.nv))
    tau_c = model.solref_timeconst
    zeta = model.solref_dampratio
    k_unit = 1.0 / (tau_c * tau_c * zeta * zeta)
    b_unit = 2.0 / tau_c

    q = qpos[:, c.lim_qadr]
    qd = qvel[:, c.lim_dof]
    m_eff = 1.0 / torch.clamp(
        torch.diagonal(dyn.Minv, dim1=1, dim2=2)[:, c.lim_dof], min=1e-8)
    below = c.lim_lo - q
    above = q - c.lim_hi
    f_lo = torch.where(below > 0, m_eff * (k_unit * below - b_unit * qd), 0.0)
    f_hi = torch.where(above > 0, m_eff * (k_unit * above + b_unit * qd), 0.0)
    f = torch.clamp(f_lo, min=0.0) - torch.clamp(f_hi, min=0.0)
    return qpos.new_zeros((B, model.nv)).index_add_(1, c.lim_dof, f)


def passive_forces(model: PhysModel, qpos: torch.Tensor) -> torch.Tensor:
    """Joint springs: -stiffness * qpos (springref 0)."""
    c = _EnvConsts.of(model, qpos.device)
    return -c.spring_k * qpos[:, c.spring_qadr]


def actuator_forces(model: PhysModel, ctrl: torch.Tensor) -> torch.Tensor:
    """qfrc = gear * clip(ctrl, ctrlrange) on the actuated dofs."""
    B = ctrl.shape[0]
    if model.nu == 0:
        return ctrl.new_zeros((B, model.nv))
    c = _EnvConsts.of(model, ctrl.device)
    u = torch.minimum(torch.maximum(ctrl, c.act_lo), c.act_hi)
    return ctrl.new_zeros((B, model.nv)).index_add_(1, c.act_dof,
                                                     c.act_gear * u)


def _external_wrench(model: PhysModel, dyn: Dynamics,
                     wrench: torch.Tensor) -> torch.Tensor:
    """Generalized force of a world [torque, force] wrench (B, 6) at the
    root body origin."""
    kin = dyn.kin
    c = _EnvConsts.of(model, wrench.device)
    tau, F = wrench[:, :3], wrench[:, 3:]
    w = torch.cat([tau + _cross(kin.xpos[:, 0], F), F], dim=-1)
    return torch.sum(kin.cdof * w[:, None, :], dim=-1) * c.A[0]


def step(model: PhysModel, params: PhysParams, qpos: torch.Tensor,
         qvel: torch.Tensor, ctrl: torch.Tensor) -> StepOut:
    """One per-env physics substep of the fleet, batch-first: params from
    `params_batch_first`, qpos (B, nq), qvel (B, nv), ctrl (B, nu). The
    port of `_step_single` under vmap (engine.py:809-866): smooth forces
    and penalty contacts and limits at the acceleration level, implicit
    damping, loop-closure connects as velocity-level impulses."""
    dyn = compute_dynamics(model, params, qpos, qvel)

    qfrc_con, contact = constraint_forces(model, params, dyn, qvel)
    qfrc_lim = joint_limit_forces(model, params, dyn, qpos, qvel)
    qfrc_spring = passive_forces(model, qpos)
    qfrc_act = actuator_forces(model, ctrl)
    qfrc_ext = _external_wrench(model, dyn, params.ext_force)

    qfrc = (qfrc_act + qfrc_spring + qfrc_con + qfrc_lim + qfrc_ext
            - dyn.qfrc_bias)
    # implicit damping: (M + hD) dv = h (qfrc - D qvel)
    h = model.timestep
    Ainv = dyn.Minv
    qacc_free = (Ainv @ (qfrc - params.dof_damping * qvel)[..., None])[..., 0]
    v_pred = qvel + h * qacc_free

    if model.equalities:
        # velocity-level impulse G lambda = -(J v_pred + beta/h err),
        # Jacobi-preconditioned; the solve is the plain unrolled Cholesky
        # with pivot floor 1e-4, as in JAX (not K3)
        J_eq, err = equality_jacobian(model, dyn)
        G = J_eq @ Ainv @ J_eq.transpose(1, 2)
        d = torch.rsqrt(torch.diagonal(G, dim1=1, dim2=2) + 1e-12)
        Gs = d[:, :, None] * G * d[:, None, :] \
            + 1e-6 * torch.eye(G.shape[-1], device=G.device)
        rhs = -((J_eq @ v_pred[..., None])[..., 0]
                + (BAUMGARTE_BETA / h) * err)
        lam = d * spd_solve(Gs, d * rhs, pivot_floor=1e-4)
        new_qvel = v_pred + (Ainv @ (J_eq.transpose(1, 2)
                                     @ lam[..., None]))[..., 0]
    else:
        new_qvel = v_pred

    qacc = (new_qvel - qvel) / h
    new_qpos = _integrate_qpos(model, qpos, new_qvel, h)

    if model.nu:
        c = _EnvConsts.of(model, ctrl.device)
        act_torque = c.act_gear * torch.minimum(
            torch.maximum(ctrl, c.act_lo), c.act_hi)
    else:
        act_torque = ctrl.new_zeros((ctrl.shape[0], 0))
    return StepOut(qpos=new_qpos, qvel=new_qvel, qacc=qacc, contact=contact,
                   kin=dyn.kin, actuator_torque=act_torque)


def _integrate_qpos(model: PhysModel, qpos: torch.Tensor, qvel: torch.Tensor,
                    h: float) -> torch.Tensor:
    c = _EnvConsts.of(model, qpos.device)
    st = _Structure.of(model)
    new_qpos = qpos.index_add(1, c.lin_qadr, h * qvel[:, c.lin_dof])
    # ball quaternions: body-frame angular velocity, exponential map
    for qadr, dofadr in st.balls:
        q = qpos[:, qadr:qadr + 4]
        w = qvel[:, dofadr:dofadr + 3]
        new_qpos[:, qadr:qadr + 4] = quat_integrate(q.T, w.T, h).T
    return new_qpos


def total_energy(model: PhysModel, params: PhysParams, qpos: torch.Tensor,
                 qvel: torch.Tensor) -> torch.Tensor:
    """Kinetic + gravitational + joint-spring potential energy, (B,)."""
    c = _EnvConsts.of(model, qpos.device)
    dyn = compute_dynamics(model, params, qpos, qvel)
    ke = torch.sum(((0.5 * qvel)[:, None, :] @ dyn.M)[:, 0] * qvel, dim=-1)
    pe = -torch.sum(params.body_mass * (
        (dyn.kin.xipos + dyn.kin.origin[:, None]) @ c.gravity), dim=-1)
    se = qpos.new_zeros(qpos.shape[0])
    for j in model.joints:
        if j.stiffness != 0.0 and j.jtype != JointType.BALL:
            se = se + 0.5 * j.stiffness * qpos[:, j.qposadr] ** 2
    return ke + pe + se
