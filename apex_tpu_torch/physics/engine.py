"""Model metadata and dynamic parameters of the rigid-body engine.

Port of the parts of `apex_tpu/physics/engine.py` that the batch-last fleet
path needs: the dynamic `PhysParams` (here batch-last tensors), the engine
constants, and the numpy tree metadata `_Structure` (copied verbatim) from
which the fleet step builds its constant masks and the FK kernel its
tables. The per-env engine (`engine._step_single`) is not ported: the fleet
path is its own reference here, held against the JAX fleet in the tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from apex_tpu_torch.device import const
from apex_tpu_torch.physics.spec import DOF_WIDTH, JointType, PhysModel

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
