"""K2: whole-fleet forward kinematics, as a CUDA kernel.

Counterpart of `apex_tpu/physics/fleet_fk.py`, whose Pallas kernel runs the
position pass of every env in one program. The kernel here is
`csrc/fleet_fk.cu`, one thread per env walking the tree from two small
tables built from the model (`_fk_tables`). Its plain version, `fk_plain`,
is the port of the XLA branch of `apex_tpu/physics/fleet.py:_fk_bt`. The
wrapper `fleet_fk` takes the plain version for tensors on the CPU only; for
CUDA tensors it launches the kernel or raises.

Batch-last throughout: qpos (nq, B), body_ipos (nb, 3, B).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from apex_tpu_torch.ops import cuda_build
from apex_tpu_torch.physics.engine import _Structure
from apex_tpu_torch.physics.spec import JointType, PhysModel


class FleetKin(NamedTuple):
    xpos: torch.Tensor    # (nb, 3, B)
    ximat: torch.Tensor   # (nb, 3, 3, B)
    xipos: torch.Tensor   # (nb, 3, B)
    cdof: torch.Tensor    # (nv, 6, B)
    origin: torch.Tensor  # (3, B)


# ---------------------------------------------------------------------------
# batch-last helpers (apex_tpu/physics/fleet.py): arrays are shape + (B,)
# ---------------------------------------------------------------------------

def _cross_bt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over axis -2 of (..., 3, B) arrays."""
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-2)


def _mat_mul_c(R: torch.Tensor, C: np.ndarray) -> torch.Tensor:
    """(3, 3, B) @ constant (3, 3), skipping the zero entries of C."""
    rows = []
    for i in range(3):
        cols = []
        for j in range(3):
            t = None
            for k in range(3):
                c = float(C[k, j])
                if c == 0.0:
                    continue
                term = R[i, k] if c == 1.0 else R[i, k] * c
                t = term if t is None else t + term
            cols.append(torch.zeros_like(R[0, 0]) if t is None else t)
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def _mat_mul_bt(A: torch.Tensor, B_: torch.Tensor) -> torch.Tensor:
    """(3, 3, B) @ (3, 3, B)."""
    return torch.stack([
        torch.stack([A[i, 0] * B_[0, j] + A[i, 1] * B_[1, j]
                     + A[i, 2] * B_[2, j] for j in range(3)])
        for i in range(3)])


def _matvec_c(R: torch.Tensor, v: np.ndarray) -> torch.Tensor:
    """(3, 3, B) @ constant (3,)."""
    out = []
    for i in range(3):
        t = None
        for k in range(3):
            c = float(v[k])
            if c == 0.0:
                continue
            term = R[i, k] if c == 1.0 else R[i, k] * c
            t = term if t is None else t + term
        out.append(torch.zeros_like(R[0, 0]) if t is None else t)
    return torch.stack(out)


def _quat2mat_bt(q: torch.Tensor) -> torch.Tensor:
    """(4, B) wxyz -> (3, 3, B)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


# ---------------------------------------------------------------------------
# plain version: port of the XLA branch of fleet._fk_bt
# ---------------------------------------------------------------------------

def fk_plain(model: PhysModel, body_ipos: torch.Tensor,
             qpos: torch.Tensor) -> FleetKin:
    """qpos (nq, B), body_ipos (nb, 3, B) -> FleetKin, origin-shifted by
    the root translation."""
    nb, nv = model.nbody, model.nv
    st = _Structure.of(model)
    B = qpos.shape[-1]
    dev, dt = qpos.device, qpos.dtype
    xpos: List = [None] * nb
    xmat: List = [None] * nb
    cdof_rows: List = [None] * nv

    origin = (qpos[0:3] if nv >= 3
              else torch.zeros((3, B), dtype=dt, device=dev))

    def const(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    for i in range(nb):
        p = model.body_parent[i]
        if p == -1:
            pos = const(model.body_pos[i])[:, None] - origin
            R = const(st.body_rot[i])[:, :, None].expand(3, 3, B)
        else:
            bp = model.body_pos[i]
            pos = xpos[p]
            for k in range(3):
                if bp[k] != 0.0:
                    pos = pos + xmat[p][:, k] * float(bp[k])
            if st.body_rot_identity[i]:
                R = xmat[p]
            else:
                R = _mat_mul_c(xmat[p], st.body_rot[i])

        for jidx in model.body_joints[i]:
            j = model.joints[jidx]
            if j.jtype == JointType.SLIDE:
                axis_w = _matvec_c(R, np.asarray(j.axis))
                pos = pos + axis_w * (qpos[j.qposadr] - j.ref)[None, :]
                cdof_rows[j.dofadr] = torch.cat(
                    [torch.zeros_like(axis_w), axis_w], dim=0)
            elif j.jtype == JointType.HINGE:
                axis_w = _matvec_c(R, np.asarray(j.axis))
                angle = qpos[j.qposadr] - j.ref
                K, KK = st.joint_K[jidx]
                RK = _mat_mul_c(R, K)
                RKK = _mat_mul_c(R, KK)
                s = torch.sin(angle)[None, None, :]
                c1 = (1.0 - torch.cos(angle))[None, None, :]
                R = R + s * RK + c1 * RKK
                cdof_rows[j.dofadr] = torch.cat(
                    [axis_w, _cross_bt(axis_w, -pos)], dim=0)
            else:  # BALL
                q_j = qpos[j.qposadr:j.qposadr + 4]
                q_j = q_j / torch.sqrt(torch.sum(q_j * q_j, dim=0,
                                                 keepdim=True))
                R = _mat_mul_bt(R, _quat2mat_bt(q_j))
                for k in range(3):
                    axis_w = R[:, k]
                    cdof_rows[j.dofadr + k] = torch.cat(
                        [axis_w, _cross_bt(axis_w, -pos)], dim=0)
        xpos[i], xmat[i] = pos, R

    xpos_a = torch.stack(xpos)                  # (nb, 3, B)
    ximat = torch.stack(xmat)                   # (nb, 3, 3, B)
    xipos = xpos_a + torch.sum(ximat * body_ipos[:, None, :, :], dim=2)
    return FleetKin(xpos=xpos_a, ximat=ximat, xipos=xipos,
                    cdof=torch.stack(cdof_rows), origin=origin)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _fk_tables(model: PhysModel, device: torch.device):
    """(itab, ftab) device tensors describing the tree for the kernel
    (layout documented in csrc/fleet_fk.cu); cached on the model per
    device."""
    cache = model.__dict__.setdefault("_fk_tables", {})
    if device in cache:
        return cache[device]
    st = _Structure.of(model)
    ints, floats, jints, jfloats = [], [], [], []
    for i in range(model.nbody):
        ints += [int(model.body_parent[i]), len(jints) // 4,
                 len(model.body_joints[i]), int(st.body_rot_identity[i])]
        floats += list(model.body_pos[i]) + list(st.body_rot[i].reshape(-1))
        for jidx in model.body_joints[i]:
            j = model.joints[jidx]
            K, KK = st.joint_K[jidx]
            jints += [int(j.jtype), j.qposadr, j.dofadr, 0]
            jfloats += (list(j.axis) + [j.ref] + list(K.reshape(-1))
                        + list(KK.reshape(-1)))
    itab = torch.tensor(ints + jints, dtype=torch.int32, device=device)
    ftab = torch.tensor(np.asarray(floats + jfloats, np.float32),
                        device=device)
    cache[device] = (itab, ftab)
    return itab, ftab


def fleet_fk(model: PhysModel, body_ipos: torch.Tensor,
             qpos: torch.Tensor) -> FleetKin:
    """Forward kinematics of the fleet: the CUDA kernel for CUDA tensors,
    `fk_plain` for CPU tensors."""
    if qpos.device.type == "cpu":
        return fk_plain(model, body_ipos, qpos)
    if qpos.device.type != "cuda":
        raise ValueError(f"fleet_fk: unsupported device {qpos.device}")
    nb, nv, nq = model.nbody, model.nv, model.nq
    B = qpos.shape[-1]
    for name, x, shape in (("qpos", qpos, (nq, B)),
                           ("body_ipos", body_ipos, (nb, 3, B))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous() or x.device != qpos.device:
            raise ValueError(
                f"fleet_fk: {name} must be a contiguous float32 {shape} "
                f"tensor on {qpos.device}, got {x.dtype} {tuple(x.shape)} "
                f"contiguous={x.is_contiguous()} on {x.device}")
    itab, ftab = _fk_tables(model, qpos.device)
    xpos = torch.empty((nb, 3, B), dtype=qpos.dtype, device=qpos.device)
    ximat = torch.empty((nb, 3, 3, B), dtype=qpos.dtype, device=qpos.device)
    xipos = torch.empty((nb, 3, B), dtype=qpos.dtype, device=qpos.device)
    cdof = torch.empty((nv, 6, B), dtype=qpos.dtype, device=qpos.device)
    lib = cuda_build.library()
    err = lib.apex_fleet_fk(
        qpos.data_ptr(), body_ipos.data_ptr(), xpos.data_ptr(),
        ximat.data_ptr(), xipos.data_ptr(), cdof.data_ptr(), itab.data_ptr(),
        ftab.data_ptr(), nb, int(nv >= 3), B,
        torch.cuda.current_stream(qpos.device).cuda_stream)
    cuda_build.check(err, "apex_fleet_fk")
    fleet_fk.launches += 1
    origin = (qpos[0:3] if nv >= 3
              else torch.zeros((3, B), dtype=qpos.dtype, device=qpos.device))
    return FleetKin(xpos=xpos, ximat=ximat, xipos=xipos, cdof=cdof,
                    origin=origin)


fleet_fk.launches = 0
