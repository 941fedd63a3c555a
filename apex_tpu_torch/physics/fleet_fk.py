"""K2: whole-fleet forward kinematics, as a CUDA kernel.

Counterpart of `apex_tpu/physics/fleet_fk.py`, whose Pallas kernel runs the
position pass of every env in one program. The kernel here is
`csrc/fleet_fk.cu`, one warp per env walking the tree by depth, three lanes
per body, from tables built from the model (`_fk_tables`, with the walk's
schedule from `fk_schedule`). Its plain version, `fk_plain`,
is the port of the XLA branch of `apex_tpu/physics/fleet.py:_fk_bt`. The
wrapper `fleet_fk` takes the plain version for tensors on the CPU only; for
CUDA tensors it launches the kernel or raises.

Batch-last throughout: qpos (nq, B), body_ipos (nb, 3, B).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple

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

class FkTables(NamedTuple):
    itab: torch.Tensor   # int32, layout in csrc/fleet_fk.cu
    ftab: torch.Tensor   # float32
    stride: int          # floats of shared memory per env


BODIES_PER_ROUND = 10    # three lanes per body in a warp of 32
JOINT_SCRATCH = 12       # csrc/fleet_fk.cu kJointScratch


def fk_schedule(model: PhysModel):
    """The kernel's walk: (rounds, cross). `rounds` lists the bodies of
    each round, the tree by depth in chunks of at most BODIES_PER_ROUND,
    so every parent lies in an earlier round; `cross` lists (dof, joint)
    for each hinge and ball dof, whose linear part is formed after the
    walk. Takes any tree in topological order (parent before child)."""
    depth = []
    for i in range(model.nbody):
        p = int(model.body_parent[i])
        if p >= i:
            raise ValueError(f"body {i}: parent {p} is not before it")
        depth.append(0 if p < 0 else depth[p] + 1)
    rounds = []
    for d in range(max(depth) + 1):
        level = [i for i in range(model.nbody) if depth[i] == d]
        rounds += [level[k:k + BODIES_PER_ROUND]
                   for k in range(0, len(level), BODIES_PER_ROUND)]
    cross = [(j.dofadr + k, jidx) for jidx, j in enumerate(model.joints)
             if j.jtype != JointType.SLIDE
             for k in range(1 if j.jtype == JointType.HINGE else 3)]
    return rounds, cross


def kin_views(model: PhysModel, out: torch.Tensor,
              origin: torch.Tensor) -> FleetKin:
    """FleetKin over the kernel's one output buffer (15 nbody + 6 nv, B):
    its rows are xpos, xmat, xipos and cdof, each a contiguous view."""
    nb, nv, B = model.nbody, model.nv, out.shape[-1]
    return FleetKin(xpos=out[:3 * nb].view(nb, 3, B),
                    ximat=out[3 * nb:12 * nb].view(nb, 3, 3, B),
                    xipos=out[12 * nb:15 * nb].view(nb, 3, B),
                    cdof=out[15 * nb:].view(nv, 6, B), origin=origin)


def _fk_tables(model: PhysModel, device: torch.device) -> FkTables:
    """The tables describing the tree and the walk for the kernel (layout
    documented in csrc/fleet_fk.cu); cached on the model per device."""
    cache = model.__dict__.setdefault("_fk_tables", {})
    if device in cache:
        return cache[device]
    if not model.joints:
        raise ValueError("fleet_fk: the kernel takes a model with joints")
    st = _Structure.of(model)
    nb, nv, nq = model.nbody, model.nv, model.nq
    rounds, cross = fk_schedule(model)
    # joint rows run body by body, so a body's joints are consecutive
    rows = [jidx for i in range(nb) for jidx in model.body_joints[i]]
    row_of = {jidx: r for r, jidx in enumerate(rows)}
    offsets = np.cumsum([0] + [len(r) for r in rounds]).tolist()
    offsets += [0] * (-len(offsets) % 4)
    recs, bfloats = [], []
    for i in (i for r in rounds for i in r):
        js = model.body_joints[i]
        recs += [i, int(model.body_parent[i]), row_of[js[0]] if js else 0,
                 len(js) | int(st.body_rot_identity[i]) << 8]
        bfloats += list(model.body_pos[i]) + list(st.body_rot[i].reshape(-1))
    jints, jfloats = [], []
    for jidx in rows:
        j = model.joints[jidx]
        K, KK = st.joint_K[jidx]
        jints += [int(j.jtype), j.qposadr, j.dofadr, 0]
        jfloats += (list(j.axis) + [j.ref] + list(K.reshape(-1))
                    + list(KK.reshape(-1)) + [0.0, 0.0])
    sched = [x for dof, jidx in cross for x in (dof, row_of[jidx])]
    # staged floats per env: outputs, inputs, then (16-byte aligned) the
    # per-joint scratch; 4 more than a multiple of 32, so that the block's
    # 8 envs start on banks 4 apart and a warp's 8 envs x 4 rows of the
    # cooperative copies hit 32 banks
    n_io = (15 * nb + 6 * nv) + (nq + 3 * nb)
    stride = n_io + (-n_io % 4) + JOINT_SCRATCH * len(model.joints)
    stride += (4 - stride) % 32
    header = [nb, len(model.joints), len(rounds), len(cross), nq, nv,
              int(nv >= 3), stride]
    itab = torch.tensor(header + offsets + recs + jints + sched,
                        dtype=torch.int32, device=device)
    ftab = torch.tensor(np.asarray(bfloats + jfloats, np.float32),
                        device=device)
    cache[device] = FkTables(itab, ftab, stride)
    return cache[device]


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
    tabs = _fk_tables(model, qpos.device)
    out = torch.empty((15 * nb + 6 * nv, B), dtype=qpos.dtype,
                      device=qpos.device)
    lib = cuda_build.library()
    err = lib.apex_fleet_fk(
        qpos.data_ptr(), body_ipos.data_ptr(), out.data_ptr(),
        tabs.itab.data_ptr(), tabs.ftab.data_ptr(), tabs.itab.numel(),
        tabs.ftab.numel(), tabs.stride, B,
        torch.cuda.current_stream(qpos.device).cuda_stream)
    cuda_build.check(err, "apex_fleet_fk")
    fleet_fk.launches += 1
    origin = (qpos[0:3] if nv >= 3
              else torch.zeros((3, B), dtype=qpos.dtype, device=qpos.device))
    return kin_views(model, out, origin)


def launch_info(model: PhysModel) -> Dict[str, int]:
    """K2's launch shape for `model` on the current card: shared memory per
    block (the envs' staged rows and the model's tables), envs per block
    (a warp each), blocks and envs resident per SM."""
    tabs = _fk_tables(model, torch.device("cuda"))
    out = (ctypes.c_int * 4)()
    cuda_build.check(cuda_build.library().apex_fleet_fk_info(
        tabs.itab.numel(), tabs.ftab.numel(), tabs.stride, out),
        "apex_fleet_fk_info")
    return dict(smem_bytes_per_block=out[0], envs_per_block=out[1],
                blocks_per_sm=out[2], envs_per_sm=out[3])


fleet_fk.launches = 0
