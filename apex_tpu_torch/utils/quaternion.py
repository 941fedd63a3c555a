"""Quaternion and rotation utilities (wxyz), batch-last.

Port of `apex_tpu/utils/quaternion.py`. The JAX functions keep the
component on the LAST axis; here it is the FIRST axis, and any batch
dimensions trail it (q: (4, ...), v: (3, ...)), the batch-last layout of
the rest of the port.
"""
from __future__ import annotations

import torch

from apex_tpu_torch.device import const

# left-multiplication table: (q1 * q2)[r] = sum_c SIGN[r, c] q1[IDX[r, c]] q2[c]
_MUL_IDX = ((0, 1, 2, 3), (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0))
_MUL_SIGN = ((1.0, -1.0, -1.0, -1.0), (1.0, 1.0, -1.0, 1.0),
             (1.0, 1.0, 1.0, -1.0), (1.0, -1.0, 1.0, 1.0))


def _col(values, ref: torch.Tensor, extra_dims: int) -> torch.Tensor:
    """Constant `values` on ref's device, with `extra_dims` trailing unit
    dims to broadcast against ref's batch dims."""
    t = const(values, ref.device, ref.dtype)
    return t.reshape(t.shape + (1,) * extra_dims)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion (quaternion_function.py:4-7)."""
    return q * _col((1.0, -1.0, -1.0, -1.0), q, q.dim() - 1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1*q2 (quaternion_function.py:9-15)."""
    q1, q2 = torch.broadcast_tensors(q1, q2)
    idx = const(_MUL_IDX, q1.device, torch.int64)
    left = q1[idx] * _col(_MUL_SIGN, q1, q1.dim() - 1)    # (4, 4, ...)
    return torch.sum(left * q2[None], dim=1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q (active, world = R(q) @ body), as the reference
    rotate_by_quaternion (quaternion_function.py:17-25):
    v' = v + 2 w (u x v) + 2 u x (u x v)."""
    w, u = q[0:1], q[1:4]
    uv = torch.linalg.cross(u, v, dim=0)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=0))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q (world -> body)."""
    return quat_rotate(quat_inverse(q), v)


def euler2quat(z=0.0, y=0.0, x=0.0) -> torch.Tensor:
    """ZYX euler (radians) -> wxyz quaternion with w >= 0
    (quaternion_function.py:54-72)."""
    dev = next((a.device for a in (z, y, x) if isinstance(a, torch.Tensor)),
               None)
    z, y, x = torch.broadcast_tensors(*(
        torch.as_tensor(a, dtype=torch.float32, device=dev) / 2.0
        for a in (z, y, x)))
    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    q = torch.stack([
        cx * cy * cz - sx * sy * sz,
        cx * sy * sz + cy * cz * sx,
        cx * cz * sy - sx * cy * sz,
        cx * cy * sz + sx * cz * sy,
    ])
    return torch.where(q[0:1] < 0, -q, q)


def quat2euler(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion -> (roll_x, pitch_y, yaw_z) radians
    (quaternion_function.py:27-52)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw])


def quat2mat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion (4, ...) -> rotation matrix (3, 3, ...)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ])
    return m.reshape((3, 3) + q.shape[1:])


# mat2quat: the four candidate encodings, each stable in a different
# region. Candidate k's squared scale is 1 + SGN[k] . diag(m); its other
# three components are combinations of the off-diagonal entries.
_M2Q_SGN = ((1.0, 1.0, 1.0), (1.0, -1.0, -1.0), (-1.0, 1.0, -1.0),
            (-1.0, -1.0, 1.0))
# off-diagonal combinations [m21-m12, m02-m20, m10-m01, m01+m10, m02+m20,
# m12+m21] as (index a, index b, sign of b) into the flattened matrix
_M2Q_OFF = ((7, 5, -1.0), (2, 6, -1.0), (3, 1, -1.0), (1, 3, 1.0),
            (2, 6, 1.0), (5, 7, 1.0))
# component c of candidate k: off-diagonal combination index, or -1 for
# the scale term s_k / 4
_M2Q_NUM = ((-1, 0, 1, 2), (0, -1, 3, 4), (1, 3, -1, 5), (2, 4, 5, -1))


def mat2quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3, 3, ...) -> wxyz quaternion (4, ...) with w >= 0:
    the branch-free max-trace formulation of apex_tpu's mat2quat, with the
    four candidates computed as stacked tensors."""
    extra = m.dim() - 2
    flat = m.reshape((9,) + m.shape[2:])
    diag = flat[const([0, 4, 8], m.device, torch.int64)]                                    # (3, ...)
    sgn = _col(_M2Q_SGN, m, extra)                            # (4, 3, ...)
    s = torch.sqrt(torch.clamp(1.0 + torch.sum(sgn * diag[None], dim=1),
                               min=1e-12)) * 2.0              # (4, ...)
    ia = const([o[0] for o in _M2Q_OFF], m.device, torch.int64)
    ib = const([o[1] for o in _M2Q_OFF], m.device, torch.int64)
    off = flat[ia] + _col([o[2] for o in _M2Q_OFF], m, extra) * flat[ib]
    num_idx = const([[max(i, 0) for i in row] for row in _M2Q_NUM],
                    m.device, torch.int64)
    is_scale = _col([[i < 0 for i in row] for row in _M2Q_NUM], m, extra) > 0
    cand = torch.where(is_scale, s[:, None] / 4.0, off[num_idx] / s[:, None])

    m00, m11, m22 = diag[0], diag[1], diag[2]
    tr = m00 + m11 + m22
    pick = torch.where(tr > 0.0, 0, torch.where(
        (m00 >= m11) & (m00 >= m22), 1, torch.where(m11 >= m22, 2, 3)))
    q = torch.gather(cand, 0, pick[None, None].expand((1,) + cand.shape[1:]))[0]
    q = q / torch.sqrt(torch.sum(q * q, dim=0, keepdim=True))
    return torch.where(q[0:1] < 0, -q, q)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate unit quaternions q (4, ...) by body-frame angular velocity
    omega (3, ...) over dt: q' = q * exp(0.5 dt omega), renormalized."""
    angle = torch.sqrt(torch.sum(omega * omega, dim=0, keepdim=True)) * dt
    half = 0.5 * angle
    small = angle < 1e-8
    k = torch.where(small, 0.5 * dt,
                    torch.sin(half) * dt / torch.where(small, 1.0, angle))
    dq = torch.cat([torch.cos(half), omega * k], dim=0)
    out = quat_mul(q, dq)
    return out / torch.sqrt(torch.sum(out * out, dim=0, keepdim=True))


def axis_angle_to_quat(axis: torch.Tensor, angle) -> torch.Tensor:
    """Unit axis (3, ...) + angle -> wxyz quaternion (4, ...)."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = angle / 2.0
    return torch.cat([torch.cos(half)[None], axis * torch.sin(half)[None]])
