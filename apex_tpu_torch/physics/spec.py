"""Static rigid-body model specification for the JAX physics engine.

TPU-native replacement for the reference's MJCF-compiled mjModel inside
libcassiemujoco.so (reference cassie/cassiemujoco/cassie.xml + the C API in
include/cassiemujoco.h:41-275). The model is built once on host (numpy +
python metadata), closed over by jitted step functions; everything the
reference mutates at runtime through `cassie_sim_set_*` (dof damping, body
mass, body ipos, geom friction, floor quat -- cassie.py:634-650) lives in the
dynamic `PhysParams` pytree instead of global sim state.

Conventions (MuJoCo-compatible):
  * quaternions wxyz; joint `ref` shifts the qpos zero (FK rotates by
    qpos - ref); spring equilibrium is springref (default 0).
  * bodies in topological order, parent index -1 = world.
  * a body may carry several joints (e.g. cassie pelvis = 3 slides + ball,
    cassie.xml:82-85); dof/qpos addresses are assigned sequentially.
"""
from __future__ import annotations

import dataclasses
from enum import IntEnum
from typing import List, Optional, Tuple

import numpy as np


class JointType(IntEnum):
    SLIDE = 0
    HINGE = 1
    BALL = 2


QPOS_WIDTH = {JointType.SLIDE: 1, JointType.HINGE: 1, JointType.BALL: 4}
DOF_WIDTH = {JointType.SLIDE: 1, JointType.HINGE: 1, JointType.BALL: 3}


@dataclasses.dataclass(frozen=True)
class Joint:
    body: int                 # body this joint moves
    jtype: JointType
    axis: np.ndarray          # (3,) unit, joint frame axis (slide/hinge)
    pos: np.ndarray           # (3,) anchor in body frame
    ref: float                # qpos value at the XML pose (hinge/slide)
    qposadr: int
    dofadr: int
    range: Tuple[float, float]
    limited: bool
    stiffness: float          # spring toward springref=0
    damping: float            # per dof
    armature: float           # per dof
    name: str = ""


@dataclasses.dataclass(frozen=True)
class Actuator:
    joint: int                # joint index (slide/hinge only)
    gear: float
    ctrlrange: Tuple[float, float]
    name: str = ""


@dataclasses.dataclass(frozen=True)
class ContactSphere:
    """Point-contact primitive vs the floor plane. Capsule/sphere collision
    geoms are decomposed into their defining spheres at build time (exact for
    sphere/capsule vs plane)."""
    body: int
    offset: np.ndarray        # (3,) center in body frame
    radius: float
    group: int                # 0 = left foot, 1 = right foot, 2 = other
    name: str = ""


@dataclasses.dataclass(frozen=True)
class EqualityConnect:
    """Ball-and-socket weld of a point on body1 to a point on body2
    (reference cassie.xml:225-230, the achilles/plantar rod loop closures)."""
    body1: int
    body2: int
    anchor1: np.ndarray       # (3,) in body1 frame
    anchor2: np.ndarray       # (3,) in body2 frame (derived at build time
                              # from the XML pose so the constraint starts
                              # satisfied, matching MuJoCo's compiler)
    torquescale: float = 0.0  # unused for connect


@dataclasses.dataclass(frozen=True)
class PhysModel:
    """Immutable model; all arrays numpy (host constants)."""
    nbody: int
    nq: int
    nv: int
    nu: int

    body_parent: np.ndarray       # (nbody,) int, -1 = world
    body_pos: np.ndarray          # (nbody, 3) frame offset in parent frame
    body_quat: np.ndarray         # (nbody, 4)
    body_mass: np.ndarray         # (nbody,)
    body_ipos: np.ndarray         # (nbody, 3) com in body frame
    body_inertia: np.ndarray      # (nbody, 3, 3) about com, body frame

    joints: Tuple[Joint, ...]
    body_joints: Tuple[Tuple[int, ...], ...]   # joint indices per body
    actuators: Tuple[Actuator, ...]
    contacts: Tuple[ContactSphere, ...]
    equalities: Tuple[EqualityConnect, ...]

    dof_damping: np.ndarray       # (nv,)
    dof_armature: np.ndarray      # (nv,)
    qpos0: np.ndarray             # (nq,) reference configuration

    gravity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, -9.81]))
    # floor plane (from the worldbody plane geom; cassie.xml:73 puts it at
    # z = -0.01)
    floor_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    floor_quat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
    timestep: float = 0.0005
    # STATIC heightfield-terrain switch: when False the contact pass skips
    # the hfield table lookups entirely (4 gathers per contact per substep,
    # measured ~0.6 ms per substep at fleet 1024 -- a pure waste on flat
    # ground). Terrain runs use dataclasses.replace(model,
    # enable_hfield=True); the runtime hfield_active toggle in PhysParams
    # then selects hfield vs plane per env.
    enable_hfield: bool = False
    # constraint softness, MuJoCo solref = (timeconst, dampratio)
    # (cassie.xml:18-19: geoms and equalities both 0.005 1)
    solref_timeconst: float = 0.005
    solref_dampratio: float = 1.0

    body_names: Tuple[str, ...] = ()

    def body_id(self, name: str) -> int:
        return self.body_names.index(name)

    @property
    def dof_body(self) -> np.ndarray:
        """(nv,) body index owning each dof."""
        out = np.zeros(self.nv, dtype=np.int32)
        for j in self.joints:
            for k in range(DOF_WIDTH[j.jtype]):
                out[j.dofadr + k] = j.body
        return out


def assign_addresses(joints: List[dict]) -> Tuple[int, int]:
    """Fill qposadr/dofadr sequentially (MuJoCo order); returns (nq, nv)."""
    q, v = 0, 0
    for j in joints:
        j["qposadr"], j["dofadr"] = q, v
        q += QPOS_WIDTH[j["jtype"]]
        v += DOF_WIDTH[j["jtype"]]
    return q, v


def subtree_mass(model: PhysModel, body: int) -> float:
    total = 0.0
    for b in range(model.nbody):
        cur = b
        while cur != -1:
            if cur == body:
                total += model.body_mass[b]
                break
            cur = model.body_parent[cur]
    return total
