"""Copy of apex_tpu/physics/models/walker2d.py (numpy and `spec` only),
importing the port's own `spec`; edit the original and copy, do not edit
here.

Walker2d model: planar 7-body walker for the benchmark anchor env.

Clean-room reconstruction of the classic gym Walker2d morphology (the
BASELINE.md comparison anchor: "reference PPO+GAE on Walker2d-v2"): a torso
with planar root (slide x, slide z, hinge y) and two legs of
thigh/leg/foot capsules, gear-100 torque actuators. Inertials are computed
from capsule geometry at 1000 kg/m^3 (solid capsule formulas), matching how
the MJCF compiler derives them from density.
"""
from __future__ import annotations

import numpy as np

from apex_tpu_torch.physics.spec import (
    Actuator,
    ContactSphere,
    Joint,
    JointType,
    PhysModel,
)

RHO = 1000.0  # kg/m^3, MJCF default density


def _capsule_inertial(p1, p2, r):
    """Mass, com, and 3x3 inertia (about com, body frame) of a solid capsule
    from p1 to p2 with radius r."""
    p1, p2 = np.asarray(p1, float), np.asarray(p2, float)
    d = p2 - p1
    L = np.linalg.norm(d)
    axis = d / L if L > 0 else np.array([0.0, 0, 1.0])
    m_cyl = RHO * np.pi * r * r * L
    m_sph = RHO * 4.0 / 3.0 * np.pi * r ** 3
    m = m_cyl + m_sph
    # inertia about the capsule axis / transverse, MuJoCo's solid formulas
    i_ax = m_cyl * r * r / 2 + m_sph * 2 * r * r / 5
    i_tr = (m_cyl * (L * L / 12 + r * r / 4)
            + m_sph * (2 * r * r / 5 + L * L / 4 + 3 * L * r / 8))
    # rotate diag(i_tr, i_tr, i_ax) from axis frame to body frame
    z = axis
    x = np.array([1.0, 0, 0])
    if abs(z @ x) > 0.9:
        x = np.array([0.0, 1, 0])
    x = x - z * (z @ x)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=1)
    inertia = R @ np.diag([i_tr, i_tr, i_ax]) @ R.T
    com = (p1 + p2) / 2
    return m, com, inertia


def make_model() -> PhysModel:
    # geometry (classic walker2d): torso capsule z 0..0.4 about body origin
    # at z=1.25; legs hang below
    bodies = []       # (name, parent, pos, capsule(p1, p2, r))
    bodies.append(("torso", -1, [0, 0, 1.25], ([0, 0, 0.2], [0, 0, -0.2], 0.05)))
    for side, sgn in (("left", 1.0), ("right", -1.0)):
        # thigh: hinge at torso bottom; capsule 0..-0.45
        bodies.append((f"thigh_{side}", 0, [0, sgn * 0.05, -0.2],
                       ([0, 0, 0], [0, 0, -0.45], 0.05)))
        bodies.append((f"leg_{side}", len(bodies) - 1, [0, 0, -0.45],
                       ([0, 0, 0], [0, 0, -0.5], 0.04)))
        bodies.append((f"foot_{side}", len(bodies) - 1, [0, 0, -0.5],
                       ([-0.05, 0, 0], [0.15, 0, 0], 0.06)))

    nb = len(bodies)
    body_parent = np.array([b[1] for b in bodies], np.int32)
    body_pos = np.stack([np.asarray(b[2], float) for b in bodies])
    body_quat = np.tile(np.array([1.0, 0, 0, 0]), (nb, 1))
    masses, ipos, inert = [], [], []
    for b in bodies:
        m, com, I = _capsule_inertial(*b[3])
        masses.append(m)
        ipos.append(com)
        inert.append(I)

    joints = []
    body_joints = [[] for _ in range(nb)]
    q = v = 0

    def add_joint(body, jtype, axis, ref=0.0, rng=(0.0, 0.0), limited=False,
                  damping=0.0, armature=0.0, name=""):
        nonlocal q, v
        joints.append(Joint(
            body=body, jtype=jtype, axis=np.asarray(axis, float),
            pos=np.zeros(3), ref=ref, qposadr=q, dofadr=v, range=rng,
            limited=limited, stiffness=0.0, damping=damping,
            armature=armature, name=name))
        body_joints[body].append(len(joints) - 1)
        q += 1
        v += 1

    # planar root (gym: rootx, rootz, rooty); rootz ref = initial height
    add_joint(0, JointType.SLIDE, [1, 0, 0], name="rootx")
    add_joint(0, JointType.SLIDE, [0, 0, 1], ref=1.25, name="rootz")
    add_joint(0, JointType.HINGE, [0, 1, 0], name="rooty")
    act_joints = []
    deg = np.pi / 180.0
    for i, side in ((1, "left"), (4, "right")):
        add_joint(i, JointType.HINGE, [0, 1, 0], rng=(-150 * deg, 0.0),
                  limited=True, damping=0.1, armature=0.01,
                  name=f"thigh_{side}")
        act_joints.append(len(joints) - 1)
        add_joint(i + 1, JointType.HINGE, [0, 1, 0], rng=(-150 * deg, 0.0),
                  limited=True, damping=0.1, armature=0.01,
                  name=f"leg_{side}")
        act_joints.append(len(joints) - 1)
        add_joint(i + 2, JointType.HINGE, [0, 1, 0],
                  rng=(-45 * deg, 45 * deg), limited=True, damping=0.1,
                  armature=0.01, name=f"foot_{side}")
        act_joints.append(len(joints) - 1)

    actuators = tuple(
        Actuator(joint=j, gear=100.0, ctrlrange=(-1.0, 1.0),
                 name=joints[j].name) for j in act_joints)

    # floor contacts: foot capsule endpoints + torso top for fall detection
    contacts = []
    for i, (name, _, _, (p1, p2, r)) in enumerate(bodies):
        if name.startswith("foot"):
            g = 0 if "left" in name else 1
            contacts.append(ContactSphere(i, np.asarray(p1, float), r, g,
                                          name + "_heel"))
            contacts.append(ContactSphere(i, np.asarray(p2, float), r, g,
                                          name + "_toe"))
        if name.startswith("leg"):
            contacts.append(ContactSphere(i, np.asarray(p2, float), r, 2,
                                          name + "_knee"))
        if name == "torso":
            contacts.append(ContactSphere(i, np.asarray(p2, float), r, 2,
                                          "torso_bottom"))

    dof_damping = np.array([j.damping for j in joints])
    dof_armature = np.array([j.armature for j in joints])
    qpos0 = np.array([j.ref for j in joints])

    return PhysModel(
        nbody=nb, nq=q, nv=v, nu=len(actuators),
        body_parent=body_parent, body_pos=body_pos, body_quat=body_quat,
        body_mass=np.asarray(masses), body_ipos=np.stack(ipos),
        body_inertia=np.stack(inert),
        joints=tuple(joints),
        body_joints=tuple(tuple(bj) for bj in body_joints),
        actuators=actuators, contacts=tuple(contacts), equalities=(),
        dof_damping=dof_damping, dof_armature=dof_armature, qpos0=qpos0,
        gravity=np.array([0.0, 0.0, -9.81]),
        floor_pos=np.zeros(3), floor_quat=np.array([1.0, 0, 0, 0]),
        timestep=0.002,
        solref_timeconst=0.02, solref_dampratio=1.0,
        body_names=tuple(b[0] for b in bodies),
    )
