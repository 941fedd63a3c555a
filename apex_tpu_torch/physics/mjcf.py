"""MJCF (MuJoCo XML) subset parser -> PhysModel.

Parses the model-description subset used by the Cassie family of models
(reference cassie/cassiemujoco/cassie.xml and its 14 terrain variants):
bodies with pos/xyaxes/euler/quat frames, explicit inertials (fullinertia or
diaginertia), slide/hinge/ball joints with ref/range/stiffness/damping/
armature, capsule/sphere/plane collision geoms with default-class resolution,
`connect` equality constraints, and motor actuators with gear/ctrlrange.

This is a clean-room parser: it consumes the standard MJCF format (MuJoCo
docs) -- not a translation of any reference code, which ships no parser (the
XML is compiled inside the prebuilt .so).
"""
from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from apex_tpu_torch.physics.spec import (
    Actuator,
    ContactSphere,
    DOF_WIDTH,
    EqualityConnect,
    Joint,
    JointType,
    PhysModel,
    QPOS_WIDTH,
)


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.replace(",", " ").split()])


def _quat_from_xyaxes(xy: np.ndarray) -> np.ndarray:
    x = xy[:3] / np.linalg.norm(xy[:3])
    y = xy[3:6]
    y = y - x * (x @ y)
    y = y / np.linalg.norm(y)
    z = np.cross(x, y)
    m = np.stack([x, y, z], axis=1)
    return _mat2quat(m)


def _mat2quat(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                      (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    elif m[0, 0] >= m[1, 1] and m[0, 0] >= m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, 0.25 * s,
                      (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s])
    elif m[1, 1] >= m[2, 2]:
        s = math.sqrt(1.0 - m[0, 0] + m[1, 1] - m[2, 2]) * 2
        q = np.array([(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
                      0.25 * s, (m[1, 2] + m[2, 1]) / s])
    else:
        s = math.sqrt(1.0 - m[0, 0] - m[1, 1] + m[2, 2]) * 2
        q = np.array([(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
                      (m[1, 2] + m[2, 1]) / s, 0.25 * s])
    q = q / np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def _quat2mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _euler_zyx_quat(e_deg: np.ndarray, degree: bool) -> np.ndarray:
    """MJCF eulerseq='zyx' (cassie.xml:3): intrinsic z, then y, then x."""
    scale = math.pi / 180.0 if degree else 1.0
    rx, ry, rz = e_deg * scale

    def ax(angle, axis):
        h = angle / 2
        v = np.zeros(4)
        v[0] = math.cos(h)
        v[1 + axis] = math.sin(h)
        return v

    # eulerseq zyx applies in the order given: R = Rz @ Ry @ Rx
    return _quat_mul(_quat_mul(ax(rz, 2), ax(ry, 1)), ax(rx, 0))


def _frame_quat(el, degree: bool) -> np.ndarray:
    if el.get("quat") is not None:
        q = _floats(el.get("quat"))
        return q / np.linalg.norm(q)
    if el.get("xyaxes") is not None:
        return _quat_from_xyaxes(_floats(el.get("xyaxes")))
    if el.get("euler") is not None:
        return _euler_zyx_quat(_floats(el.get("euler")), degree)
    return np.array([1.0, 0, 0, 0])


def _full_inertia(s: str) -> np.ndarray:
    ixx, iyy, izz, ixy, ixz, iyz = [float(x) for x in s.split()]
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


class _Defaults:
    """Minimal default-class resolver (MJCF <default> tree)."""

    def __init__(self, root):
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {}
        top = root.find("default")
        if top is not None:
            self._walk(top, {}, None)

    def _walk(self, el, inherited, name):
        attrs = {k: dict(v) for k, v in inherited.items()}
        for child in el:
            if child.tag == "default":
                continue
            d = attrs.setdefault(child.tag, {})
            d.update(child.attrib)
        key = name if name is not None else "__top__"
        self.classes[key] = attrs
        for child in el.findall("default"):
            self._walk(child, attrs, child.get("class"))

    def resolve(self, tag: str, el, cls: Optional[str]) -> Dict[str, str]:
        out: Dict[str, str] = {}
        out.update(self.classes.get("__top__", {}).get(tag, {}))
        if cls and cls in self.classes:
            out.update(self.classes[cls].get(tag, {}))
        out.update(el.attrib)
        return out


def parse_mjcf(path: str) -> PhysModel:
    tree = ET.parse(path)
    return _build(tree.getroot())


def parse_mjcf_string(xml: str) -> PhysModel:
    return _build(ET.fromstring(xml))


def _build(root) -> PhysModel:
    compiler = root.find("compiler")
    degree = True
    if compiler is not None and compiler.get("angle") == "radian":
        degree = False
    ang = math.pi / 180.0 if degree else 1.0

    option = root.find("option")
    timestep = 0.002
    gravity = np.array([0.0, 0.0, -9.81])
    if option is not None:
        if option.get("timestep"):
            timestep = float(option.get("timestep"))
        if option.get("gravity"):
            gravity = _floats(option.get("gravity"))

    defaults = _Defaults(root)

    body_parent: List[int] = []
    body_pos: List[np.ndarray] = []
    body_quat: List[np.ndarray] = []
    body_mass: List[float] = []
    body_ipos: List[np.ndarray] = []
    body_inertia: List[np.ndarray] = []
    body_names: List[str] = []
    joints: List[dict] = []
    body_joints: List[List[int]] = []
    contacts: List[ContactSphere] = []
    joint_names: Dict[str, int] = {}

    def parse_geoms(el, body_idx, childclass):
        for g in el.findall("geom"):
            a = defaults.resolve("geom", g, g.get("class") or childclass)
            contype = int(a.get("contype", "1"))
            gtype = a.get("type", "sphere")
            if contype == 0 or gtype == "plane":
                continue
            name = a.get("name", f"geom{body_idx}")
            # classify foot geoms by body name for GRF grouping
            bname = body_names[body_idx]
            group = 0 if bname == "left-foot" else 1 if bname == "right-foot" else 2
            if gtype == "sphere":
                r = _floats(a.get("size"))[0]
                pos = _floats(a.get("pos", "0 0 0"))
                contacts.append(ContactSphere(body_idx, pos, r, group, name))
            elif gtype == "capsule":
                r = _floats(a.get("size"))[0]
                if a.get("fromto"):
                    ft = _floats(a.get("fromto"))
                    p1, p2 = ft[:3], ft[3:]
                else:
                    half = _floats(a.get("size"))[1]
                    pos = _floats(a.get("pos", "0 0 0"))
                    q = _frame_quat(g, degree)
                    z = _quat2mat(q)[:, 2]
                    p1, p2 = pos - half * z, pos + half * z
                contacts.append(ContactSphere(body_idx, p1, r, group, name + "_a"))
                contacts.append(ContactSphere(body_idx, p2, r, group, name + "_b"))

    def walk(el, parent, childclass):
        cc = el.get("childclass", childclass)
        for b in el.findall("body"):
            idx = len(body_parent)
            body_parent.append(parent)
            body_pos.append(_floats(b.get("pos", "0 0 0")))
            body_quat.append(_frame_quat(b, degree))
            body_names.append(b.get("name", f"body{idx}"))
            inertial = b.find("inertial")
            if inertial is None:
                raise ValueError(
                    f"body {body_names[-1]} lacks explicit <inertial>")
            body_mass.append(float(inertial.get("mass")))
            body_ipos.append(_floats(inertial.get("pos", "0 0 0")))
            if inertial.get("fullinertia"):
                body_inertia.append(_full_inertia(inertial.get("fullinertia")))
            else:
                body_inertia.append(np.diag(_floats(inertial.get("diaginertia"))))
            body_joints.append([])

            bcc = b.get("childclass", cc)
            for jel in b.findall("joint") + b.findall("freejoint"):
                a = defaults.resolve("joint", jel, jel.get("class") or bcc)
                jtype_s = "free" if jel.tag == "freejoint" else a.get("type", "hinge")
                if jtype_s == "free":
                    # decompose into 3 slides + ball, like cassie's pelvis
                    # (cassie.xml:82-85). MuJoCo free-joint qpos is the GLOBAL
                    # body position, so each slide's ref equals the XML body
                    # pos component: translation = body_pos + (qpos - ref)
                    # = qpos. (Requires the free body's parent to be world.)
                    for axis_i in range(3):
                        axis = np.zeros(3)
                        axis[axis_i] = 1.0
                        joints.append(dict(
                            body=idx, jtype=JointType.SLIDE, axis=axis,
                            pos=np.zeros(3), ref=float(body_pos[idx][axis_i]),
                            range=(0.0, 0.0),
                            limited=False, stiffness=0.0, damping=0.0,
                            armature=0.0, name=f"{body_names[-1]}_free{axis_i}"))
                        body_joints[idx].append(len(joints) - 1)
                    joints.append(dict(
                        body=idx, jtype=JointType.BALL, axis=np.array([0, 0, 1.0]),
                        pos=np.zeros(3), ref=0.0, range=(0.0, 0.0),
                        limited=False, stiffness=0.0, damping=0.0,
                        armature=0.0, name=f"{body_names[-1]}_ball"))
                    body_joints[idx].append(len(joints) - 1)
                    continue
                jtype = {"slide": JointType.SLIDE, "hinge": JointType.HINGE,
                         "ball": JointType.BALL}[jtype_s]
                limited = a.get("limited", "true") == "true" and a.get("range") is not None
                rng = _floats(a.get("range", "0 0"))
                if jtype != JointType.SLIDE:
                    rng = rng * ang
                ref = float(a.get("ref", "0"))
                if jtype == JointType.HINGE:
                    ref *= ang
                joints.append(dict(
                    body=idx, jtype=jtype,
                    axis=_floats(a.get("axis", "0 0 1")),
                    pos=_floats(a.get("pos", "0 0 0")),
                    ref=ref, range=(float(rng[0]), float(rng[1])),
                    limited=limited,
                    stiffness=float(a.get("stiffness", "0")),
                    damping=float(a.get("damping", "0")),
                    armature=float(a.get("armature", "0")),
                    name=a.get("name", f"joint{len(joints)}")))
                if a.get("name"):
                    joint_names[a.get("name")] = len(joints) - 1
                body_joints[idx].append(len(joints) - 1)

            parse_geoms(b, idx, bcc)
            walk(b, idx, bcc)

    worldbody = root.find("worldbody")
    walk(worldbody, -1, None)

    # floor plane (first worldbody-level plane geom)
    floor_pos = np.zeros(3)
    floor_quat = np.array([1.0, 0, 0, 0])
    for g in worldbody.findall("geom"):
        a = defaults.resolve("geom", g, g.get("class"))
        if a.get("type") == "plane":
            floor_pos = _floats(a.get("pos", "0 0 0"))
            floor_quat = _frame_quat(g, degree)
            break

    # addresses
    q, v = 0, 0
    for j in joints:
        j["qposadr"], j["dofadr"] = q, v
        q += QPOS_WIDTH[j["jtype"]]
        v += DOF_WIDTH[j["jtype"]]
    nq, nv = q, v

    dof_damping = np.zeros(nv)
    dof_armature = np.zeros(nv)
    qpos0 = np.zeros(nq)
    for j in joints:
        for k in range(DOF_WIDTH[j["jtype"]]):
            dof_damping[j["dofadr"] + k] = j["damping"]
            dof_armature[j["dofadr"] + k] = j["armature"]
        if j["jtype"] == JointType.BALL:
            qpos0[j["qposadr"]] = 1.0  # identity quat
        else:
            qpos0[j["qposadr"]] = j["ref"]

    joint_objs = tuple(
        Joint(body=j["body"], jtype=j["jtype"],
              axis=j["axis"] / np.linalg.norm(j["axis"]), pos=j["pos"],
              ref=j["ref"], qposadr=j["qposadr"], dofadr=j["dofadr"],
              range=j["range"], limited=j["limited"],
              stiffness=j["stiffness"], damping=j["damping"],
              armature=j["armature"], name=j["name"])
        for j in joints)

    # actuators
    actuators: List[Actuator] = []
    act_root = root.find("actuator")
    if act_root is not None:
        for m in act_root.findall("motor"):
            a = defaults.resolve("motor", m, m.get("class"))
            cr = _floats(a.get("ctrlrange", "-1 1"))
            actuators.append(Actuator(
                joint=joint_names[a.get("joint")],
                gear=float(_floats(a.get("gear", "1"))[0]),
                ctrlrange=(float(cr[0]), float(cr[1])),
                name=a.get("name", "")))

    # equality connects: anchor2 from the XML-pose FK
    nbody = len(body_parent)
    model_wo_eq = PhysModel(
        nbody=nbody, nq=nq, nv=nv, nu=len(actuators),
        body_parent=np.array(body_parent, np.int32),
        body_pos=np.stack(body_pos), body_quat=np.stack(body_quat),
        body_mass=np.array(body_mass), body_ipos=np.stack(body_ipos),
        body_inertia=np.stack(body_inertia),
        joints=joint_objs,
        body_joints=tuple(tuple(bj) for bj in body_joints),
        actuators=tuple(actuators), contacts=tuple(contacts),
        equalities=(),
        dof_damping=dof_damping, dof_armature=dof_armature, qpos0=qpos0,
        gravity=gravity, floor_pos=floor_pos, floor_quat=floor_quat,
        timestep=timestep,
        body_names=tuple(body_names),
    )

    equalities: List[EqualityConnect] = []
    eq_root = root.find("equality")
    if eq_root is not None and len(eq_root.findall("connect")) > 0:
        xpos, xmat = _host_fk(model_wo_eq, qpos0)
        name_to_idx = {n: i for i, n in enumerate(body_names)}
        for c in eq_root.findall("connect"):
            b1 = name_to_idx[c.get("body1")]
            b2 = name_to_idx[c.get("body2")]
            anchor1 = _floats(c.get("anchor"))
            world = xpos[b1] + xmat[b1] @ anchor1
            anchor2 = xmat[b2].T @ (world - xpos[b2])
            equalities.append(EqualityConnect(
                body1=b1, body2=b2, anchor1=anchor1, anchor2=anchor2))

    import dataclasses as _dc
    return _dc.replace(model_wo_eq, equalities=tuple(equalities))


def _host_fk(model: PhysModel, qpos: np.ndarray):
    """Host-side (numpy) forward kinematics for model building."""
    xpos = np.zeros((model.nbody, 3))
    xmat = np.zeros((model.nbody, 3, 3))
    for i in range(model.nbody):
        p = model.body_parent[i]
        if p == -1:
            base_pos, base_mat = np.zeros(3), np.eye(3)
        else:
            base_pos, base_mat = xpos[p], xmat[p]
        pos = base_pos + base_mat @ model.body_pos[i]
        mat = base_mat @ _quat2mat(model.body_quat[i])
        for jidx in model.body_joints[i]:
            j = model.joints[jidx]
            if j.jtype == JointType.SLIDE:
                pos = pos + mat @ (j.axis * (qpos[j.qposadr] - j.ref))
            elif j.jtype == JointType.HINGE:
                angle = qpos[j.qposadr] - j.ref
                anchor = pos + mat @ j.pos
                rot = _quat2mat(np.concatenate([
                    [math.cos(angle / 2)], j.axis * math.sin(angle / 2)]))
                mat_new = mat @ rot
                pos = anchor - mat_new @ j.pos
                mat = mat_new
            elif j.jtype == JointType.BALL:
                quat = qpos[j.qposadr:j.qposadr + 4]
                anchor = pos + mat @ j.pos
                rot = _quat2mat(quat / np.linalg.norm(quat))
                mat_new = mat @ rot
                pos = anchor - mat_new @ j.pos
                mat = mat_new
        xpos[i], xmat[i] = pos, mat
    return xpos, xmat
