"""MJCF-subset loader.

Parses the subset of MuJoCo's MJCF used by the Gymnasium benchmark assets
(half_cheetah/hopper/walker2d/ant/swimmer/reacher/...): nested bodies,
slide/hinge/free joints, capsule/sphere/cylinder/box/plane geoms (fromto or
pos+quat/axisangle), one level of defaults, motors, and the compiler/option
attributes that affect dynamics (angle units, settotalmass, timestep,
gravity, fluid density/viscosity).

The port's own copy of ``tianshou_tpu/env/physics/mjcf.py``. The asset XMLs
ship with the package under ``assets/`` (copied from Gymnasium 1.2.2, see
``assets/LICENSE``), so the device environments carry exactly the benchmark
geometry/masses/gears without ``gymnasium`` installed — the dynamics core
itself is :mod:`tianshou_tpu_torch.env.physics.dynamics`.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from tianshou_tpu_torch.env.physics.model import FREE, HINGE, SLIDE, Actuator, Geom, Joint, Model

__all__ = ["load_mjcf", "asset_path"]


def asset_path(name: str) -> str:
    """Path of a packaged MuJoCo asset xml (e.g. ``"half_cheetah.xml"``)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no packaged asset {name!r} under {os.path.dirname(path)}")
    return path


def _floats(s: str | None, default=None) -> np.ndarray | None:
    if s is None:
        return None if default is None else np.asarray(default, float)
    return np.array([float(x) for x in s.split()])


def _axis_angle_to_mat(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _mat_to_rotvec(m: np.ndarray) -> np.ndarray:
    angle = np.arccos(np.clip((np.trace(m) - 1) / 2, -1, 1))
    if angle < 1e-10:
        return np.zeros(3)
    axis = np.array([m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]])
    return angle * axis / np.linalg.norm(axis)


class _Loader:
    def __init__(self, root: ET.Element):
        self.root = root
        comp = root.find("compiler")
        self.deg = (comp is None) or (comp.get("angle", "degree") == "degree")
        self.settotalmass = None
        if comp is not None and comp.get("settotalmass"):
            self.settotalmass = float(comp.get("settotalmass"))
        self.joint_default: dict = {}
        self.geom_default: dict = {}
        default = root.find("default")
        if default is not None:
            jd = default.find("joint")
            if jd is not None:
                self.joint_default = dict(jd.attrib)
            gd = default.find("geom")
            if gd is not None:
                self.geom_default = dict(gd.attrib)
        self.floor: dict | None = None
        self.parent: list[int] = []
        self.body_pos: list[np.ndarray] = []
        self.body_quat: list[np.ndarray] = []
        self.body_names: list[str] = []
        self.joints: list[Joint] = []
        self.geoms: list[Geom] = []
        self.nq = 0
        self.qpos0: list[float] = []

    def angle(self, v: float) -> float:
        return float(np.deg2rad(v)) if self.deg else float(v)

    # ------------------------------------------------------------------
    @staticmethod
    def _solparams(attr: dict) -> tuple[float, tuple, tuple]:
        """(margin, solref, solimp) with MuJoCo defaults for missing parts."""
        margin = float(attr.get("margin", "0"))
        solref = _floats(attr.get("solref"), [0.02, 1.0])
        si = _floats(attr.get("solimp"), [0.9, 0.95, 0.001])
        solimp_full = np.array([0.9, 0.95, 0.001, 0.5, 2.0])
        solimp_full[: len(si)] = si
        return margin, tuple(solref[:2]), tuple(solimp_full)

    def parse_geom(self, el: ET.Element, body: int) -> None:
        attr = {**self.geom_default, **el.attrib}
        gtype = attr.get("type", "sphere")
        if gtype == "plane":
            # ground plane is implicit (z=0) in the dynamics, but its
            # contact-combination params matter (friction/margin/sol*)
            margin, solref, solimp = self._solparams(attr)
            self.floor = dict(
                friction=float(_floats(attr.get("friction"), [1.0, 0.005, 0.0001])[0]),
                margin=margin, solref=solref, solimp=solimp,
                condim=int(attr.get("condim", "3")),
            )
            return
        fromto = _floats(attr.get("fromto"))
        size = _floats(attr.get("size"))
        if fromto is not None:
            a, b = fromto[:3], fromto[3:]
            pos = (a + b) / 2
            d = b - a
            length = np.linalg.norm(d)
            z = d / max(length, 1e-12)
            # complete the frame: any orthonormal basis with third column z
            ref = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
            x = np.cross(ref, z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            rot = np.stack([x, y, z], axis=1)
            size = np.array([size[0], length / 2])
        else:
            pos = _floats(attr.get("pos"), [0, 0, 0])
            rot = np.eye(3)
            if attr.get("quat"):
                rot = _quat_to_mat(_floats(attr["quat"]))
            elif attr.get("axisangle"):
                aa = _floats(attr["axisangle"])
                rot = _axis_angle_to_mat(aa[:3], self.angle(aa[3]))
        friction = _floats(attr.get("friction"), [1.0, 0.005, 0.0001])[0]
        contype = int(attr.get("contype", "1"))
        conaffinity = int(attr.get("conaffinity", "1"))
        condim = int(attr.get("condim", "3"))
        mass = float(attr["mass"]) if attr.get("mass") else None
        margin, solref, solimp = self._solparams(attr)
        self.geoms.append(
            Geom(
                gtype=gtype,
                body=body,
                size=np.atleast_1d(size),
                pos=pos,
                rot=rot,
                friction=float(friction),
                density=float(attr.get("density", "1000")),
                mass=mass,
                contact=contype != 0,
                name=attr.get("name", ""),
                margin=margin,
                solref=solref,
                solimp=solimp,
                contype=contype,
                conaffinity=conaffinity,
                condim=condim,
            )
        )

    def parse_joint(self, el: ET.Element, body: int, body_world_pos: np.ndarray, body_quat: np.ndarray) -> None:
        attr = {**self.joint_default, **el.attrib}
        jtype = attr.get("type", "hinge")
        if jtype == "free":
            self.joints.append(
                Joint(jtype=FREE, body=body, axis=np.zeros(3), pos=np.zeros(3),
                      q_idx=self.nq, name=attr.get("name", ""))
            )
            rv = _mat_to_rotvec(_quat_to_mat(body_quat))
            self.qpos0.extend(list(body_world_pos) + list(rv))
            self.nq += 6
            return
        ref = self.angle(float(attr.get("ref", "0"))) if jtype == "hinge" else float(attr.get("ref", "0"))
        rng = _floats(attr.get("range"), [0, 0])
        if jtype == "hinge":
            rng = np.array([self.angle(rng[0]), self.angle(rng[1])])
        axis = _floats(attr.get("axis"), [0, 0, 1]).astype(float)
        axis = axis / np.linalg.norm(axis)
        limited = attr.get("limited", "true" if attr.get("range") else "false") == "true"
        solref_l = _floats(attr.get("solreflimit"), [0.02, 1.0])
        si_l = _floats(attr.get("solimplimit"), [0.9, 0.95, 0.001])
        solimp_l = np.array([0.9, 0.95, 0.001, 0.5, 2.0])
        solimp_l[: len(si_l)] = si_l
        self.joints.append(
            Joint(
                jtype=HINGE if jtype == "hinge" else SLIDE,
                body=body,
                axis=axis,
                pos=_floats(attr.get("pos"), [0, 0, 0]),
                q_idx=self.nq,
                ref=ref,
                armature=float(attr.get("armature", "0")),
                damping=float(attr.get("damping", "0")),
                stiffness=float(attr.get("stiffness", "0")),
                springref=self.angle(float(attr.get("springref", "0"))) if jtype == "hinge" else float(attr.get("springref", "0")),
                limited=limited,
                range=(float(rng[0]), float(rng[1])),
                name=attr.get("name", ""),
                solref_limit=(float(solref_l[0]), float(solref_l[1])),
                solimp_limit=tuple(solimp_l),
            )
        )
        self.qpos0.append(ref)
        self.nq += 1

    def parse_body(self, el: ET.Element, parent: int, parent_world_pos: np.ndarray) -> None:
        pos = _floats(el.get("pos"), [0, 0, 0])
        quat = _floats(el.get("quat"), [1, 0, 0, 0])
        b = len(self.parent)
        self.parent.append(parent)
        self.body_pos.append(pos)
        self.body_quat.append(quat)
        self.body_names.append(el.get("name", f"body{b}"))
        world_pos = parent_world_pos + pos  # valid while parent chain is unrotated (qpos0)
        for child in el:
            if child.tag == "joint":
                self.parse_joint(child, b, world_pos, quat)
            elif child.tag == "geom":
                self.parse_geom(child, b)
            elif child.tag == "body":
                self.parse_body(child, b, world_pos)

    def parse_actuators(self) -> list[Actuator]:
        acts = []
        jmap = {j.name: j for j in self.joints}
        actuator = self.root.find("actuator")
        if actuator is None:
            return acts
        motor_default = {}
        default = self.root.find("default")
        if default is not None and default.find("motor") is not None:
            motor_default = dict(default.find("motor").attrib)
        for m in actuator:
            attr = {**motor_default, **m.attrib}
            j = jmap[attr["joint"]]
            cr = _floats(attr.get("ctrlrange"), [-1.0, 1.0])
            acts.append(Actuator(q_idx=j.q_idx, gear=float(attr.get("gear", "1")),
                                 ctrlrange=(float(cr[0]), float(cr[1])), name=attr.get("name", "")))
        return acts

    def build(self) -> Model:
        opt = self.root.find("option")
        timestep = float(opt.get("timestep", "0.002")) if opt is not None else 0.002
        integrator = (opt.get("integrator", "Euler") if opt is not None else "Euler").lower()
        gravity = _floats(opt.get("gravity"), [0, 0, -9.81]) if opt is not None else np.array([0, 0, -9.81])
        fluid_density = float(opt.get("density", "0")) if opt is not None else 0.0
        fluid_viscosity = float(opt.get("viscosity", "0")) if opt is not None else 0.0
        world = self.root.find("worldbody")
        for child in world:
            if child.tag == "body":
                self.parse_body(child, -1, np.zeros(3))
            elif child.tag == "geom":
                self.parse_geom(child, -1)  # world geoms: plane dropped, others ignored for dynamics
        # drop world-attached geoms (body == -1): static decoration, no dynamics
        self.geoms = [g for g in self.geoms if g.body >= 0]
        model = Model(
            nbody=len(self.parent),
            parent=self.parent,
            body_pos=np.stack(self.body_pos),
            body_quat=np.stack(self.body_quat),
            body_names=self.body_names,
            joints=self.joints,
            geoms=self.geoms,
            actuators=self.parse_actuators(),
            nq=self.nq,
            qpos0=np.asarray(self.qpos0, float),
            gravity=np.asarray(gravity, float),
            timestep=timestep,
            integrator=integrator,
            fluid_density=fluid_density,
            fluid_viscosity=fluid_viscosity,
        )
        if self.floor is not None:
            model.floor_friction = self.floor["friction"]
            model.floor_margin = self.floor["margin"]
            model.floor_solref = self.floor["solref"]
            model.floor_solimp = self.floor["solimp"]
        return model.finalize(settotalmass=self.settotalmass)


def load_mjcf(path_or_name: str) -> Model:
    """Load a Model from an MJCF file path or the name of a packaged asset."""
    path = path_or_name
    if not os.path.exists(path):
        path = asset_path(path_or_name)
    return _Loader(ET.parse(path).getroot()).build()
