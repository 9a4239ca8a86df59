"""Static physics model description (the port's own copy of
``tianshou_tpu/env/physics/model.py``; numpy only).

A :class:`Model` is plain numpy/python data that the dynamics functions and
the fused step kernel read their constants from, cast to float32 once.

Inertia computation follows MuJoCo's ``inertiafromgeom``: per-geom mass from
density * volume, analytic capsule/sphere/cylinder/box inertia tensors,
composed into per-body (mass, COM, inertia-about-COM).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Joint", "Geom", "Actuator", "Model", "geom_mass_inertia", "model_from_arrays", "ARRAY_FIELDS"]

# joint type codes
FREE, SLIDE, HINGE = 0, 1, 2


@dataclasses.dataclass
class Joint:
    jtype: int              # FREE / SLIDE / HINGE
    body: int               # body this joint moves
    axis: np.ndarray        # [3] local axis (slide/hinge)
    pos: np.ndarray         # [3] anchor in body frame (hinge)
    q_idx: int              # start index in q (size 1, or 6 for free)
    ref: float = 0.0        # qpos reference (MuJoCo joint/@ref)
    armature: float = 0.0
    damping: float = 0.0
    stiffness: float = 0.0
    springref: float = 0.0
    limited: bool = False
    range: tuple[float, float] = (0.0, 0.0)
    name: str = ""
    # limit-constraint solver params (joint solreflimit/solimplimit)
    solref_limit: tuple[float, float] = (0.02, 1.0)
    solimp_limit: tuple[float, ...] = (0.9, 0.95, 0.001, 0.5, 2.0)

    @property
    def size(self) -> int:
        return 6 if self.jtype == FREE else 1


@dataclasses.dataclass
class Geom:
    gtype: str              # "capsule" | "sphere" | "cylinder" | "box" | "plane"
    body: int
    size: np.ndarray        # capsule/cylinder: (r, half_len); sphere: (r,); box: half-sizes
    pos: np.ndarray         # [3] center in body frame
    rot: np.ndarray         # [3,3] geom->body rotation (z = capsule axis)
    friction: float = 1.0
    density: float = 1000.0
    mass: float | None = None   # explicit mass overrides density
    contact: bool = True    # participates in plane contacts (contype != 0)
    name: str = ""
    # MuJoCo constraint-solver params (geom solref/solimp/margin)
    margin: float = 0.0
    solref: tuple[float, float] = (0.02, 1.0)
    solimp: tuple[float, ...] = (0.9, 0.95, 0.001, 0.5, 2.0)
    # MuJoCo collision filtering/dimensionality (geom contype/conaffinity/
    # condim); condim 1 = frictionless normal-only contact
    contype: int = 1
    conaffinity: int = 1
    condim: int = 3


@dataclasses.dataclass
class Actuator:
    q_idx: int
    gear: float
    ctrlrange: tuple[float, float] = (-1.0, 1.0)
    name: str = ""


@dataclasses.dataclass
class Model:
    nbody: int
    parent: list[int]               # -1 = world
    body_pos: np.ndarray            # [nb, 3]
    body_quat: np.ndarray           # [nb, 4] (w, x, y, z)
    body_names: list[str]
    joints: list[Joint]             # document order; q indices precomputed
    geoms: list[Geom]
    actuators: list[Actuator]
    nq: int
    qpos0: np.ndarray               # [nq]
    # world
    gravity: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.0, 0.0, -9.81]))
    timestep: float = 0.002
    # source model's declared integrator (MJCF option/@integrator).  We always
    # integrate semi-implicit Euler; this records what the source model used so
    # dynamics.step can pick a matching substep default (see step()).
    integrator: str = "euler"
    # ambient fluid (MuJoCo option/@density, option/@viscosity — swimmer)
    fluid_density: float = 0.0
    fluid_viscosity: float = 0.0
    # derived per-body inertia (filled by finalize)
    body_mass: np.ndarray | None = None     # [nb]
    body_com: np.ndarray | None = None      # [nb, 3]
    body_inertia: np.ndarray | None = None  # [nb, 3, 3] about COM, body frame
    # contact spheres: (body, offset[3], radius, friction) rows
    contact_body: np.ndarray | None = None
    contact_offset: np.ndarray | None = None
    contact_radius: np.ndarray | None = None
    contact_friction: np.ndarray | None = None
    # contact solver (critically damped penalty, MuJoCo solref-style)
    contact_stiffness: float = 0.0   # filled by finalize if 0
    contact_damping: float = 0.0
    # soft-constraint contact model (MuJoCo solref/solimp semantics):
    # "constraint" solves the regularized dual QP in a pyramidal facet
    # basis per substep; "penalty" is the legacy spring-damper model
    contact_model: str = "constraint"
    # APGD iteration count for the dual contact QP.  Measured on the parity
    # harness (scripts/physics_parity.py): Hopper rel-err 0.055 at 8 and at
    # 15 iterations, Walker2d 0.076@8 vs 0.072@15 vs 0.072@30 — the solve
    # converges well before 30, so 12 keeps fidelity at ~2.5x less solver work.
    contact_iterations: int = 12
    # per-contact-row solver params (filled by finalize from geoms + floor)
    contact_margin: np.ndarray | None = None
    contact_solref: np.ndarray | None = None   # [nc, 2]
    contact_solimp: np.ndarray | None = None   # [nc, 5]
    # floor (plane geom) params for contact combination
    floor_friction: float = 1.0
    floor_margin: float = 0.0
    floor_solref: tuple[float, float] | None = None
    floor_solimp: tuple[float, ...] | None = None
    # joint-limit constraint rows (filled by finalize)
    limit_q_idx: np.ndarray | None = None     # [nl]
    limit_range: np.ndarray | None = None     # [nl, 2]
    limit_solref: np.ndarray | None = None    # [nl, 2]
    limit_solimp: np.ndarray | None = None    # [nl, 5]
    # geom-pair (self-collision) contacts — candidate pairs built by
    # finalize() with MuJoCo's weld-aware filtering; rows solved by the
    # constraint QP when enable_pair_contacts is on.  Capsules/cylinders are
    # segments, spheres zero-length segments; each pair yields one contact
    # at the segment-segment closest points (MuJoCo capsule-capsule).
    # Gated OFF by default: the benchmark rows for plane-contact-only tasks
    # were measured without pair rows — enable per env (Humanoid sets it).
    enable_pair_contacts: bool = False
    pair_body1: np.ndarray | None = None      # [np]
    pair_body2: np.ndarray | None = None      # [np]
    pair_a1: np.ndarray | None = None         # [np, 3] seg1 end A (body1 frame)
    pair_b1: np.ndarray | None = None         # [np, 3] seg1 end B
    pair_a2: np.ndarray | None = None         # [np, 3] seg2 end A (body2 frame)
    pair_b2: np.ndarray | None = None         # [np, 3] seg2 end B
    pair_radius: np.ndarray | None = None     # [np] r1 + r2
    pair_r1: np.ndarray | None = None         # [np] geom-1 radius (contact-point split)
    pair_friction: np.ndarray | None = None   # [np] elementwise-max slide mu
    pair_condim: np.ndarray | None = None     # [np] max(condim1, condim2)
    pair_margin: np.ndarray | None = None     # [np] margin1 + margin2
    pair_solref: np.ndarray | None = None     # [np, 2] solmix average
    pair_solimp: np.ndarray | None = None     # [np, 5]

    # ------------------------------------------------------------------
    def joints_of(self, body: int) -> list[Joint]:
        return [j for j in self.joints if j.body == body]

    @property
    def total_mass(self) -> float:
        return float(self.body_mass.sum())

    def finalize(self, settotalmass: float | None = None) -> "Model":
        """Compute per-body mass/COM/inertia from geoms and build contact
        sphere tables. Call once after construction."""
        nb = self.nbody
        mass = np.zeros(nb)
        com = np.zeros((nb, 3))
        inertia = np.zeros((nb, 3, 3))
        first = [[] for _ in range(nb)]
        for g in self.geoms:
            if g.gtype == "plane":
                continue
            m, i_local = geom_mass_inertia(g)
            first[g.body].append((m, g.pos, g.rot @ i_local @ g.rot.T))
        for b in range(nb):
            gs = first[b]
            if not gs:
                mass[b] = 1e-6  # massless connector body
                continue
            m_tot = sum(m for m, _, _ in gs)
            c = sum(m * p for m, p, _ in gs) / m_tot
            it = np.zeros((3, 3))
            for m, p, i_b in gs:
                d = p - c
                it += i_b + m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
            mass[b], com[b], inertia[b] = m_tot, c, it
        if settotalmass is not None and mass.sum() > 0:
            s = settotalmass / mass.sum()
            mass *= s
            inertia *= s
        self.body_mass, self.body_com, self.body_inertia = mass, com, inertia

        # contact spheres: capsule ends + sphere centers of contact geoms.
        # Per-row solver params combine geom and floor the MuJoCo way
        # (verified against mjData.contact: friction = elementwise max,
        # includemargin = sum of margins, solref/solimp = solmix-weighted
        # average, 0.5/0.5 at default solmix).
        f_solref = np.asarray(self.floor_solref if self.floor_solref is not None else (0.02, 1.0))
        f_solimp = np.asarray(
            self.floor_solimp if self.floor_solimp is not None else (0.9, 0.95, 0.001, 0.5, 2.0)
        )
        rows = []

        def add_row(g: Geom, off: np.ndarray, radius: float) -> None:
            rows.append((
                g.body, off, radius,
                max(g.friction, self.floor_friction),
                g.margin + self.floor_margin,
                0.5 * (np.asarray(g.solref) + f_solref),
                0.5 * (np.asarray(g.solimp) + f_solimp),
            ))

        for g in self.geoms:
            if g.gtype == "plane" or not g.contact:
                continue
            if g.gtype == "sphere":
                add_row(g, g.pos, g.size[0])
            elif g.gtype in ("capsule", "cylinder"):
                axis = g.rot[:, 2]
                h = g.size[1]
                add_row(g, g.pos + h * axis, g.size[0])
                add_row(g, g.pos - h * axis, g.size[0])
            elif g.gtype == "box":
                # 4 bottom + 4 top corner spheres of small radius
                r = 0.2 * min(g.size)
                for sx in (-1, 1):
                    for sy in (-1, 1):
                        for sz in (-1, 1):
                            off = g.pos + g.rot @ (np.array([sx, sy, sz]) * (g.size - r))
                            add_row(g, off, r)
        if rows:
            self.contact_body = np.array([r[0] for r in rows], np.int32)
            self.contact_offset = np.stack([r[1] for r in rows]).astype(np.float64)
            self.contact_radius = np.array([r[2] for r in rows])
            self.contact_friction = np.array([r[3] for r in rows])
            self.contact_margin = np.array([r[4] for r in rows])
            self.contact_solref = np.stack([r[5] for r in rows])
            self.contact_solimp = np.stack([r[6] for r in rows])
        else:
            self.contact_body = np.zeros(0, np.int32)
            self.contact_offset = np.zeros((0, 3))
            self.contact_radius = np.zeros(0)
            self.contact_friction = np.zeros(0)
            self.contact_margin = np.zeros(0)
            self.contact_solref = np.zeros((0, 2))
            self.contact_solimp = np.zeros((0, 5))

        # geom-pair (self-collision) candidate table.  MuJoCo filtering
        # (mj_collision): geoms collide iff the contype/conaffinity masks
        # cross-match AND their WELD bodies differ AND the welds are not
        # parent-child (a jointless body is welded to its parent, so e.g.
        # humanoid's foot sphere never collides with its own shin).
        has_joint = [False] * nb
        for j in self.joints:
            has_joint[j.body] = True

        def weldid(b: int) -> int:
            while b >= 0 and not has_joint[b]:
                b = self.parent[b]
            return b

        def seg_of(g: Geom):
            """(end_a, end_b, radius) in body frame; None if unsupported."""
            if g.gtype == "sphere":
                return g.pos, g.pos, float(g.size[0])
            if g.gtype in ("capsule", "cylinder"):
                ax = g.rot[:, 2] * float(g.size[1])
                return g.pos - ax, g.pos + ax, float(g.size[0])
            return None  # boxes/planes: no pair support

        prows: list[tuple] = []
        cgeoms = [g for g in self.geoms if g.contact and seg_of(g) is not None]
        for i in range(len(cgeoms)):
            for jj in range(i + 1, len(cgeoms)):
                g1, g2 = cgeoms[i], cgeoms[jj]
                if not (
                    (g1.contype & g2.conaffinity) or (g2.contype & g1.conaffinity)
                ):
                    continue
                w1, w2 = weldid(g1.body), weldid(g2.body)
                if w1 == w2:
                    continue

                def pweld(w: int) -> int:
                    # weld of the parent body; -1 = world (filter exempt)
                    return weldid(self.parent[w]) if w >= 0 else -1

                # parent filter (weld-aware); does NOT apply across the world
                if (pweld(w1) == w2 and w2 >= 0) or (pweld(w2) == w1 and w1 >= 0):
                    continue
                a1, b1, r1 = seg_of(g1)
                a2, b2, r2 = seg_of(g2)
                prows.append((
                    g1.body, g2.body, a1, b1, a2, b2, (r1 + r2, r1),
                    max(g1.friction, g2.friction),
                    max(g1.condim, g2.condim),
                    g1.margin + g2.margin,
                    0.5 * (np.asarray(g1.solref) + np.asarray(g2.solref)),
                    0.5 * (np.asarray(g1.solimp) + np.asarray(g2.solimp)),
                ))
        if prows:
            self.pair_body1 = np.array([r[0] for r in prows], np.int32)
            self.pair_body2 = np.array([r[1] for r in prows], np.int32)
            self.pair_a1 = np.stack([r[2] for r in prows]).astype(np.float64)
            self.pair_b1 = np.stack([r[3] for r in prows]).astype(np.float64)
            self.pair_a2 = np.stack([r[4] for r in prows]).astype(np.float64)
            self.pair_b2 = np.stack([r[5] for r in prows]).astype(np.float64)
            self.pair_radius = np.array([r[6][0] for r in prows])
            self.pair_r1 = np.array([r[6][1] for r in prows])
            self.pair_friction = np.array([r[7] for r in prows])
            self.pair_condim = np.array([r[8] for r in prows], np.int32)
            self.pair_margin = np.array([r[9] for r in prows])
            self.pair_solref = np.stack([r[10] for r in prows])
            self.pair_solimp = np.stack([r[11] for r in prows])
        else:
            self.pair_body1 = np.zeros(0, np.int32)
            self.pair_body2 = np.zeros(0, np.int32)
            self.pair_a1 = np.zeros((0, 3))
            self.pair_b1 = np.zeros((0, 3))
            self.pair_a2 = np.zeros((0, 3))
            self.pair_b2 = np.zeros((0, 3))
            self.pair_radius = np.zeros(0)
            self.pair_r1 = np.zeros(0)
            self.pair_friction = np.zeros(0)
            self.pair_condim = np.zeros(0, np.int32)
            self.pair_margin = np.zeros(0)
            self.pair_solref = np.zeros((0, 2))
            self.pair_solimp = np.zeros((0, 5))

        # joint-limit constraint row tables
        lim = [j for j in self.joints if j.jtype != FREE and j.limited]
        if lim:
            self.limit_q_idx = np.array([j.q_idx for j in lim], np.int32)
            self.limit_range = np.array([j.range for j in lim])
            self.limit_solref = np.stack([np.asarray(j.solref_limit) for j in lim])
            self.limit_solimp = np.stack([np.asarray(j.solimp_limit) for j in lim])
        else:
            self.limit_q_idx = np.zeros(0, np.int32)
            self.limit_range = np.zeros((0, 2))
            self.limit_solref = np.zeros((0, 2))
            self.limit_solimp = np.zeros((0, 5))

        # critically-damped penalty gains from the MuJoCo solref default
        # (timeconst=0.02s, dampratio=1): omega = 2/timeconst, per-contact
        # effective mass ~ total/contact_count
        if self.contact_stiffness == 0.0 and len(rows):
            m_eff = mass.sum() / max(len(rows), 1)
            omega = 2.0 / 0.02
            self.contact_stiffness = float(m_eff * omega * omega)
            self.contact_damping = float(2.0 * m_eff * omega)
        return self


def geom_mass_inertia(g: Geom) -> tuple[float, np.ndarray]:
    """(mass, inertia about geom COM in geom frame, z = symmetry axis)."""
    rho = g.density
    if g.gtype == "sphere":
        r = float(g.size[0])
        m = g.mass if g.mass is not None else rho * 4.0 / 3.0 * np.pi * r**3
        i = 2.0 / 5.0 * m * r * r * np.eye(3)
        return m, i
    if g.gtype == "capsule":
        r, h = float(g.size[0]), float(g.size[1])
        length = 2.0 * h
        m_cyl = rho * np.pi * r * r * length
        m_hs = rho * 2.0 / 3.0 * np.pi * r**3  # one hemisphere
        m = g.mass if g.mass is not None else m_cyl + 2 * m_hs
        scale = m / (m_cyl + 2 * m_hs)
        m_cyl, m_hs = m_cyl * scale, m_hs * scale
        izz = m_cyl * r * r / 2.0 + 2 * m_hs * (2.0 / 5.0) * r * r
        ixx = (
            m_cyl * (length * length / 12.0 + r * r / 4.0)
            + 2 * m_hs * (2.0 / 5.0 * r * r + h * h + 0.75 * h * r)
        )
        return m, np.diag([ixx, ixx, izz])
    if g.gtype == "cylinder":
        r, h = float(g.size[0]), float(g.size[1])
        length = 2.0 * h
        m = g.mass if g.mass is not None else rho * np.pi * r * r * length
        izz = m * r * r / 2.0
        ixx = m * (length * length / 12.0 + r * r / 4.0)
        return m, np.diag([ixx, ixx, izz])
    if g.gtype == "box":
        sx, sy, sz = (2.0 * np.asarray(g.size)).tolist()
        m = g.mass if g.mass is not None else rho * sx * sy * sz
        return m, m / 12.0 * np.diag([sy**2 + sz**2, sx**2 + sz**2, sx**2 + sy**2])
    raise ValueError(f"unsupported geom type {g.gtype}")


# every numeric field of a finalized Model that the dynamics read
ARRAY_FIELDS = (
    "body_pos", "body_quat", "qpos0", "gravity", "body_mass", "body_com", "body_inertia",
    "contact_body", "contact_offset", "contact_radius", "contact_friction", "contact_margin",
    "contact_solref", "contact_solimp", "limit_q_idx", "limit_range", "limit_solref", "limit_solimp",
    "pair_body1", "pair_body2", "pair_a1", "pair_b1", "pair_a2", "pair_b2", "pair_radius", "pair_r1",
    "pair_friction", "pair_condim", "pair_margin", "pair_solref", "pair_solimp",
)
SCALAR_FIELDS = (
    "nbody", "nq", "timestep", "integrator", "fluid_density", "fluid_viscosity", "contact_stiffness",
    "contact_damping", "contact_model", "contact_iterations", "enable_pair_contacts",
)


def model_from_arrays(fields: dict, joints: list[dict], actuators: list[dict]) -> Model:
    """Build a finalized :class:`Model` from plain data, without the MJCF
    loader and without ``finalize``: ``fields`` maps every name of
    :data:`ARRAY_FIELDS` to a numpy array and every name of
    ``SCALAR_FIELDS`` plus ``parent`` and ``body_names`` to its value;
    ``joints`` and ``actuators`` are lists of the dataclasses' fields as
    dicts. Geoms are not carried: their effect is in the derived tables."""
    missing = [k for k in (*ARRAY_FIELDS, *SCALAR_FIELDS, "parent", "body_names") if k not in fields]
    if missing:
        raise ValueError(f"model_from_arrays: missing fields {missing}")
    js = []
    for j in joints:
        j = dict(j)
        j["axis"] = np.asarray(j["axis"], float)
        j["pos"] = np.asarray(j["pos"], float)
        j["range"] = tuple(float(x) for x in j["range"])
        js.append(Joint(**j))
    model = Model(
        nbody=int(fields["nbody"]), parent=[int(p) for p in fields["parent"]],
        body_pos=np.array(fields["body_pos"], float), body_quat=np.array(fields["body_quat"], float),
        body_names=list(fields["body_names"]), joints=js, geoms=[],
        actuators=[Actuator(**dict(a)) for a in actuators], nq=int(fields["nq"]),
        qpos0=np.array(fields["qpos0"], float),
    )
    for k in ARRAY_FIELDS:
        setattr(model, k, np.array(fields[k]))
    for k in SCALAR_FIELDS:
        setattr(model, k, fields[k])
    return model
