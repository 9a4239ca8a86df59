"""Generalized-coordinate articulated dynamics on batched torch tensors.

The counterpart of both ``tianshou_tpu/env/physics/dynamics.py`` (per env,
batched by ``vmap``) and ``tianshou_tpu/env/physics/batched.py`` (the same
math with the env axis last, for the TPU's lanes): a torch tensor op is
batched already, so one batch-first module (``q, qd: [E, nq]``) serves for
both. It is also the plain version of the fused step kernel
(``ops/kernels/physics_fused.py``).

Where the JAX package differentiates energies (``grad``, ``jvp`` of ``grad``),
this module uses the explicit form of the same terms. Forward kinematics is
the one hand-written model function, evaluated over
:class:`~tianshou_tpu_torch.env.physics.jet.Jet` values:

- order 1 with the ``nq`` basis tangents gives the body Jacobians
  ``J_v = d pcom / dq`` and ``J_w = vee(dR R^T)``, so
  ``M = sum_b m J_v^T J_v + J_w^T I_world J_w + diag(armature)``;
- order 2 along ``qd`` gives body velocities ``v, w`` and the accelerations
  at ``qdd = 0``: ``a = d2/dt2 pcom(q + t qd)``, ``alpha = vee(Rdd R^T)``.

Then ``M qdd + c = tau`` with ``c = sum_b J_v^T m a + J_w^T (I alpha + w x I w)``,
which equals ``-(dT/dq - Mdot qd)`` in any chart (rotation vectors of a free
joint included), and gravity is ``sum_b J_v^T m g = -dV/dq``. Integration is
semi-implicit Euler with implicit joint damping; contacts and joint limits
are MuJoCo-style soft constraints solved by a fixed number of accelerated
projected-gradient iterations.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from tianshou_tpu_torch.env.physics.algebra import axis_angle_mat, rotvec_to_mat, vee
from tianshou_tpu_torch.env.physics.jet import Jet, stack
from tianshou_tpu_torch.env.physics.linalg import chol, chol_solve, inv3, mm, mv
from tianshou_tpu_torch.env.physics.model import FREE, SLIDE, Model
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = [
    "forward_kinematics", "kinetic_energy", "potential_energy", "mass_matrix", "bias_force",
    "actuation", "step", "init_state", "resolve_substeps", "quat_np", "active_rows", "active_pair_rows", "body_velocities",
    "center_of_mass",
]


def quat_np(q: np.ndarray) -> np.ndarray:
    """Numpy quaternion->matrix for static body offsets."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _armature(model: Model) -> np.ndarray:
    arm = np.zeros(model.nq)
    for j in model.joints:
        if j.jtype != FREE:
            arm[j.q_idx] = j.armature
    return arm


def _pair_rows(model: Model) -> int:
    if getattr(model, "enable_pair_contacts", False) and model.pair_body1 is not None:
        return len(model.pair_body1)
    return 0


def _consts(model: Model, ref: torch.Tensor) -> SimpleNamespace:
    """The model's float64 numpy constants as tensors of ``ref``'s dtype and
    device, cast once and kept on the model."""
    cache = model.__dict__.setdefault("_torch_consts", {})
    key = (ref.dtype, ref.device, _pair_rows(model))
    if key not in cache:
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=ref.dtype, device=ref.device)

        c = SimpleNamespace()
        c.body_pos = [t(model.body_pos[b]) for b in range(model.nbody)]
        c.body_rot = [t(quat_np(model.body_quat[b])) for b in range(model.nbody)]
        c.joint_axis = [t(j.axis) for j in model.joints]
        c.joint_anchor = [t(j.pos) for j in model.joints]
        c.com, c.mass, c.inertia = t(model.body_com), t(model.body_mass), t(model.body_inertia)
        c.gravity, c.armature = t(model.gravity), t(_armature(model))
        damping, stiffness, springref = np.zeros(model.nq), np.zeros(model.nq), np.zeros(model.nq)
        lo, hi = np.full(model.nq, -1e30), np.full(model.nq, 1e30)
        for j in model.joints:
            if j.jtype == FREE:
                continue
            damping[j.q_idx], stiffness[j.q_idx], springref[j.q_idx] = j.damping, j.stiffness, j.springref
            if j.limited:
                lo[j.q_idx], hi[j.q_idx] = j.range
        c.damping, c.stiffness, c.springref, c.lo, c.hi = t(damping), t(stiffness), t(springref), t(lo), t(hi)
        # contact spheres, relative to the body's centre of mass
        c.contact_e = t(model.contact_offset - model.body_com[model.contact_body]).reshape(-1, 3)
        c.contact_radius, c.contact_margin = t(model.contact_radius), t(model.contact_margin)
        c.contact_friction = t(model.contact_friction)
        c.contact_solref, c.contact_solimp = t(model.contact_solref), t(model.contact_solimp)
        c.limit_lo, c.limit_hi = t(model.limit_range[:, 0]), t(model.limit_range[:, 1])

        def idx(a):  # index tensors on the device: a CUDA graph cannot capture a numpy index's copy
            return torch.as_tensor(np.asarray(a, np.int64), device=ref.device)

        c.limit_idx = idx(model.limit_q_idx)
        c.limit_onehot = t(np.eye(model.nq)[np.asarray(model.limit_q_idx, np.int64)])  # [nl, nq]
        c.contact_body = idx(model.contact_body)
        c.limit_solref, c.limit_solimp = t(model.limit_solref), t(model.limit_solimp)
        c.facet_sign = t([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
        if _pair_rows(model):
            b1, b2 = np.asarray(model.pair_body1), np.asarray(model.pair_body2)
            i1, i3 = (np.where(cond)[0] for cond in (model.pair_condim < 3, model.pair_condim >= 3))
            # bodies of each pair; the condim-1 and the condim >= 3 pairs; the QP rows of each pair
            c.pair_b1, c.pair_b2, c.pair_i1, c.pair_i3 = idx(b1), idx(b2), idx(i1), idx(i3)
            c.pair_b1_3, c.pair_b2_3 = idx(b1[i3]), idx(b2[i3])
            c.pair_row_count = idx(np.where(model.pair_condim < 3, 1, 4))
            # segment ends of each candidate pair, relative to their bodies' centres of mass
            c.pair_e = [t(model.pair_a1 - model.body_com[b1]), t(model.pair_b1 - model.body_com[b1]),
                        t(model.pair_a2 - model.body_com[b2]), t(model.pair_b2 - model.body_com[b2])]
            c.pair_radius, c.pair_r1, c.pair_margin = t(model.pair_radius), t(model.pair_r1), t(model.pair_margin)
            c.pair_friction, c.pair_solref, c.pair_solimp = (t(model.pair_friction), t(model.pair_solref),
                                                             t(model.pair_solimp))
        gear = np.zeros((len(model.actuators), model.nq))
        for i, a in enumerate(model.actuators):
            gear[i, a.q_idx] = a.gear
        c.gear = t(gear)
        c.ctrl_lo = t([a.ctrlrange[0] for a in model.actuators])
        c.ctrl_hi = t([a.ctrlrange[1] for a in model.actuators])
        # equivalent inertia boxes of the legacy fluid model (mj_inertiaBoxFluid)
        m = np.maximum(model.body_mass, 1e-9)
        diag = np.einsum("bii->bi", model.body_inertia)
        box = np.sqrt(np.maximum(6.0 / m[:, None] * (diag.sum(1, keepdims=True) - 2 * diag), 1e-8))
        half = box / 2.0
        c.fluid_d_eq = t(box.mean(axis=1))
        c.fluid_area = t(np.stack([4 * half[:, 1] * half[:, 2], 4 * half[:, 0] * half[:, 2],
                                   4 * half[:, 0] * half[:, 1]], axis=1))
        c.fluid_it = t(np.stack([
            half[:, 1] ** 4 * half[:, 2] + half[:, 2] ** 4 * half[:, 1],
            half[:, 0] ** 4 * half[:, 2] + half[:, 2] ** 4 * half[:, 0],
            half[:, 0] ** 4 * half[:, 1] + half[:, 1] ** 4 * half[:, 0],
        ], axis=1))
        cache[key] = c
    return cache[key]


# ---------------------------------------------------------------------------
# kinematics
# ---------------------------------------------------------------------------
def _lift(x: torch.Tensor, order: int) -> Jet:
    """A constant ``[*s]`` as a jet ``[1, 1, *s]`` with zero derivatives."""
    x = x.reshape(1, 1, *x.shape)
    return Jet(x, *([torch.zeros_like(x)] * order))


def _fk(model: Model, c: SimpleNamespace, q: Jet) -> tuple[Jet, Jet]:
    """Body frame poses for ``q [E, K, nq]``: ``p [E, K, nb, 3]``, ``R [E, K, nb, 3, 3]``."""
    order = len(q.c) - 1
    ps: list[Jet] = []
    Rs: list[Jet] = []
    index_of = {id(j): i for i, j in enumerate(model.joints)}
    for b in range(model.nbody):
        par = model.parent[b]
        joints = model.joints_of(b)
        if joints and joints[0].jtype == FREE:
            # free joint: q holds the GLOBAL pose (pos, rotvec)
            i = joints[0].q_idx
            pb = q[..., i:i + 3]
            Rb = rotvec_to_mat(q[..., i + 3:i + 6])
        else:
            if par < 0:
                pb, Rb = _lift(c.body_pos[b], order), _lift(c.body_rot[b], order)
            else:
                pb = ps[par] + mv(Rs[par], c.body_pos[b])
                Rb = mm(Rs[par], c.body_rot[b])
            for j in joints:
                qi = q[..., j.q_idx] - j.ref
                axis, anchor = c.joint_axis[index_of[id(j)]], c.joint_anchor[index_of[id(j)]]
                if j.jtype == SLIDE:
                    pb = pb + mv(Rb, axis) * qi[..., None]
                else:  # HINGE about the anchor
                    Rj = axis_angle_mat(axis, qi)
                    pb = pb + mv(Rb, -mv(Rj, anchor) + anchor)
                    Rb = mm(Rb, Rj)
        ps.append(pb)
        Rs.append(Rb)
    return stack(ps, -2), stack(Rs, -3)


def _fk_com(model: Model, c: SimpleNamespace, q: Jet) -> tuple[Jet, Jet]:
    """COM world positions and body rotations."""
    p, R = _fk(model, c, q)
    return p + (R * c.com[:, None, :]).sum(-1), R


def forward_kinematics(model: Model, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Body frame poses for ``q [E, nq]``: ``(p [E, nb, 3], R [E, nb, 3, 3])``."""
    p, R = _fk(model, _consts(model, q), Jet(q[:, None, :]))
    E = q.shape[0]
    return p.v[:, 0].expand(E, -1, -1), R.v[:, 0].expand(E, -1, -1, -1)


def center_of_mass(model: Model, q: torch.Tensor) -> torch.Tensor:
    """The whole model's centre of mass ``[E, 3]``: the bodies' centres of mass weighted by mass."""
    c = _consts(model, q)
    pc, _ = _fk_com(model, c, Jet(q[:, None, :]))
    return (c.mass[:, None] * pc.v[:, 0]).sum(-2).expand(q.shape[0], -1) / c.mass.sum()


def body_velocities(model: Model, q: torch.Tensor, qd: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(pcom, R, vcom, omega)`` of every body for ``q, qd [E, nq]``: centre-of-mass positions and
    velocities ``[E, nb, 3]``, rotations ``[E, nb, 3, 3]`` and world angular velocities ``[E, nb, 3]``
    (one first-order pass of FK along ``qd``)."""
    pc, R = _fk_com(model, _consts(model, q), Jet(q[:, None, :], qd[:, None, :]))
    omega = vee(mm(R.c[1][:, 0], R.v[:, 0].transpose(-1, -2)))
    return pc.v[:, 0], R.v[:, 0], pc.c[1][:, 0], omega


def _kinematics(model: Model, c: SimpleNamespace, q: torch.Tensor, qd: torch.Tensor | None) -> SimpleNamespace:
    """Everything the dynamics take from FK at ``q`` (and along ``qd``)."""
    E, nq = q.shape
    k = SimpleNamespace()
    eye = torch.eye(nq, dtype=q.dtype, device=q.device)
    pc, R = _fk_com(model, c, Jet(q[:, None, :], eye[None]))
    k.pcom, k.R = pc.v[:, 0].expand(E, -1, -1), R.v[:, 0].expand(E, -1, -1, -1)
    k.Jv = pc.c[1].expand(E, -1, -1, -1)       # [E, nq, nb, 3]
    k.dR = R.c[1].expand(E, -1, -1, -1, -1)    # [E, nq, nb, 3, 3]
    k.Jw = vee(mm(k.dR, k.R.transpose(-1, -2)[:, None]))  # [E, nq, nb, 3]
    k.Iw = k.R @ c.inertia @ k.R.transpose(-1, -2)        # [E, nb, 3, 3]
    IJw = mv(k.Iw[:, None], k.Jw)
    k.M = ((k.Jv[:, :, None] * k.Jv[:, None, :]).sum(-1) * c.mass).sum(-1) \
        + (k.Jw[:, :, None] * IJw[:, None, :]).sum((-1, -2)) + torch.diag(c.armature)
    if qd is not None:
        pc2, R2 = _fk_com(model, c, Jet(q[:, None, :], qd[:, None, :], torch.zeros_like(q)[:, None, :]))
        k.vcom, k.acom = pc2.c[1][:, 0], pc2.c[2][:, 0]
        Rt = k.R.transpose(-1, -2)
        k.Rdd = R2.c[2][:, 0]
        k.omega = vee(mm(R2.c[1][:, 0], Rt))
        k.alpha = vee(mm(k.Rdd, Rt))  # the symmetric Rd Rd^T drops out of vee
    return k


def _project(k: SimpleNamespace, force: torch.Tensor, torque: torch.Tensor | None) -> torch.Tensor:
    """``sum_b J_v^T force_b + J_w^T torque_b`` for per-body ``[E, nb, 3]`` wrenches."""
    out = (k.Jv * force[:, None]).sum((-1, -2))
    if torque is not None:
        out = out + (k.Jw * torque[:, None]).sum((-1, -2))
    return out


def _bias_c(c: SimpleNamespace, k: SimpleNamespace) -> torch.Tensor:
    """Coriolis/centrifugal term ``c`` of ``M qdd + c = tau``."""
    Iw_om = mv(k.Iw, k.omega)
    torque = mv(k.Iw, k.alpha) + torch.linalg.cross(k.omega, Iw_om)
    return _project(k, c.mass[:, None] * k.acom, torque)


def _gravity(c: SimpleNamespace, k: SimpleNamespace) -> torch.Tensor:
    return _project(k, (c.mass[:, None] * c.gravity).expand_as(k.pcom), None)


# ---------------------------------------------------------------------------
# energies and the public derived quantities
# ---------------------------------------------------------------------------
def kinetic_energy(model: Model, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """Kinetic energy per env ``[E]``."""
    c = _consts(model, q)
    k = _kinematics(model, c, q, qd)
    T = 0.5 * (c.mass[:, None] * k.vcom * k.vcom).sum((-1, -2))
    T = T + 0.5 * (mv(k.Iw, k.omega) * k.omega).sum((-1, -2))
    return T + 0.5 * (c.armature * qd * qd).sum(-1)


def potential_energy(model: Model, q: torch.Tensor) -> torch.Tensor:
    c = _consts(model, q)
    pc, _ = _fk_com(model, c, Jet(q[:, None, :]))
    return -(c.mass * (pc.v[:, 0] * c.gravity).sum(-1)).sum(-1).expand(q.shape[0])


def mass_matrix(model: Model, q: torch.Tensor) -> torch.Tensor:
    """``M(q) [E, nq, nq]``."""
    return _kinematics(model, _consts(model, q), q, None).M


def bias_force(model: Model, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """Coriolis/centrifugal bias ``dT/dq - Mdot qd`` (so that
    ``M qdd = tau + bias - dV/dq``)."""
    c = _consts(model, q)
    return -_bias_c(c, _kinematics(model, c, q, qd))


# ---------------------------------------------------------------------------
# forces
# ---------------------------------------------------------------------------
def _passive_joint_forces(c, q, m_diag, include_limits: bool):
    """Joint springs (+ limit penalty springs in the legacy model), and the
    joint-space damping diagonal that is integrated implicitly."""
    tau = -c.stiffness * (q - c.springref)
    if not include_limits:
        return tau, c.damping.expand_as(q)
    omega_l = 2.0 / 0.02
    k_lim = m_diag * omega_l * omega_l
    d_lim = 2.0 * m_diag * omega_l
    viol_hi = torch.clamp(q - c.hi, min=0.0)
    viol_lo = torch.clamp(c.lo - q, min=0.0)
    in_viol = (viol_hi > 0) | (viol_lo > 0)
    tau = tau - k_lim * viol_hi + k_lim * viol_lo
    return tau, c.damping + torch.where(in_viol, d_lim, torch.zeros_like(d_lim))


def _body_points(k, bodies, e, need_acc: bool = False):
    """Points fixed in ``bodies`` at ``e`` (``[n, 3]`` or ``[E, n, 3]``) from each body's centre of
    mass, in its frame: world positions ``[E, n, 3]``, Jacobians ``[E, n, 3, nq]`` and, with
    ``need_acc``, the accelerations at ``qdd = 0`` (``Jdot qd``; :func:`_kinematics` with ``qd``)."""
    x = k.pcom[:, bodies] + mv(k.R[:, bodies], e)
    J = (k.Jv[:, :, bodies] + mv(k.dR[:, :, bodies], e[:, None] if e.dim() == 3 else e)).permute(0, 2, 3, 1)
    if not need_acc:
        return x, J
    return x, J, k.acom[:, bodies] + mv(k.Rdd[:, bodies], e)


def _contact_points(model, c, k, qd):
    """Contact-sphere centres ``x``, Jacobians ``J [E, nc, 3, nq]`` and velocities."""
    x, J = _body_points(k, c.contact_body, c.contact_e)
    return x, J, mv(J, qd[:, None, :])


def _seg_seg_closest(p1, q1, p2, q2, eps: float = 1e-9):
    """Closest-point parameters ``(s, t)`` in [0, 1] between segments ``[p1, q1]`` and ``[p2, q2]``
    over the leading axes (Ericson, Real-Time Collision Detection 5.1.9, without branches).
    Zero-length segments (spheres) degenerate safely."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a, e = (d1 * d1).sum(-1), (d2 * d2).sum(-1)
    f, c, b = (d2 * r).sum(-1), (d1 * r).sum(-1), (d1 * d2).sum(-1)
    one = torch.ones_like(a)
    a_s, e_s = torch.where(a > eps, a, one), torch.where(e > eps, e, one)
    denom = a * e - b * b
    s0 = torch.where(denom > eps, torch.clamp((b * f - c * e) / torch.where(denom > eps, denom, one), 0.0, 1.0),
                     torch.zeros_like(a))
    t0 = (b * s0 + f) / e_s
    # re-clamp s for t outside [0, 1] (the closest point on segment 2 is an end)
    s = torch.where(t0 < 0.0, torch.clamp(-c / a_s, 0.0, 1.0),
                    torch.where(t0 > 1.0, torch.clamp((b - c) / a_s, 0.0, 1.0), s0))
    # degenerate segments: point against segment, point against point
    s = torch.where(a > eps, s, torch.zeros_like(s))
    s = torch.where((e > eps) | (a <= eps), s, torch.clamp(-c / a_s, 0.0, 1.0))
    t = torch.where(e > eps, torch.clamp(t0, 0.0, 1.0), torch.zeros_like(t0))
    return s, t


def _pair_constraint_rows(model, c, k, qd, L_M):
    """The QP rows of the geom pairs (self-collision), one contact per candidate pair at the
    segment-segment closest points: a frictionless normal row for a condim-1 pair, the four
    pyramid facets for a condim >= 3 pair. A row's Jacobian is the gradient of the pair distance:
    ``n . (Jc1 - Jc2)`` at the fixed closest-point parameters (their minimizers, so the envelope
    theorem holds). Friction rows act at the contact surface point, held fixed in each body's frame.
    Returns ``(J, bias, aref, act, R)`` row blocks in the JAX package's order (condim-1 pairs, then
    condim >= 3)."""
    b1, b2 = c.pair_b1, c.pair_b2
    ea1, eb1, ea2, eb2 = c.pair_e
    A1, JA1, aA1 = _body_points(k, b1, ea1, True)
    B1, JB1, aB1 = _body_points(k, b1, eb1, True)
    A2, JA2, aA2 = _body_points(k, b2, ea2, True)
    B2, JB2, aB2 = _body_points(k, b2, eb2, True)
    s, t = _seg_seg_closest(A1, B1, A2, B2)
    c1, c2 = A1 + s[..., None] * (B1 - A1), A2 + t[..., None] * (B2 - A2)
    dvec = c1 - c2
    dist = torch.sqrt((dvec * dvec).sum(-1) + 1e-12)
    n = dvec / dist[..., None]
    s4, t4 = s[..., None, None], t[..., None, None]
    Jrel = JA1 + s4 * (JB1 - JA1) - JA2 - t4 * (JB2 - JA2)  # [E, np, 3, nq]
    Jn = (n[..., None] * Jrel).sum(-2)                      # [E, np, nq]
    sdist = dist - c.pair_radius
    pos = sdist - c.pair_margin
    active = (sdist < c.pair_margin).to(qd.dtype)
    d, kk, b = _sol_kb(c.pair_solref, c.pair_solimp, pos)
    vel_n = (Jn * qd[:, None, :]).sum(-1)
    s3, t3 = s[..., None], t[..., None]
    bias_n = (n * (aA1 + s3 * (aB1 - aA1) - aA2 - t3 * (aB2 - aA2))).sum(-1)  # Jdot qd at fixed (s, t)
    Jn_act = Jn * active[..., None]
    A_nn = (Jn_act * chol_solve(L_M, Jn_act.transpose(1, 2)).transpose(1, 2)).sum(-1)
    E, nq = qd.shape
    blocks = []
    i1, i3 = c.pair_i1, c.pair_i3
    if len(i1):
        # frictionless rows regularize like limit rows: R = (1 - d) / d A_ii
        blocks.append((Jn_act[:, i1], (bias_n * active)[:, i1], ((-b * vel_n - kk * pos) * active)[:, i1],
                       active[:, i1], ((1.0 - d) / d * A_nn)[:, i1]))
    if len(i3):
        n3 = n[:, i3]
        ex, ey = torch.zeros_like(n3), torch.zeros_like(n3)
        ex[..., 0], ey[..., 1] = 1.0, 1.0
        ref = torch.where((n3[..., 0].abs() < 0.9)[..., None], ex, ey)  # a tangent frame from the normal
        tan1 = torch.linalg.cross(ref, n3)
        tan1 = tan1 / torch.sqrt((tan1 * tan1).sum(-1, keepdim=True) + 1e-12)
        tan2 = torch.linalg.cross(n3, tan1)
        mu = c.pair_friction[i3]
        r1, r2 = c.pair_r1[i3], (c.pair_radius - c.pair_r1)[i3]
        bi1, bi2 = c.pair_b1_3, c.pair_b2_3
        # the contact point midway between the two surfaces along the normal, in each body's frame
        pc = 0.5 * (c1[:, i3] + c2[:, i3]) + 0.5 * (r2 - r1)[..., None] * n3
        e1c = mv(k.R[:, bi1].transpose(-1, -2), pc - k.pcom[:, bi1])
        e2c = mv(k.R[:, bi2].transpose(-1, -2), pc - k.pcom[:, bi2])
        _, J1c, a1c = _body_points(k, bi1, e1c, True)
        _, J2c, a2c = _body_points(k, bi2, e2c, True)
        Jc, relc_bias = J1c - J2c, a1c - a2c
        Jt1, Jt2 = (tan1[..., None] * Jc).sum(-2), (tan2[..., None] * Jc).sum(-2)
        s0, s1 = c.facet_sign[:, 0], c.facet_sign[:, 1]
        mu2 = mu[:, None]
        Jf = Jn[:, i3, None] + mu2[..., None] * (s0[:, None] * Jt1[:, :, None] + s1[:, None] * Jt2[:, :, None])
        vt1, vt2 = (Jt1 * qd[:, None, :]).sum(-1), (Jt2 * qd[:, None, :]).sum(-1)
        vel_f = vel_n[:, i3, None] + mu2 * (s0 * vt1[..., None] + s1 * vt2[..., None])
        bt1, bt2 = (tan1 * relc_bias).sum(-1), (tan2 * relc_bias).sum(-1)
        bias_f = bias_n[:, i3, None] + mu2 * (s0 * bt1[..., None] + s1 * bt2[..., None])
        act3 = active[:, i3]
        muc = torch.clamp(mu, min=1.0)
        R3 = (1.0 - d[:, i3]) / d[:, i3] * 2.0 * muc * muc * (1.0 + muc * muc) * A_nn[:, i3]
        aref = (-b[..., i3, None] * vel_f - (kk * pos)[:, i3, None]) * act3[..., None]
        k3 = len(i3)
        blocks.append(((Jf * act3[..., None, None]).reshape(E, 4 * k3, nq), (bias_f * act3[..., None]).reshape(E, -1),
                       aref.reshape(E, -1), act3.repeat_interleave(4, dim=1), R3.repeat_interleave(4, dim=1)))
    return blocks


def _external_forces(model, c, k, qd, include_contacts: bool) -> torch.Tensor:
    """Generalized forces of the ambient fluid and, in the legacy penalty
    model, of the plane contacts."""
    nc = len(model.contact_radius) if include_contacts else 0
    has_fluid = model.fluid_density > 0 or model.fluid_viscosity > 0
    tau = torch.zeros_like(qd)
    if has_fluid:
        Rt = k.R.transpose(-1, -2)
        v_l, w_l = mv(Rt, k.vcom), mv(Rt, k.omega)  # world -> body
        mu, rho = model.fluid_viscosity, model.fluid_density
        F_l = -3.0 * math.pi * mu * c.fluid_d_eq[:, None] * v_l
        T_l = -math.pi * mu * (c.fluid_d_eq ** 3)[:, None] * w_l
        if rho > 0:
            F_l = F_l - 0.5 * rho * c.fluid_area * v_l.abs() * v_l
            T_l = T_l - 0.5 * rho * c.fluid_it * w_l.abs() * w_l
        tau = tau + _project(k, mv(k.R, F_l), mv(k.R, T_l))
    if nc:
        x, J, v = _contact_points(model, c, k, qd)
        depth = c.contact_radius - x[..., 2]
        kp, kd = model.contact_stiffness, model.contact_damping
        fn = torch.where(depth > 0, torch.clamp(kp * depth - kd * v[..., 2], min=0.0), torch.zeros_like(depth))
        vt = v[..., :2]
        speed = torch.sqrt((vt * vt).sum(-1) + 1e-12)
        ft_mag = torch.minimum(2.0 * kd * speed, c.contact_friction * fn)  # viscous, capped by the cone
        f_contact = torch.cat([-vt * (ft_mag / speed)[..., None], fn[..., None]], -1)
        tau = tau + (J * f_contact[..., None]).sum((1, 2))
    return tau


def _impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MuJoCo's position-dependent impedance d(r): a two-piece power sigmoid
    from d0 to dmax over |pos|/width."""
    d0, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(pos.abs() / torch.clamp(width, min=1e-12), 0.0, 1.0)
    lo = mid * (x / mid) ** power
    hi = 1.0 - (1.0 - mid) * ((1.0 - x) / (1.0 - mid)) ** power
    return torch.clamp(d0 + torch.where(x < mid, lo, hi) * (dmax - d0), 1e-4, 0.9999)


def _sol_kb(solref: torch.Tensor, solimp: torch.Tensor, pos: torch.Tensor):
    """(d, k, b) from solref/solimp at violation ``pos``."""
    d = _impedance(solimp, pos)
    tau_c, zeta, dmax = solref[:, 0], solref[:, 1], solimp[:, 1]
    return d, d / (dmax * dmax * tau_c * tau_c * zeta * zeta), 2.0 / (dmax * tau_c)


def _constraint_force(model, c, k, q, qd, f_free) -> torch.Tensor:
    """Generalized constraint force (plane contacts, geom pairs when the model
    enables them, joint limits) of MuJoCo's soft-constraint model: the
    regularized dual QP ``min_{lam>=0} 1/2 lam^T (A+R) lam + lam^T (a0 - aref)``
    with contacts in the pyramidal facet basis (rows ``n +- mu t``) and one
    row per joint limit, ``A = J M^-1 J^T``. All candidate rows are computed
    and inactive ones masked to zero; the QP is solved by a fixed number of
    accelerated projected-gradient iterations with a Gershgorin step bound."""
    nc, nl = len(model.contact_radius), len(model.limit_q_idx)
    E, nq = q.shape
    L_M = chol(k.M)
    qdd0 = chol_solve(L_M, f_free)
    J_rows, bias_rows, aref_rows, act_rows, R_rows = [], [], [], [], []

    if nc:
        x, J, v = _contact_points(model, c, k, qd)
        cb = c.contact_body
        a_bias = k.acom[:, cb] + mv(k.Rdd[:, cb], c.contact_e)  # Jdot qd of the contact points
        dist = x[..., 2] - c.contact_radius
        pos = dist - c.contact_margin          # < 0 when the constraint is violated
        active = dist < c.contact_margin
        d, kk, b = _sol_kb(c.contact_solref, c.contact_solimp, pos)
        mu = c.contact_friction
        s0, s1 = c.facet_sign[:, 0], c.facet_sign[:, 1]

        def facets(a):  # [E, nc, 3, *] -> [E, nc, 4, *]: z + mu (s0 x + s1 y)
            sh = (1, 1, 4) + (1,) * (a.dim() - 3)
            tan = s0.reshape(sh) * a[:, :, None, 0] + s1.reshape(sh) * a[:, :, None, 1]
            return a[:, :, None, 2] + mu.reshape((1, nc, 1) + (1,) * (a.dim() - 3)) * tan

        Jf, vel_f, bias_f = facets(J), facets(v), facets(a_bias)
        act = active.to(q.dtype)
        Jn = J[:, :, 2] * act[..., None]
        A_nn = (Jn * chol_solve(L_M, Jn.transpose(1, 2)).transpose(1, 2)).sum(-1)
        muc = torch.clamp(mu, min=1.0)
        R_c = (1.0 - d) / d * 2.0 * muc * muc * (1.0 + muc * muc) * A_nn
        J_rows.append((Jf * act[:, :, None, None]).reshape(E, nc * 4, nq))
        bias_rows.append((bias_f * act[:, :, None]).reshape(E, nc * 4))
        aref_rows.append((-b[:, None] * vel_f - (kk * pos)[..., None]).reshape(E, nc * 4))
        act_rows.append(act.repeat_interleave(4, dim=1))
        R_rows.append(R_c.repeat_interleave(4, dim=1))

    if _pair_rows(model):
        for J_p, bias_p, aref_p, act_p, R_p in _pair_constraint_rows(model, c, k, qd, L_M):
            J_rows.append(J_p)
            bias_rows.append(bias_p)
            aref_rows.append(aref_p)
            act_rows.append(act_p)
            R_rows.append(R_p)

    if nl:
        li = c.limit_idx
        d_lo = q[:, li] - c.limit_lo
        d_hi = c.limit_hi - q[:, li]
        side = torch.where(d_lo < d_hi, 1.0, -1.0).to(q.dtype)  # +1: lower limit row
        dist_l = torch.minimum(d_lo, d_hi)
        act_l = (dist_l < 0.0).to(q.dtype)                      # limits have no margin
        d_l, k_l, b_l = _sol_kb(c.limit_solref, c.limit_solimp, dist_l)
        onehot = c.limit_onehot
        vel_l = side * qd[:, li]
        Minv = chol_solve(L_M, torch.eye(nq, dtype=q.dtype, device=q.device).expand(E, nq, nq))
        J_rows.append(onehot * (side * act_l)[..., None])
        bias_rows.append(torch.zeros_like(vel_l))
        aref_rows.append(-b_l * vel_l - k_l * dist_l)
        act_rows.append(act_l)
        R_rows.append((1.0 - d_l) / d_l * torch.diagonal(Minv, dim1=-2, dim2=-1)[:, li])

    Jr = torch.cat(J_rows, 1)
    aref = torch.cat(aref_rows, 1) * torch.cat(act_rows, 1)
    Rreg = torch.clamp(torch.cat(R_rows, 1), min=1e-10)
    g0 = mv(Jr, qdd0) + torch.cat(bias_rows, 1) - aref
    A = Jr @ chol_solve(L_M, Jr.transpose(1, 2))
    L = ((A.abs().sum(-1) + Rreg).max(-1).values + 1e-8)[:, None]

    lam = torch.zeros_like(g0)
    y, t = lam, 1.0
    for _ in range(int(getattr(model, "contact_iterations", 30))):
        grad = mv(A, y) + Rreg * y + g0
        lam_new = torch.clamp(y - grad / L, min=0.0)
        t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
        y = lam_new + (t - 1.0) / t_new * (lam_new - lam)
        lam, t = lam_new, t_new
    return (Jr * lam[..., None]).sum(1)


def active_rows(model: Model, q: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per env, how many contact spheres and how many joint limits are active
    at ``q``: ``(contacts [E], limits [E])`` as int64. A contact contributes
    four rows to the QP, a limit one."""
    c = _consts(model, q)
    E = q.shape[0]
    contacts = limits = torch.zeros(E, dtype=torch.int64, device=q.device)
    if len(model.contact_radius):
        pc, R = _fk_com(model, c, Jet(q[:, None, :]))
        cb = c.contact_body
        z = pc.v[:, 0, cb, 2] + mv(R.v[:, 0, cb], c.contact_e)[..., 2]
        contacts = (z - c.contact_radius < c.contact_margin).sum(-1)
    if len(model.limit_q_idx):
        ql = q[:, c.limit_idx]
        limits = (torch.minimum(ql - c.limit_lo, c.limit_hi - ql) < 0.0).sum(-1)
    return contacts, limits


def active_pair_rows(model: Model, q: torch.Tensor) -> torch.Tensor:
    """Per env, the QP rows of the geom pairs active at ``q`` (one per condim-1
    pair, four per condim >= 3 pair), ``[E]`` int64; 0 when the model does not
    enable pair contacts."""
    if not _pair_rows(model):
        return torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
    c = _consts(model, q)
    pc, R = _fk_com(model, c, Jet(q[:, None, :]))
    pc, R = pc.v[:, 0], R.v[:, 0]
    ends = [pc[:, b] + mv(R[:, b], e) for b, e in zip((c.pair_b1, c.pair_b1, c.pair_b2, c.pair_b2), c.pair_e)]
    s, t = _seg_seg_closest(*ends)
    dvec = (ends[0] + s[..., None] * (ends[1] - ends[0])) - (ends[2] + t[..., None] * (ends[3] - ends[2]))
    active = torch.sqrt((dvec * dvec).sum(-1) + 1e-12) - c.pair_radius < c.pair_margin
    return (active.to(torch.int64) * c.pair_row_count).sum(-1)


# ---------------------------------------------------------------------------
# actuation + integration
# ---------------------------------------------------------------------------
def actuation(model: Model, ctrl: torch.Tensor) -> torch.Tensor:
    """Clipped controls ``[E, nu]`` through the gears onto joint dofs ``[E, nq]``."""
    c = _consts(model, ctrl)
    return (torch.clamp(ctrl, c.ctrl_lo, c.ctrl_hi)[..., None] * c.gear).sum(-2)


def _substep(model: Model, c, q, qd, tau_act, dt: float):
    k = _kinematics(model, c, q, qd)
    use_constraint = getattr(model, "contact_model", "penalty") == "constraint" and (
        len(model.contact_radius) > 0 or len(model.limit_q_idx) > 0 or _pair_rows(model) > 0
    )
    tau_p, D = _passive_joint_forces(c, q, torch.diagonal(k.M, dim1=-2, dim2=-1), include_limits=not use_constraint)
    f = tau_act - _bias_c(c, k) + _gravity(c, k) + tau_p + _external_forces(
        model, c, k, qd, include_contacts=not use_constraint)
    if use_constraint:
        # the solver's unconstrained acceleration sees the damping force
        # explicitly; the integrator below applies damping implicitly, so it
        # is not added to f itself
        f = f + _constraint_force(model, c, k, q, qd, f - D * qd)
    # semi-implicit Euler with implicit joint-space damping:
    # (M + dt diag(D)) qd' = M qd + dt f
    qd_new = chol_solve(chol(k.M + dt * torch.diag_embed(D)), mv(k.M, qd) + dt * f)
    return q + dt * qd_new, qd_new


def _rotvec_jacobian(r: torch.Tensor) -> torch.Tensor:
    """``B(r) [E, 3, 3]`` with ``omega = B(r) @ rdot``, from the tangents of the exp map."""
    R = rotvec_to_mat(Jet(r[:, None, :], torch.eye(3, dtype=r.dtype, device=r.device)[None]))
    w = vee(mm(R.c[1], R.v.transpose(-1, -2)))  # [E, 3 (tangent), 3]
    return w.transpose(1, 2)


def _remap_free_rotations(model: Model, q: torch.Tensor, qd: torch.Tensor):
    """Keep free-joint rotation vectors in ``|r| <= pi``: the exp map is
    singular at ``|r| = 2 pi``, so a tumbling body is re-charted.
    ``r -> r (1 - 2 pi / |r|)`` is the same rotation; ``rdot`` is remapped so
    that the angular velocity ``B(r) rdot`` is unchanged."""
    for j in model.joints:
        if j.jtype != FREE:
            continue
        i = j.q_idx + 3
        r, rd = q[:, i:i + 3], qd[:, i:i + 3]
        norm = torch.sqrt((r * r).sum(-1, keepdim=True) + 1e-12)
        need = norm > math.pi
        r_new = r * (1.0 - 2.0 * math.pi / norm)
        omega = mv(_rotvec_jacobian(r), rd)
        rd_new = mv(inv3(_rotvec_jacobian(r_new)), omega)
        q = torch.cat([q[:, :i], torch.where(need, r_new, r), q[:, i + 3:]], 1)
        qd = torch.cat([qd[:, :i], torch.where(need, rd_new, rd), qd[:, i + 3:]], 1)
    return q, qd


def resolve_substeps(model: Model, substeps: int | None) -> int:
    """The integrator-aware substep default: 1 for models that declare Euler
    integration (semi-implicit Euler at the model's own timestep), else
    enough substeps for ``dt <= 2 ms``."""
    if substeps is not None:
        return substeps
    if getattr(model, "integrator", "euler") == "euler":
        return 1
    return max(1, int(np.ceil(model.timestep / 0.002 - 1e-9)))


def step(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, frame_skip: int = 1,
         substeps: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance ``frame_skip`` model timesteps, each split into ``substeps``
    integrator substeps (default: :func:`resolve_substeps`), for
    ``q, qd [E, nq]`` and ``ctrl [E, nu]``. Returns ``(q, qd)``."""
    substeps = resolve_substeps(model, substeps)
    c = _consts(model, q)
    tau = actuation(model, ctrl)
    dt = model.timestep / substeps
    has_free = any(j.jtype == FREE for j in model.joints)
    for _ in range(frame_skip * substeps):
        q, qd = _substep(model, c, q, qd, tau, dt)
        if has_free:
            q, qd = _remap_free_rotations(model, q, qd)
    return q, qd


def init_state(model: Model, num_envs: int, device: str | torch.device | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The home state of ``num_envs`` envs: ``(qpos0, 0)`` as float32 ``[E, nq]``
    on ``device`` (``cuda`` unless given, :func:`resolve_device`)."""
    q = torch.as_tensor(model.qpos0, dtype=torch.float32, device=resolve_device(device))
    q = q.expand(num_envs, -1).contiguous()
    return q, torch.zeros_like(q)
