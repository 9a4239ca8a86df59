"""Geom-pair (self-collision) contact rows of the port's plain dynamics.

The five cases of ``tests/test_physics_pair_contacts.py`` run on the port:
small two-body scenes loaded into the port and into real MuJoCo from one MJCF
string (a free body dropped onto a world-welded one; Euler at matched
timesteps), the Humanoid pair tables, and a stable Humanoid. The port's
``dynamics.step`` with pair rows is held against the JAX package's vmapped
``dynamics.step`` on Humanoid states with active pairs, and on a scene at its
condim-3 impact. The MuJoCo comparisons of ``tests/test_physics_contact.py``
run on the port too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from tianshou_tpu.env.physics import dynamics as jdyn
from tianshou_tpu.env.physics.mjcf import load_mjcf as jax_load
from tianshou_tpu_torch.env.mujoco import Humanoid, make as torch_make
from tianshou_tpu_torch.env.physics import dynamics as tdyn
from tianshou_tpu_torch.env.physics.mjcf import asset_path, load_mjcf as torch_load
from tianshou_tpu_torch.env.physics.model import HINGE, SLIDE, Geom, Joint, Model
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

Q_TOL = dict(rtol=2e-4, atol=2e-4)  # the tolerances the JAX package holds its fused step to
QD_TOL = dict(rtol=5e-3, atol=5e-3)


def _scene(drop_geom: str, anchor_geom: str, drop_pos: str = "0.08 0 1.2") -> str:
    return f"""
<mujoco>
  <option timestep="0.002" integrator="Euler" gravity="0 0 -9.81"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1" condim="3"/>
    <body name="anchor" pos="0 0 0.6">{anchor_geom}</body>
    <body name="ball" pos="{drop_pos}">
      <joint type="free"/>
      {drop_geom}
    </body>
  </worldbody>
</mujoco>
"""


SPHERES_1 = _scene('<geom type="sphere" size="0.2" condim="1" mass="1"/>',
                   '<geom type="sphere" size="0.3" condim="1" mass="1"/>')
CAPSULES = _scene('<geom type="capsule" fromto="-0.4 0 0 0.4 0 0" size="0.1" condim="1" mass="1"/>',
                  '<geom type="capsule" fromto="0 -0.4 0 0 0.4 0" size="0.12" condim="1" mass="1"/>',
                  drop_pos="0.05 0 1.0")
SPHERES_3 = _scene('<geom type="sphere" size="0.2" condim="3" mass="1"/>',
                   '<geom type="sphere" size="0.3" condim="3" mass="1"/>')


def _load(load, xml, tmp_path):
    path = tmp_path / "scene.xml"
    path.write_text(xml)
    model = load(str(path))
    model.enable_pair_contacts = True
    model.contact_iterations = 30
    return model


def _rollout_mujoco(xml: str, steps: int) -> np.ndarray:
    m = mujoco.MjModel.from_xml_string(xml)
    d = mujoco.MjData(m)
    out = []
    for _ in range(steps):
        mujoco.mj_step(m, d)
        out.append(d.qpos[:3].copy())
    return np.stack(out)


def _rollout_port(model, steps: int) -> tuple[np.ndarray, list]:
    q, qd = tdyn.init_state(model, 1, device="cpu")
    ctrl = torch.zeros(1, len(model.actuators))
    out, states = [], []
    for _ in range(steps):
        states.append((q, qd))
        q, qd = tdyn.step(model, q, qd, ctrl, substeps=1)
        out.append(q[0, :3].numpy().copy())
    return np.stack(out), states


def _compare(xml: str, tmp_path, steps: int = 250, tol: float = 0.03):
    mj = _rollout_mujoco(xml, steps)
    dv, states = _rollout_port(_load(torch_load, xml, tmp_path), steps)
    err = np.abs(mj - dv).max(axis=1)
    # positions agree through free fall, impact and settling
    assert err.max() < tol, f"max |pos err| {err.max():.4f} over {steps} steps"
    return mj, dv, states


def test_sphere_on_static_sphere_frictionless(tmp_path):
    """A condim-1 sphere dropped off-centre onto a welded sphere: the pair row deflects it as
    MuJoCo's frictionless contact does."""
    mj, dv, _ = _compare(SPHERES_1, tmp_path)
    assert abs(mj[-1][0]) > 0.15 and abs(dv[-1][0]) > 0.15  # the impact deflected the ball in both


def test_capsule_cross_on_static_capsule(tmp_path):
    """A capsule falling crossed 90 degrees over a static capsule: contact at the segment-segment
    closest points (mid-capsule, not an end)."""
    _compare(CAPSULES, tmp_path)


def test_sphere_pair_with_friction_condim3(tmp_path):
    """A condim-3 pair: the four pyramid facet rows brake tangential slip as MuJoCo's pyramidal cone
    does (default friction 1)."""
    _compare(SPHERES_3, tmp_path, tol=0.04)


def test_pair_tables_match_mujoco_filtering():
    """Humanoid's candidate pairs follow MuJoCo's weld-aware filter: no same-weld (foot against its own
    shin) or parent-weld pairs, cross-limb pairs kept."""
    m = torch_load("humanoid.xml")
    names = m.body_names
    pairs = {(names[a], names[b]) for a, b in zip(m.pair_body1, m.pair_body2)}
    sym = pairs | {(b, a) for a, b in pairs}
    assert ("right_foot", "left_shin") in sym
    assert ("right_foot", "right_shin") not in sym       # same weld
    assert ("right_thigh", "right_shin") not in sym      # parent
    assert ("right_foot", "left_foot") in sym
    assert ("lwaist", "right_lower_arm") in sym
    assert (m.pair_condim == 1).all()                    # humanoid geoms are condim 1
    for task in ("ant.xml", "half_cheetah.xml", "walker2d.xml"):  # masked-off self-collision stays off
        assert len(torch_load(task).pair_body1) == 0


def test_humanoid_steps_stably_with_pairs():
    """Humanoid with 109 pair rows: steps are finite and the standing pose is not launched by
    phantom contacts."""
    env = Humanoid()
    assert env.model.enable_pair_contacts and len(env.model.pair_body1) > 50
    g = torch.Generator().manual_seed(0)
    s, _ = env.reset(1, g, torch.device("cpu"))
    for _ in range(10):
        s = env.step(s, torch.zeros(1, len(env.model.actuators)), g).state
    assert bool(torch.isfinite(s.q).all()) and bool(torch.isfinite(s.qd).all())
    assert 1.0 < float(s.q[0, 2]) < 1.6  # the torso stays near standing height under zero control


@functools.cache
def humanoid_case():
    """(JAX model, port model, q, qd, ctrl): Humanoid states with bent joints, some pairs and floor
    contacts active."""
    jm, tm = jax_load("humanoid.xml"), torch_load("humanoid.xml")
    for m in (jm, tm):
        m.enable_pair_contacts = True
        m.contact_iterations = 30
    rng = np.random.default_rng(1)
    E = 8
    q = (jm.qpos0[None] + 0.6 * rng.standard_normal((E, jm.nq))).astype(np.float32)
    q[:, :6] = jm.qpos0[:6]
    q[:, 2] -= 0.35
    qd = (0.5 * rng.standard_normal((E, jm.nq))).astype(np.float32)
    ctrl = rng.uniform(-0.4, 0.4, (E, len(jm.actuators))).astype(np.float32)
    return jm, tm, q, qd, ctrl


def test_humanoid_step_with_pair_rows_matches_jax_vmapped_step():
    """One substep of the port's ``dynamics.step`` against JAX's vmapped ``dynamics.step`` on the
    same Humanoid states, at the fused step's tolerances; the pair rows move the result."""
    jm, tm, q, qd, ctrl = humanoid_case()
    contacts, limits = tdyn.active_rows(tm, torch.from_numpy(q))
    pair_rows = tdyn.active_pair_rows(tm, torch.from_numpy(q))
    assert int(pair_rows.sum()) > 0 and int(contacts.sum()) > 0 and int(limits.sum()) > 0
    q_ref, qd_ref = jax.jit(jax.vmap(lambda a, b, c: jdyn.step(jm, a, b, c, frame_skip=1, substeps=1)))(q, qd, ctrl)
    args = [torch.from_numpy(x) for x in (q, qd, ctrl)]
    q_new, qd_new = tdyn.step(tm, *args, frame_skip=1, substeps=1)
    np.testing.assert_allclose(q_new.numpy(), np.asarray(q_ref), **Q_TOL)
    np.testing.assert_allclose(qd_new.numpy(), np.asarray(qd_ref), **QD_TOL)
    tm.enable_pair_contacts = False
    try:
        _, qd_off = tdyn.step(tm, *args, frame_skip=1, substeps=1)
    finally:
        tm.enable_pair_contacts = True
    moved = (qd_off - qd_new).abs().amax(1)
    assert float(moved[pair_rows > 0].min()) > 1e-2 and float(moved[pair_rows == 0].max()) < 1e-3


def test_condim3_pair_rows_match_jax_at_impact(tmp_path):
    """The condim-3 scene's state just after impact (its four facet rows active, friction on the
    contact surface point) stepped by both packages from the same numbers."""
    tm, jm = _load(torch_load, SPHERES_3, tmp_path), _load(jax_load, SPHERES_3, tmp_path)
    _, states = _rollout_port(tm, 250)
    hit = next(i for i, (q, _) in enumerate(states) if int(tdyn.active_pair_rows(tm, q)) == 4)
    q, qd = (x.numpy() for x in states[hit + 3])
    assert int(tdyn.active_pair_rows(tm, torch.from_numpy(q))) == 4
    step = jax.jit(jax.vmap(lambda a, b: jdyn.step(jm, a, b, jnp.zeros(0), substeps=1)))
    q_ref, qd_ref = step(q, qd)
    q_new, qd_new = tdyn.step(tm, torch.from_numpy(q), torch.from_numpy(qd), torch.zeros(1, 0), substeps=1)
    np.testing.assert_allclose(q_new.numpy(), np.asarray(q_ref), **Q_TOL)
    np.testing.assert_allclose(qd_new.numpy(), np.asarray(qd_ref), **QD_TOL)


def test_segment_closest_points_match_jax():
    """``_seg_seg_closest`` on general, parallel, crossing and zero-length segments."""
    rng = np.random.default_rng(5)
    p = rng.standard_normal((4, 64, 3)).astype(np.float32)
    p[1, :8] = p[0, :8]                         # segment 1 a point
    p[3, 8:16] = p[2, 8:16]                     # segment 2 a point
    p[1, 16:24], p[3, 16:24] = p[0, 16:24], p[2, 16:24]  # both points
    p[3, 24:32] = p[2, 24:32] + (p[1, 24:32] - p[0, 24:32])  # parallel
    s_ref, t_ref = jdyn._seg_seg_closest(*(jnp.asarray(x) for x in p))
    s, t = tdyn._seg_seg_closest(*(torch.from_numpy(x) for x in p))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_physics_contact.py's MuJoCo comparisons, on the port
# ---------------------------------------------------------------------------
def _sphere_on_plane_model():
    g = Geom(gtype="sphere", body=0, size=np.array([0.1]), pos=np.zeros(3), rot=np.eye(3), friction=1.0,
             solref=(0.02, 1.0), solimp=(0.8, 0.8, 0.01, 0.5, 2.0))
    return Model(
        nbody=1, parent=[-1], body_pos=np.zeros((1, 3)), body_quat=np.array([[1.0, 0, 0, 0]]), body_names=["b"],
        joints=[Joint(jtype=SLIDE, body=0, axis=np.array([0.0, 0, 1]), pos=np.zeros(3), q_idx=0),
                Joint(jtype=SLIDE, body=0, axis=np.array([1.0, 0, 0]), pos=np.zeros(3), q_idx=1)],
        geoms=[g], actuators=[], nq=2, qpos0=np.array([0.095, 0.0]),
        floor_solref=(0.02, 1.0), floor_solimp=(0.9, 0.95, 0.001, 0.5, 2.0), floor_friction=1.0,
    ).finalize()


SPHERE_XML = """
<mujoco><option timestep="0.002"/>
<worldbody><geom type="plane" size="5 5 .1"/>
<body pos="0 0 0.095"><joint type="slide" axis="0 0 1"/><joint type="slide" axis="1 0 0"/>
<geom type="sphere" size="0.1" friction="1" solref="0.02 1" solimp="0.8 0.8 0.01"/></body>
</worldbody></mujoco>"""


def _constraint_force(model, q, qd, f_free=None):
    q, qd = torch.tensor([q], dtype=torch.float32), torch.tensor([qd], dtype=torch.float32)
    c = tdyn._consts(model, q)
    k = tdyn._kinematics(model, c, q, qd)
    f = tdyn._gravity(c, k) if f_free is None else f_free
    return tdyn._constraint_force(model, c, k, q, qd, f)[0].numpy()


def test_contact_force_matches_mujoco_exactly():
    model = _sphere_on_plane_model()
    m = mujoco.MjModel.from_xml_string(SPHERE_XML)
    d = mujoco.MjData(m)
    for vz, vx in [(0.0, 0.0), (-1.0, 0.0), (0.0, 0.5), (-1.0, 0.5), (0.5, -0.3)]:
        mujoco.mj_resetData(m, d)
        d.qvel[0], d.qvel[1] = vz, vx
        mujoco.mj_forward(m, d)
        np.testing.assert_allclose(_constraint_force(model, [0.095, 0.0], [vz, vx]), d.qfrc_constraint,
                                   rtol=2e-3, atol=1e-3)


LIMIT_XML = """
<mujoco><option timestep="0.002" gravity="0 0 0"/>
<worldbody>
<body pos="0 0 1"><joint type="hinge" axis="0 1 0" range="-50 50" limited="true"/>
<geom type="capsule" fromto="0 0 0 0.5 0 0" size="0.05"/></body>
</worldbody></mujoco>"""


def _hinge_limit_model():
    lim = np.deg2rad(50)
    g = Geom(gtype="capsule", body=0, size=np.array([0.05, 0.25]), pos=np.array([0.25, 0, 0]),
             rot=np.stack([np.array([0.0, 0, 1]), np.array([0.0, 1, 0]), np.array([1.0, 0, 0])], axis=1))
    model = Model(
        nbody=1, parent=[-1], body_pos=np.array([[0.0, 0, 1]]), body_quat=np.array([[1.0, 0, 0, 0]]), body_names=["b"],
        joints=[Joint(jtype=HINGE, body=0, axis=np.array([0.0, 1, 0]), pos=np.zeros(3), q_idx=0, limited=True,
                      range=(-lim, lim))],
        geoms=[g], actuators=[], nq=1, qpos0=np.array([0.0]), gravity=np.zeros(3),
    ).finalize()
    # the capsule's ends would touch the z = 0 plane of this synthetic model; the MuJoCo oracle has no
    # plane, so the contact rows are dropped
    model.contact_body = np.zeros(0, np.int32)
    model.contact_offset = np.zeros((0, 3))
    for name in ("contact_radius", "contact_friction", "contact_margin"):
        setattr(model, name, np.zeros(0))
    model.contact_solref, model.contact_solimp = np.zeros((0, 2)), np.zeros((0, 5))
    return model


def test_joint_limit_force_matches_mujoco_exactly():
    model = _hinge_limit_model()
    m = mujoco.MjModel.from_xml_string(LIMIT_XML)
    d = mujoco.MjData(m)
    lim = np.deg2rad(50)
    for qpos, qvel in [(lim + 0.01, 0.0), (lim + 0.01, 1.0), (lim + 0.01, -1.0),
                       (-lim - 0.02, 0.5), (lim - 0.01, 0.0), (-lim - 0.005, -2.0)]:
        mujoco.mj_resetData(m, d)
        d.qpos[0], d.qvel[0] = qpos, qvel
        mujoco.mj_forward(m, d)
        np.testing.assert_allclose(_constraint_force(model, [qpos], [qvel], torch.zeros(1, 1)), d.qfrc_constraint,
                                   rtol=2e-3, atol=1e-3)


@pytest.mark.parametrize("task,bound", [("Hopper", 0.12), ("Walker2d", 0.15)])
def test_locomotion_step_parity_vs_mujoco(task, bound):
    """Per-step qvel error against real MuJoCo along a random-action rollout, below the JAX
    package's bounds (which the penalty model failed by 3-5x)."""
    env = torch_make(task)
    m = mujoco.MjModel.from_xml_path(asset_path(env.xml))
    d = mujoco.MjData(m)
    rng = np.random.default_rng(0)
    mujoco.mj_resetData(m, d)
    d.qpos[:] += rng.uniform(-0.005, 0.005, m.nq)
    d.qvel[:] = rng.uniform(-0.005, 0.005, m.nv)
    err_sum = mag_sum = 0.0
    for _ in range(60):
        a = rng.uniform(-1, 1, m.nu)
        q0, qd0 = d.qpos.copy(), d.qvel.copy()
        d.ctrl[:] = a
        for _ in range(env.frame_skip):
            mujoco.mj_step(m, d)
        _, qd1 = tdyn.step(env.model, *(torch.tensor(x[None], dtype=torch.float32) for x in (q0, qd0, a)),
                           frame_skip=env.frame_skip)
        err_sum += np.linalg.norm(qd1[0].numpy() - d.qvel)
        mag_sum += np.linalg.norm(d.qvel - qd0)
        if not np.isfinite(d.qpos).all() or d.qpos[1] < 0.5:
            mujoco.mj_resetData(m, d)
            d.qpos[:] += rng.uniform(-0.005, 0.005, m.nq)
            d.qvel[:] = rng.uniform(-0.005, 0.005, m.nv)
    rel = err_sum / max(mag_sum, 1e-9)
    assert rel < bound, f"{task} per-step rel error {rel:.3f} >= {bound}"
