"""The port's batched dynamics against the JAX package's, on the same numpy
inputs. The port computes the bias force and the contact-point accelerations
from explicit second-order jets where JAX differentiates energies, so these
tests also hold that identity."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.env.physics import algebra as jalg
from tianshou_tpu.env.physics import batched as jbatched
from tianshou_tpu.env.physics import dynamics as jdyn
from tianshou_tpu.env.physics import linalg as jlin
from tianshou_tpu.env.physics.mjcf import load_mjcf as jax_load
from tianshou_tpu_torch.env.physics import algebra as talg
from tianshou_tpu_torch.env.physics import dynamics as tdyn
from tianshou_tpu_torch.env.physics import linalg as tlin
from tianshou_tpu_torch.env.physics.mjcf import load_mjcf as torch_load
from tianshou_tpu_torch.env.physics.model import ARRAY_FIELDS, SCALAR_FIELDS, model_from_arrays
from tianshou_tpu_torch.ops.kernels.physics_fused import TASK_ASSETS
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

# task -> (frame_skip, substeps, contact iterations, drop of the root height that puts spheres on the floor)
CFG = {
    "HalfCheetah": (5, None, 12, (1, 0.1)), "Hopper": (4, None, 12, (1, 0.15)), "Walker2d": (4, None, 12, (1, 0.15)),
    "Ant": (1, 1, 30, (2, 0.2)), "Swimmer": (4, None, 12, None), "Reacher": (2, None, 12, None),
}
TASKS = sorted(CFG)
E = 4
Q_TOL = dict(rtol=2e-4, atol=2e-4)   # the tolerances the JAX package holds its own fused step to
QD_TOL = dict(rtol=5e-3, atol=5e-3)
TIGHT = dict(rtol=1e-5, atol=1e-6)


@functools.cache
def case(task):
    """(JAX model, port model, q, qd, ctrl) with E random states, some spheres in contact."""
    _, _, iters, drop = CFG[task]
    jm, tm = jax_load(TASK_ASSETS[task]), torch_load(TASK_ASSETS[task])
    jm.contact_iterations = tm.contact_iterations = iters
    rng = np.random.default_rng(0)
    q = (jm.qpos0[None] + 0.1 * rng.standard_normal((E, jm.nq))).astype(np.float32)
    if drop:
        q[:, drop[0]] -= drop[1]
    if task == "Reacher":
        q[:2, 1] = (3.05, -3.05)  # the elbow beyond its range of +-3 rad, so limit rows act
    if task == "Swimmer":
        q[:2, 3] = (1.8, -1.8)    # the first motor joint beyond its range of +-100 degrees
    qd = (0.5 * rng.standard_normal((E, jm.nq))).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (E, len(jm.actuators))).astype(np.float32)
    return jm, tm, q, qd, ctrl


@functools.cache
def jax_step(task, frame_skip, substeps):
    jm = case(task)[0]
    return jax.jit(jax.vmap(lambda q, qd, c: jdyn.step(jm, q, qd, c, frame_skip=frame_skip, substeps=substeps)))


def t(*arrays):
    out = tuple(torch.from_numpy(np.array(a)) for a in arrays)
    return out if len(out) > 1 else out[0]


def close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("task", TASKS)
def test_kinematics_mass_matrix_and_energies(task):
    jm, tm, q, qd, _ = case(task)

    def jax_all(q_, qd_):
        return (*jdyn.forward_kinematics(jm, q_), jdyn.mass_matrix(jm, q_), jdyn.kinetic_energy(jm, q_, qd_),
                jdyn.potential_energy(jm, q_))

    p, R, M, T, V = jax.jit(jax.vmap(jax_all))(q, qd)
    tp, tR = tdyn.forward_kinematics(tm, t(q))
    close(tp, p, **TIGHT)
    close(tR, R, **TIGHT)
    # atol 5e-6, not 1e-6: Swimmer's M has entries up to 107 summed over bodies, and one entry of
    # 6e-3 that they cancel to differs by 1.3e-6 between the two float32 evaluations (measured)
    close(tdyn.mass_matrix(tm, t(q)), M, rtol=1e-5, atol=5e-6)
    close(tdyn.kinetic_energy(tm, *t(q, qd)), T, **TIGHT)
    close(tdyn.potential_energy(tm, t(q)), V, **TIGHT)


@pytest.mark.parametrize("task", TASKS)
def test_bias_force(task):
    jm, tm, q, qd, _ = case(task)
    want = jax.jit(jax.vmap(lambda a, b: jdyn.bias_force(jm, a, b)))(q, qd)
    # atol 5e-6, not 1e-6: Swimmer's bias entries are sums of terms of size ~25 that cancel to
    # ~1e-2, and the two float32 evaluations differ there by 2.2e-6 (measured)
    close(tdyn.bias_force(tm, *t(q, qd)), want, rtol=1e-5, atol=5e-6)


@pytest.mark.parametrize("task", TASKS)
def test_constraint_force(task):
    jm, tm, q, qd, _ = case(task)
    f_free = np.random.default_rng(1).standard_normal(q.shape).astype(np.float32)

    def jax_force(q_, qd_, f_):
        M, pcom, R, dp, dR = jdyn.mass_matrix_fk(jm, q_)
        return jdyn._contact_forces_constraint(jm, q_, qd_, f_, M, fk=(pcom, R, dp, dR))

    want = np.asarray(jax.jit(jax.vmap(jax_force))(q, qd, f_free))
    tq, tqd, tf = t(q, qd, f_free)
    c = tdyn._consts(tm, tq)
    got = tdyn._constraint_force(tm, c, tdyn._kinematics(tm, c, tq, tqd), tq, tqd, tf)
    assert np.abs(want).max() > 1.0  # some rows are active
    # the force is the fixed point of 12 or 30 APGD iterations over rows with stiffness ~1e4:
    # float32 reassociation in A = J M^-1 J^T moves it by up to ~1e-4 of its size (measured)
    close(got, want, rtol=1e-3, atol=1e-3 * float(np.abs(want).max()))


@pytest.mark.parametrize("task", TASKS)
def test_step_matches_vmapped_jax_step(task):
    frame_skip, substeps, _, _ = CFG[task]
    jm, tm, q, qd, ctrl = case(task)
    q_ref, qd_ref = jax_step(task, frame_skip, substeps)(q, qd, ctrl)
    q_new, qd_new = tdyn.step(tm, *t(q, qd, ctrl), frame_skip=frame_skip, substeps=substeps)
    close(q_new, q_ref, **Q_TOL)
    close(qd_new, qd_ref, **QD_TOL)


def test_step_recharts_a_free_joint_beyond_pi():
    jm, tm, q, qd, ctrl = case("Ant")
    q = q.copy()
    axis = np.random.default_rng(2).standard_normal((E, 3))
    q[:, 3:6] = (axis / np.linalg.norm(axis, axis=1, keepdims=True) * np.array([3.2, 3.3, 3.0, 3.5])[:, None]).astype(np.float32)
    q[:, 2] += 0.5  # clear of the floor in any orientation
    q_ref, qd_ref = jax_step("Ant", 1, 1)(q, qd, ctrl)
    q_new, qd_new = tdyn.step(tm, *t(q, qd, ctrl), frame_skip=1, substeps=1)
    norms = np.linalg.norm(q_new.numpy()[:, 3:6], axis=1)
    assert (norms[[0, 1, 3]] < np.pi).all() and norms[2] > 2.9  # three envs re-charted, one left alone
    close(q_new, q_ref, **Q_TOL)
    close(qd_new, qd_ref, **QD_TOL)


def test_step_matches_env_last_step_b():
    jm, tm, q, qd, ctrl = case("HalfCheetah")
    q_ref, qd_ref = jax.jit(lambda a, b, c: jbatched.step_b(jm, a, b, c, frame_skip=1))(q.T, qd.T, ctrl.T)
    q_new, qd_new = tdyn.step(tm, *t(q, qd, ctrl), frame_skip=1)
    close(q_new, np.asarray(q_ref).T, **Q_TOL)
    close(qd_new, np.asarray(qd_ref).T, **QD_TOL)


def test_step_on_a_model_built_from_the_jax_models_arrays():
    """Rules the loader out: the port's Model is built from the JAX Model's fields."""
    frame_skip, substeps, _, _ = CFG["Hopper"]
    jm, _, q, qd, ctrl = case("Hopper")
    fields = {k: np.asarray(getattr(jm, k)) for k in ARRAY_FIELDS}
    fields.update({k: getattr(jm, k) for k in SCALAR_FIELDS})
    fields.update(parent=list(jm.parent), body_names=list(jm.body_names))
    tm = model_from_arrays(fields, [dataclasses.asdict(j) for j in jm.joints],
                           [dataclasses.asdict(a) for a in jm.actuators])
    q_ref, qd_ref = jax_step("Hopper", frame_skip, substeps)(q, qd, ctrl)
    q_new, qd_new = tdyn.step(tm, *t(q, qd, ctrl), frame_skip=frame_skip, substeps=substeps)
    close(q_new, q_ref, **Q_TOL)
    close(qd_new, qd_ref, **QD_TOL)


def test_penalty_contact_model_step():
    jm, tm = jax_load(TASK_ASSETS["Hopper"]), torch_load(TASK_ASSETS["Hopper"])
    jm.contact_model = tm.contact_model = "penalty"
    _, _, q, qd, ctrl = case("Hopper")
    q = q.copy()
    q[:, 3:] = np.clip(q[:, 3:], -0.3, -0.05)  # some joints beyond their limits, so limit springs act
    q_ref, qd_ref = jax.jit(jax.vmap(lambda a, b, c: jdyn.step(jm, a, b, c, frame_skip=1)))(q, qd, ctrl)
    q_new, qd_new = tdyn.step(tm, *t(q, qd, ctrl), frame_skip=1)
    close(q_new, q_ref, **Q_TOL)
    close(qd_new, qd_ref, **QD_TOL)


def test_pair_contacts_are_refused():
    """Geom-pair rows: the fused kernel's wrapper refuses them, as the TPU kernel does; the plain
    version computes them (held against JAX in tests/test_torch_physics_pairs.py)."""
    from tianshou_tpu_torch.ops.kernels.physics_fused import fused_step

    tm = torch_load("humanoid.xml")
    tm.enable_pair_contacts = True
    q, qd = tdyn.init_state(tm, 2, device="cpu")
    ctrl = torch.zeros(2, len(tm.actuators))
    with pytest.raises(NotImplementedError, match="pair"):
        fused_step(tm, q, qd, ctrl)
    q1, qd1 = tdyn.step(tm, q, qd, ctrl, frame_skip=1, substeps=1)
    assert q1.shape == (2, 23) and bool(torch.isfinite(q1).all() and torch.isfinite(qd1).all())
    assert float((q1 - q).abs().max()) > 0  # gravity moves it


@pytest.mark.parametrize("task", TASKS)
def test_actuation_substeps_and_init_state(task):
    jm, tm, _, _, ctrl = case(task)
    ctrl = ctrl * 1.5  # beyond the control range: clipped
    close(tdyn.actuation(tm, t(ctrl)), jax.vmap(lambda c: jdyn.actuation(jm, c))(ctrl), rtol=0, atol=0)
    assert tdyn.resolve_substeps(tm, None) == jbatched.resolve_substeps(jm, None)
    assert tdyn.resolve_substeps(tm, 3) == 3
    q0, qd0 = tdyn.init_state(tm, 3, device="cpu")
    jq0, jqd0 = jdyn.init_state(jm)
    assert q0.dtype == torch.float32 and q0.shape == (3, tm.nq)
    close(q0[1], jq0, rtol=0, atol=0)
    close(qd0[2], jqd0, rtol=0, atol=0)


def test_init_state_defaults_to_cuda(monkeypatch):
    """Without a device, ``init_state`` resolves to ``cuda`` as every entry point
    does, and raises without a GPU instead of moving to the CPU."""
    tm = torch_load(TASK_ASSETS["Hopper"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdyn.init_state(tm, 2)
    q0, _ = tdyn.init_state(tm, 2, device="cpu")
    assert q0.device.type == "cpu"


def test_active_rows_counts():
    _, tm, q, _, _ = case("Hopper")
    q = q.copy()
    q[0, 1] += 1.0            # env 0 lifted off the floor
    q[1, 3] = 0.2             # thigh joint of env 1 beyond its upper limit of 0
    contacts, limits = tdyn.active_rows(tm, t(q))
    assert contacts[0] == 0 and contacts[1] > 0 and limits[1] >= 1
    assert contacts.dtype == torch.int64 and contacts.shape == (E,)


ALGEBRA_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["hat_vee", "quat_to_mat", "mat_to_quat", "axis_angle_mat", "rotvec_to_mat",
                                  "rotvec_to_quat", "rotvec_jacobian", "inv3", "chol_solve"])
def test_algebra_and_linalg(name):
    rng = np.random.default_rng(3)
    v = rng.standard_normal((5, 3)).astype(np.float32)
    v[0] = 0.0  # the exp map at r = 0
    quat = rng.standard_normal((5, 4)).astype(np.float32)
    if name == "hat_vee":
        close(talg.hat(t(v)), jax.vmap(jalg.hat)(v), rtol=0, atol=0)
        close(talg.vee(talg.hat(t(v))), v, rtol=0, atol=0)
    elif name == "quat_to_mat":
        close(talg.quat_to_mat(t(quat)), jax.vmap(jalg.quat_to_mat)(quat), **ALGEBRA_TOL)
    elif name == "mat_to_quat":
        R = np.asarray(jax.vmap(jalg.rotvec_to_mat)(v * 1.5))
        close(talg.mat_to_quat(t(R)), jax.vmap(jalg.mat_to_quat)(R), **ALGEBRA_TOL)
    elif name == "axis_angle_mat":
        axis = (v[1] / np.linalg.norm(v[1])).astype(np.float32)
        close(talg.axis_angle_mat(t(axis), t(v[:, 0])), jax.vmap(lambda a: jalg.axis_angle_mat(jnp.asarray(axis), a))(v[:, 0]),
              **ALGEBRA_TOL)
    elif name == "rotvec_to_mat":
        close(talg.rotvec_to_mat(t(v)), jax.vmap(jalg.rotvec_to_mat)(v), **ALGEBRA_TOL)
    elif name == "rotvec_to_quat":
        close(talg.rotvec_to_quat(t(v)), jax.vmap(jalg.rotvec_to_quat)(v), **ALGEBRA_TOL)
    elif name == "rotvec_jacobian":
        # 1e-5: the r = 0 row divides tangents by sqrt(1e-9)
        close(tdyn._rotvec_jacobian(t(v)), jax.vmap(jdyn._rotvec_jacobian)(v), rtol=1e-5, atol=1e-5)
    elif name == "inv3":
        A = (rng.standard_normal((5, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
        close(tlin.inv3(t(A)), jlin.inv3(jnp.asarray(A)), rtol=1e-5, atol=1e-6)
    else:
        B = rng.standard_normal((5, 6, 6)).astype(np.float32)
        M = B @ B.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)
        b = rng.standard_normal((5, 6)).astype(np.float32)
        L = tlin.chol(t(M))
        close(L, jlin.chol(jnp.asarray(M)), rtol=1e-5, atol=1e-5)
        close(tlin.chol_solve(L, t(b)), jlin.chol_solve(jlin.chol(jnp.asarray(M)), jnp.asarray(b)), rtol=1e-4, atol=1e-5)
        close(tlin.spd_solve(t(M), t(b[..., None]))[..., 0], jlin.spd_solve(jnp.asarray(M), jnp.asarray(b)), rtol=1e-4, atol=1e-5)
        close(tlin.mm(t(M), t(M)), jlin.mm(jnp.asarray(M), jnp.asarray(M)), rtol=1e-5, atol=1e-4)
