"""The legacy ``contact_model="penalty"`` branch of the fused physics step.

The port's ``fused_step`` on a penalty model (on CPU tensors: its plain
version) is held against the JAX package's ``fused_step`` run in Pallas
interpret mode, on states that push contact spheres into the floor and joints
past their limits. The CUDA source's penalty branch (``-DTT_PENALTY=1``) is
compiled as host C++ here and held against the plain version, and against the
builds with other team sizes and lane orders. Tolerances: ``q`` 2e-4 and
``qd`` 5e-3 (rtol = atol), the ones the JAX package holds its fused step to,
after the task's whole ``frame_skip`` chain.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_physics_fused import Q_TOL, QD_TOL, host_library, host_step
from tianshou_tpu.env.mujoco import make as jax_make
from tianshou_tpu.ops.pallas.physics_fused import fused_step as jax_fused_step
from tianshou_tpu_torch.env.mujoco import make as torch_make
from tianshou_tpu_torch.ops.kernels import _build
from tianshou_tpu_torch.ops.kernels import physics_fused as pf
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

PENALTY = ("TT_PENALTY=1",)
# task -> (root coordinate, drop) that puts contact spheres below the floor
DROP = {"HalfCheetah": (1, 0.1), "Hopper": (1, 0.15), "Walker2d": (1, 0.15), "Ant": (2, 0.2)}


def pushed(model, task, E, seed):
    """States with spheres in the floor (penetration > 0) and joints past their limits."""
    rng = np.random.default_rng(seed)
    q = (np.asarray(model.qpos0)[None] + 0.3 * rng.standard_normal((E, model.nq))).astype(np.float32)
    if task in DROP:
        q[:, DROP[task][0]] -= DROP[task][1]
    qd = (0.5 * rng.standard_normal((E, model.nq))).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (E, len(model.actuators))).astype(np.float32)
    return q, qd, ctrl


def springs_active(model, q):
    """(sphere-env pairs with penetration, dof-env pairs past a limit) at ``q``."""
    from tianshou_tpu_torch.env.physics.dynamics import forward_kinematics

    pen = 0
    if len(model.contact_radius):
        p, R = forward_kinematics(model, torch.from_numpy(q))
        cb = np.asarray(model.contact_body)
        x = p[:, cb] + (R[:, cb] @ torch.as_tensor(model.contact_offset, dtype=torch.float32)[..., None])[..., 0]
        pen = int((x[..., 2] < torch.as_tensor(model.contact_radius, dtype=torch.float32)).sum())
    ql = q[:, np.asarray(model.limit_q_idx)]
    past = int(((ql < model.limit_range[:, 0]) | (ql > model.limit_range[:, 1])).sum())
    return pen, past


def penalty_pair(task):
    jenv, tenv = jax_make(task), torch_make(task)
    jenv.model.contact_model = tenv.model.contact_model = "penalty"
    return jenv, tenv


@pytest.mark.parametrize("task,E,block_e,one_substep", [("HalfCheetah", 6, 8, False), ("Hopper", 6, 8, False),
                                                       ("Ant", 4, 4, True)])
def test_penalty_fused_step_matches_jax_interpret(task, E, block_e, one_substep):
    jenv, tenv = penalty_pair(task)
    q, qd, ctrl = pushed(jenv.model, task, E, 0)
    pen, past = springs_active(tenv.model, q)
    assert pen > 0 and past > 0  # both kinds of springs act
    kw = dict(frame_skip=1, substeps=1) if one_substep else dict(frame_skip=int(jenv.frame_skip))
    q_ref, qd_ref = jax_fused_step(jenv.model, jnp.asarray(q).T, jnp.asarray(qd).T, jnp.asarray(ctrl).T,
                                   block_e=block_e, interpret=True, **kw)
    before = pf.launch_count()
    q_new, qd_new = pf.fused_step(tenv.model, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(ctrl), **kw)
    assert pf.launch_count() == before  # a CPU tensor launches nothing
    np.testing.assert_allclose(q_new.numpy(), np.asarray(q_ref).T, **Q_TOL)
    np.testing.assert_allclose(qd_new.numpy(), np.asarray(qd_ref).T, **QD_TOL)
    # the penalty model is not the constraint model on these states
    tenv.model.contact_model = "constraint"
    q_c, qd_c = pf.fused_step(tenv.model, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(ctrl), **kw)
    assert float((qd_c - qd_new).abs().max()) > 1e-2


@pytest.mark.parametrize("task", sorted(pf.TASK_ASSETS))
def test_penalty_kernel_source_as_host_code_matches_plain_version(task, tmp_path_factory):
    """The penalty branch compiled for the CPU against dynamics.step: one substep and the task's
    whole frame_skip, on pushed states and after a random-action rollout of the host build."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    env = torch_make(task)
    model = env.model
    model.contact_model = "penalty"
    fn = host_library(task, str(tmp_path_factory.getbasetemp()), PENALTY)
    q, qd, ctrl = pushed(model, task, 16, 1)
    rng = np.random.default_rng(2)
    for stage in range(2):
        for fs in (1, env.frame_skip):
            got = host_step(fn, model, q, qd, ctrl, fs)
            want = pf.fused_step_reference(model, *(torch.from_numpy(a) for a in (q, qd, ctrl)), frame_skip=fs)
            assert np.isfinite(got[0]).all() and np.isfinite(got[1]).all()
            np.testing.assert_allclose(got[0], want[0].numpy(), **Q_TOL)
            np.testing.assert_allclose(got[1], want[1].numpy(), **QD_TOL)
        for _ in range(8):  # roll on with random actions
            ctrl = rng.uniform(-1, 1, ctrl.shape).astype(np.float32)
            q, qd = host_step(fn, model, q, qd, ctrl, env.frame_skip)


@pytest.mark.parametrize("task,extra", [("HalfCheetah", ("TEAM=4",)), ("HalfCheetah", ("TT_REVERSE_LANES",)),
                                        ("Ant", ("TEAM=32", "TT_REVERSE_LANES")), ("Walker2d", ("TEAM=1",))])
def test_penalty_host_builds_agree_across_team_sizes_and_lane_orders(task, extra, tmp_path_factory):
    """The limit springs (a lane per dof) and the contact forces (a lane per body) are each one
    lane's, in a fixed order: another team size or the lanes in reverse give the same bits."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    env = torch_make(task)
    model = env.model
    model.contact_model = "penalty"
    base = host_library(task, str(tmp_path_factory.getbasetemp()), PENALTY)
    other = host_library(task, str(tmp_path_factory.getbasetemp()), PENALTY + extra)
    q, qd, ctrl = pushed(model, task, 8, 3)
    a, b = host_step(base, model, q, qd, ctrl, env.frame_skip), host_step(other, model, q, qd, ctrl, env.frame_skip)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_penalty_library_and_constants_follow_the_contact_model():
    """The contact model set after construction, as the JAX package allows it, selects the library
    (a define of its build target) and the packed constants' cache entry; kp and kd are packed."""
    model = torch_make("HalfCheetah").model
    constraint = pf.build_target(model)
    assert not pf.uses_penalty(model) and ("TT_PENALTY", 1) not in constraint[1]
    model.contact_model = "penalty"
    assert pf.uses_penalty(model)
    penalty = pf.build_target(model)
    assert penalty[1] == constraint[1] + (("TT_PENALTY", 1),)
    assert _build._resolve(penalty)[1].name.endswith("_tt_penalty1.so")
    assert penalty in pf.task_targets() and constraint in pf.task_targets()
    P, _ = pf.pack_model(model)
    np.testing.assert_array_equal(P[-2:], np.float32([model.contact_stiffness, model.contact_damping]))
    assert model.contact_stiffness > 0 and model.contact_damping > 0
    swimmer = torch_make("Swimmer").model  # limits, no contacts: still a penalty build
    swimmer.contact_model = "penalty"
    assert pf.uses_penalty(swimmer) and pf.build_target(swimmer)[1][-1] == ("TT_PENALTY", 1)
    model.contact_model = "constraint"
    assert pf.build_target(model) == constraint


def test_packed_constants_cache_keys_on_the_contact_model_and_gains():
    """The device copy of the packed constants is made once per contact model and penalty gains (on a
    CPU device here): switching the model, or its gains, after construction never reuses a stale copy."""
    model = torch_make("Hopper").model
    cpu = torch.device("cpu")
    first = pf._device_consts(model, cpu)
    assert pf._device_consts(model, cpu) is first
    model.contact_model = "penalty"
    second = pf._device_consts(model, cpu)
    assert second is not first and torch.equal(second[0], first[0])
    model.contact_stiffness *= 2
    third = pf._device_consts(model, cpu)
    assert third is not second and float(third[0][-2]) == np.float32(model.contact_stiffness)
    model.contact_model = "constraint"
