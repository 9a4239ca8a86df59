"""The port's fused_step wrapper against the JAX package's fused_step, run as
the JAX package's own test runs it on the CPU (Pallas interpret mode). On CPU
tensors the port's wrapper runs its plain version; the CUDA kernel's per-env
code is also compiled as host C++ here (where a C++ compiler exists) and held
against the plain version."""

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tianshou_tpu.env.mujoco import make as jax_make
from tianshou_tpu.ops.pallas.physics_fused import fused_step as jax_fused_step
from tianshou_tpu_torch.env.core import VectorDeviceEnv
from tianshou_tpu_torch.env.mujoco import make as torch_make
from tianshou_tpu_torch.env.physics.dynamics import resolve_substeps
from tianshou_tpu_torch.env.physics.model import FREE
from tianshou_tpu_torch.ops.kernels import _build
from tianshou_tpu_torch.ops.kernels import physics_fused as pf
from tests._torch_threads import one_intra_op_thread  # noqa: F401  (autouse)

Q_TOL = dict(rtol=2e-4, atol=2e-4)
QD_TOL = dict(rtol=5e-3, atol=5e-3)


def near_home(model, E, seed):
    """States as tests/test_physics_fused.py makes them."""
    rng = np.random.default_rng(seed)
    q = (np.asarray(model.qpos0)[None] + 0.03 * rng.standard_normal((E, model.nq))).astype(np.float32)
    qd = (0.05 * rng.standard_normal((E, model.nq))).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (E, len(model.actuators))).astype(np.float32)
    return q, qd, ctrl


@pytest.mark.parametrize("task,E,block_e,one_substep", [("HalfCheetah", 6, 8, False), ("Hopper", 6, 8, False),
                                                       ("Ant", 4, 4, True)])
def test_fused_step_matches_jax_interpret(task, E, block_e, one_substep):
    jenv, tenv = jax_make(task), torch_make(task)
    q, qd, ctrl = near_home(jenv.model, E, 0 if task != "Ant" else 1)
    kw = dict(frame_skip=1, substeps=1) if one_substep else dict(frame_skip=int(jenv.frame_skip))
    q_ref, qd_ref = jax_fused_step(jenv.model, jnp.asarray(q).T, jnp.asarray(qd).T, jnp.asarray(ctrl).T,
                                   block_e=block_e, interpret=True, **kw)
    before = pf.launch_count()
    q_new, qd_new = pf.fused_step(tenv.model, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(ctrl), **kw)
    assert pf.launch_count() == before  # a CPU tensor launches nothing
    np.testing.assert_allclose(q_new.numpy(), np.asarray(q_ref).T, **Q_TOL)
    np.testing.assert_allclose(qd_new.numpy(), np.asarray(qd_ref).T, **QD_TOL)


@pytest.mark.parametrize("E", [1, 7])
def test_fused_step_any_batch_size_equals_reference(E):
    env = torch_make("Walker2d")
    q, qd, ctrl = (torch.from_numpy(a) for a in near_home(env.model, E, 2))
    got = pf.fused_step(env.model, q, qd, ctrl, frame_skip=env.frame_skip)
    want = pf.fused_step_reference(env.model, q, qd, ctrl, frame_skip=env.frame_skip)
    assert got[0].shape == (E, env.model.nq)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_physics_mode_fused_raises_on_cpu_tensors_and_plain_runs():
    g = torch.Generator().manual_seed(0)
    fused = VectorDeviceEnv(torch_make("Hopper", physics_mode="fused"), 3, device="cpu")
    state, _ = fused.reset(g)
    act = fused.action_space.sample(3, g, torch.device("cpu"))
    with pytest.raises(ValueError, match="fused"):
        fused.step(state, act, g)
    outs = [VectorDeviceEnv(torch_make("Hopper", physics_mode=m), 3, device="cpu").step(state, act, g) for m in ("auto", "plain")]
    assert torch.equal(outs[0].state.q, outs[1].state.q) and torch.equal(outs[0].obs, outs[1].obs)
    with pytest.raises(ValueError, match="physics_mode"):
        torch_make("Hopper", physics_mode="xla")


def test_wrapper_checks_its_arguments():
    model = torch_make("Hopper").model
    q, qd, ctrl = (torch.from_numpy(a) for a in near_home(model, 2, 0))
    with pytest.raises(ValueError, match="takes q, qd"):
        pf.fused_step(model, q[:, :-1], qd, ctrl)
    with pytest.raises(ValueError, match="takes q, qd"):
        pf.fused_step(model, q, qd, ctrl[:1])
    with pytest.raises(TypeError, match="float32"):
        pf.fused_step(model, q.double(), qd, ctrl)
    model.enable_pair_contacts, model.pair_body1 = True, np.zeros(2, np.int32)
    with pytest.raises(NotImplementedError, match="pair"):
        pf.fused_step(model, q, qd, ctrl)


@pytest.mark.parametrize("task", sorted(pf.TASK_ASSETS))
def test_packed_constants_match_the_kernels_layout(task):
    """The float and int arrays have the lengths the CUDA source derives from the sizes."""
    model = torch_make(task).model
    nq, nb, nj, nc, nl, nu = pf.signature(model)
    P, I = pf.pack_model(model)
    assert P.dtype == np.float32 and I.dtype == np.int32
    assert P.size == 32 * nb + 7 * nj + 4 * nq + 3 + 13 * nc + 9 * nl + 3 * nu + 2 + 2
    assert I.size == 2 * nb + 1 + 2 * nj + nc + nl + nu
    first = I[nb:2 * nb + 1]
    assert first[0] == 0 and first[-1] == nj and (np.diff(first) >= 0).all()
    np.testing.assert_array_equal(P[-4:-2], np.float32([model.fluid_viscosity, model.fluid_density]))
    # the penalty model's contact stiffness and damping (P_CON_KP), packed for either contact model
    np.testing.assert_array_equal(P[-2:], np.float32([model.contact_stiffness, model.contact_damping]))
    name, defines = pf.build_target(model)
    assert name == "physics_fused" and dict(defines) == dict(NQ=nq, NB=nb, NJ=nj, NC=nc, NL=nl, NU=nu)
    assert _build._resolve((name, defines))[1].name == f"libphysics_fused_nq{nq}_nb{nb}_nj{nj}_nc{nc}_nl{nl}_nu{nu}.so"


def test_default_build_targets_cover_every_task_and_kernel():
    targets = _build.default_targets()
    assert "gather" in targets and "sumtree" in targets and "physics_fused" not in targets
    sized = [t for t in targets if not isinstance(t, str)]
    constraint = {pf.build_target(torch_make(t).model) for t in pf.TASK_ASSETS}
    # each signature's library for the constraint model and for the penalty model
    assert len(sized) == 12 and constraint <= set(sized)
    assert {(name, defines + (("TT_PENALTY", 1),)) for name, defines in constraint} == set(sized) - constraint


@functools.cache
def host_library(task, out_dir, extra=()):
    """csrc/physics_fused.cu compiled as host C++ for the task's sizes; ``extra`` are further
    ``-D`` flags (``TEAM=4``, ``YCAP=2``, ``TT_REVERSE_LANES``)."""
    model = torch_make(task).model
    src = Path(pf.__file__).parent / "csrc" / "physics_fused.cu"
    lib = Path(out_dir) / ("_".join(["host", task, *extra]).replace("=", "") + ".so")
    flags = [f"-D{k}={v}" for k, v in zip(("NQ", "NB", "NJ", "NC", "NL", "NU"), pf.signature(model))]
    flags += [f"-D{x}" for x in extra]
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-x", "c++", *flags, "-o", str(lib), str(src)],
                   check=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).tt_physics_fused_host
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int, f32p, f32p, f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def host_step(fn, model, q, qd, ctrl, frame_skip):
    P, I = pf.pack_model(model)
    sub = resolve_substeps(model, None)
    q_out, qd_out = np.empty_like(q), np.empty_like(qd)
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    arrays = [np.ascontiguousarray(a) for a in (q, qd, ctrl)]
    rc = fn(P.ctypes.data_as(f32p), P.size, I.ctypes.data_as(i32p), I.size,
            *(a.ctypes.data_as(f32p) for a in (*arrays, q_out, qd_out)), q.shape[0], frame_skip * sub,
            float(model.timestep / sub), int(model.contact_iterations), int(any(j.jtype == FREE for j in model.joints)))
    assert rc == 0
    return q_out, qd_out


@pytest.mark.parametrize("task", sorted(pf.TASK_ASSETS))
def test_kernel_source_as_host_code_matches_plain_version(task, tmp_path_factory):
    """The kernel's per-env code, compiled for the CPU, against dynamics.step: near home and
    after a random-action rollout (contacts and limits active), every env within tolerance."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    env = torch_make(task)
    model, fs = env.model, env.frame_skip if task != "Ant" else 1
    fn = host_library(task, str(tmp_path_factory.getbasetemp()))
    E = 16
    q, qd, ctrl = near_home(model, E, 3)
    rng = np.random.default_rng(4)
    for stage in range(2):
        q_new, qd_new = host_step(fn, model, q, qd, ctrl, fs)
        want = pf.fused_step_reference(model, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(ctrl), frame_skip=fs)
        assert np.isfinite(q_new).all() and np.isfinite(qd_new).all()
        np.testing.assert_allclose(q_new, want[0].numpy(), **Q_TOL)
        np.testing.assert_allclose(qd_new, want[1].numpy(), **QD_TOL)
        for _ in range(12):  # roll on with random actions
            ctrl = rng.uniform(-1, 1, ctrl.shape).astype(np.float32)
            q, qd = host_step(fn, model, q, qd, ctrl, fs)


def test_kernel_source_as_host_code_recharts_a_free_joint(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    model = torch_make("Ant").model
    fn = host_library("Ant", str(tmp_path_factory.getbasetemp()))
    q, qd, ctrl = near_home(model, 8, 5)
    axis = np.random.default_rng(6).standard_normal((8, 3))
    q[:, 3:6] = (axis / np.linalg.norm(axis, axis=1, keepdims=True) * np.linspace(3.0, 3.6, 8)[:, None]).astype(np.float32)
    q[:, 2] += 0.5
    q_new, qd_new = host_step(fn, model, q, qd, ctrl, 1)
    want = pf.fused_step_reference(model, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(ctrl), frame_skip=1)
    assert (np.linalg.norm(q_new[:, 3:6], axis=1) <= np.pi + 1e-3).all()
    np.testing.assert_allclose(q_new, want[0].numpy(), **Q_TOL)
    np.testing.assert_allclose(qd_new, want[1].numpy(), **QD_TOL)


def rollout_states(fn, model, fs, E, seed, steps=12):
    """Near-home states rolled on with random actions by the host build ``fn``: contacts and limits are active."""
    q, qd, ctrl = near_home(model, E, seed)
    rng = np.random.default_rng(seed + 100)
    for _ in range(steps):
        ctrl = rng.uniform(-1, 1, ctrl.shape).astype(np.float32)
        q, qd = host_step(fn, model, q, qd, ctrl, fs)
    return q, qd, ctrl


@pytest.mark.parametrize("task,extra", [
    ("HalfCheetah", ("TEAM=1",)), ("HalfCheetah", ("TEAM=4",)), ("HalfCheetah", ("TEAM=32",)),
    ("HalfCheetah", ("TT_REVERSE_LANES",)), ("Ant", ("TEAM=8",)), ("Ant", ("TT_REVERSE_LANES",)),
    ("Swimmer", ("TEAM=2",)), ("Hopper", ("TEAM=16", "TT_REVERSE_LANES")),
])
def test_host_builds_agree_across_team_sizes_and_lane_orders(task, extra, tmp_path_factory):
    """Each element of each sum belongs to one lane and has a fixed order, so a build with another
    TEAM, or one that runs the lanes of every phase in the opposite order (which would expose a
    phase reading what another lane writes in it), gives the default build's bits; both stay
    within the tolerance of the plain version."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    env = torch_make(task)
    model, fs = env.model, env.frame_skip if task != "Ant" else 1
    base = host_library(task, str(tmp_path_factory.getbasetemp()))
    other = host_library(task, str(tmp_path_factory.getbasetemp()), extra)
    q, qd, ctrl = rollout_states(base, model, fs, 8, 7)
    a, b = host_step(base, model, q, qd, ctrl, fs), host_step(other, model, q, qd, ctrl, fs)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    want = pf.fused_step_reference(model, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(ctrl), frame_skip=fs)
    np.testing.assert_allclose(b[0], want[0].numpy(), **Q_TOL)
    np.testing.assert_allclose(b[1], want[1].numpy(), **QD_TOL)


@pytest.mark.parametrize("task,cap", [("HalfCheetah", 4), ("HalfCheetah", 8), ("Walker2d", 4), ("Ant", 4), ("Hopper", 4)])
def test_host_build_with_more_active_rows_than_the_cap_is_right(task, cap, tmp_path_factory):
    """(The cap is a multiple of four, so that a contact's four rows stay together.)
    With YCAP below the number of active rows the rows beyond it live in the scratch array
    outside the env's fixed scratch; no row is dropped: the result has the uncapped build's bits."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    from tianshou_tpu_torch.env.physics.dynamics import active_rows

    env = torch_make(task)
    model, fs = env.model, env.frame_skip if task != "Ant" else 1
    nr = 4 * len(model.contact_radius) + len(model.limit_q_idx)
    base = host_library(task, str(tmp_path_factory.getbasetemp()), (f"YCAP={nr}",))
    capped = host_library(task, str(tmp_path_factory.getbasetemp()), (f"YCAP={cap}",))
    q, qd, ctrl = rollout_states(base, model, fs, 12, 9, steps=20)
    if task == "Ant":
        q[:, 2] = 0.3  # press the feet into the floor
    if task == "HalfCheetah" and cap == 8:
        q[:, 1] -= 0.25  # and the cheetah's body: more than two contacts
    contacts, limits = active_rows(model, torch.from_numpy(q))
    assert int((4 * contacts + limits).max()) > cap  # the state does overflow the cap
    a, b = host_step(base, model, q, qd, ctrl, fs), host_step(capped, model, q, qd, ctrl, fs)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    want = pf.fused_step_reference(model, torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(ctrl), frame_skip=fs)
    np.testing.assert_allclose(b[0], want[0].numpy(), **Q_TOL)
    np.testing.assert_allclose(b[1], want[1].numpy(), **QD_TOL)


@pytest.mark.parametrize("E", [1, 33])
def test_host_build_any_env_count(E, tmp_path_factory):
    """Env counts that leave a team alone or a warp and a block ragged on the card: on the host the
    same per-env code runs for each env, with nothing shared between envs."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    env = torch_make("Hopper")
    fn = host_library("Hopper", str(tmp_path_factory.getbasetemp()))
    q, qd, ctrl = near_home(env.model, E, 11)
    got = host_step(fn, env.model, q, qd, ctrl, env.frame_skip)
    one_by_one = [host_step(fn, env.model, q[e:e + 1], qd[e:e + 1], ctrl[e:e + 1], env.frame_skip) for e in range(E)]
    np.testing.assert_array_equal(got[0], np.concatenate([o[0] for o in one_by_one]))
    np.testing.assert_array_equal(got[1], np.concatenate([o[1] for o in one_by_one]))
    want = pf.fused_step_reference(env.model, *(torch.from_numpy(a) for a in (q, qd, ctrl)), frame_skip=env.frame_skip)
    np.testing.assert_allclose(got[0], want[0].numpy(), **Q_TOL)
    np.testing.assert_allclose(got[1], want[1].numpy(), **QD_TOL)


def test_host_build_with_more_solver_iterations_than_the_momentum_table(tmp_path_factory):
    """The momentum weights of the first 32 iterations are tabulated once; beyond, they are computed."""
    if shutil.which("g++") is None:
        pytest.skip("needs a C++ compiler to build the kernel source for the host")
    env = torch_make("Hopper")
    model, fs = env.model, env.frame_skip
    fn = host_library("Hopper", str(tmp_path_factory.getbasetemp()))
    q, qd, ctrl = rollout_states(fn, model, fs, 8, 13)
    model.contact_iterations = 40
    got = host_step(fn, model, q, qd, ctrl, fs)
    want = pf.fused_step_reference(model, *(torch.from_numpy(a) for a in (q, qd, ctrl)), frame_skip=fs)
    np.testing.assert_allclose(got[0], want[0].numpy(), **Q_TOL)
    np.testing.assert_allclose(got[1], want[1].numpy(), **QD_TOL)


def test_build_target_names_the_team_size():
    model = torch_make("Ant").model
    name, defines = pf.build_target(model, team=8)
    assert name == "physics_fused" and defines[-1] == ("TEAM", 8) and defines[:-1] == pf.build_target(model)[1]
    assert _build._resolve((name, defines))[1].name.endswith("_nu8_team8.so")
    for bad in (0, 3, 64):
        with pytest.raises(ValueError, match="power of two"):
            pf.build_target(model, team=bad)
    assert pf.build_target(model, profile=True)[1][-1] == ("TT_PROFILE", 1)
    assert len(pf.PHASES) == 11  # TT_N_PHASES of the source
    with pytest.raises(RuntimeError, match="_PROFILE"):
        pf.phase_cycles(model)
