"""Fused physics step: ``frame_skip * substeps`` semi-implicit Euler substeps
of articulated rigid-body dynamics with soft-constraint contacts and joint
limits, for a batch of envs, in one kernel launch.

Replaces the TPU kernel ``tianshou_tpu/ops/pallas/physics_fused.py:fused_step``
(a traced, autodiff-expanded program over ``[nq, block_e]`` lane slabs) with
the CUDA C++ kernel in ``csrc/physics_fused.cu``: one thread per env runs FK
over dual numbers and second-order jets, builds the mass matrix and bias
force from the body Jacobians, solves the contact QP over the active rows
only without forming its matrix, integrates, and re-charts free-joint
rotation vectors. State is env-first ``[E, nq]`` (the port's envs are
batch-first), actuation (clip, gear) is folded into the kernel, and envs
beyond ``E`` are masked in the kernel, not padded.

The model's sizes are compile-time constants of the kernel, so one library is
built per model signature ``(nq, nbody, njoint, ncontact, nlimit, nu)`` at
first use; the model's tables go in as two device arrays packed by
:func:`pack_model`. The work is float32 operations outside the tensor cores;
the bound by operations and the measured times are in ``PERF.md``.

Limits: geom-pair contacts (Humanoid) and the legacy
``contact_model="penalty"`` raise ``NotImplementedError``; the plain version
computes the penalty model.

:func:`fused_step` launches the kernel for CUDA tensors and takes the plain
version, :func:`fused_step_reference` (the port's ``dynamics.step``), only for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tianshou_tpu_torch.env.physics import dynamics
from tianshou_tpu_torch.env.physics.model import FREE, Model

__all__ = [
    "fused_step", "fused_step_reference", "launch_count", "reset_launch_count", "signature", "pack_model",
    "build_target", "task_targets", "TASK_ASSETS",
]

_launches = 0
_fns: dict = {}  # signature -> the loaded C entry point

# the packaged MuJoCo tasks the kernel is built for by default
TASK_ASSETS = {
    "HalfCheetah": "half_cheetah.xml", "Hopper": "hopper.xml", "Walker2d": "walker2d.xml",
    "Ant": "ant.xml", "Swimmer": "swimmer.xml", "Reacher": "reacher.xml",
}
_MACROS = ("NQ", "NB", "NJ", "NC", "NL", "NU")
# envs (threads) per block. Measured at E = 2048 (scripts/torch_port_profile.py, PERF.md): the time
# is flat from 32 down to 8 and rises below, so a full warp per block it is.
_BLOCK_THREADS = 32


def launch_count() -> int:
    """Number of kernel launches since the last :func:`reset_launch_count`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def fused_step_reference(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor,
                         frame_skip: int = 1, substeps: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: :func:`tianshou_tpu_torch.env.physics.dynamics.step`."""
    return dynamics.step(model, q, qd, ctrl, frame_skip=frame_skip, substeps=substeps)


def signature(model: Model) -> tuple[int, ...]:
    """``(nq, nbody, njoint, ncontact, nlimit, nu)``: the sizes a library is compiled for."""
    return (model.nq, model.nbody, len(model.joints), len(model.contact_radius), len(model.limit_q_idx),
            len(model.actuators))


def build_target(model: Model) -> tuple:
    """The :mod:`_build` target of the library that steps ``model``."""
    return ("physics_fused", tuple(zip(_MACROS, signature(model))))


def task_targets() -> list[tuple]:
    """One build target per distinct signature among the packaged tasks."""
    from tianshou_tpu_torch.env.physics.mjcf import load_mjcf

    return sorted({build_target(load_mjcf(xml)) for xml in TASK_ASSETS.values()})


def pack_model(model: Model) -> tuple[np.ndarray, np.ndarray]:
    """The model's constants as one float32 and one int32 array, in the
    layout ``csrc/physics_fused.cu`` declares (``P_*`` and ``I_*`` offsets).
    Tables are computed in float64 and cast once. Joints are sorted by body."""
    nb = model.nbody
    order = sorted(range(len(model.joints)), key=lambda i: model.joints[i].body)  # stable
    joints = [model.joints[i] for i in order]
    first = [0] * (nb + 1)
    for j in joints:
        first[j.body + 1] += 1
    first = np.cumsum(first)
    for b in range(nb):
        mine = joints[first[b]:first[b + 1]]
        if any(j.jtype == FREE for j in mine[1:]):
            raise NotImplementedError("a free joint must be the first joint of its body")
    per_dof = {name: np.zeros(model.nq) for name in ("armature", "damping", "stiffness", "springref")}
    for j in joints:
        if j.jtype != FREE:
            for name, arr in per_dof.items():
                arr[j.q_idx] = getattr(j, name)
    # equivalent inertia boxes of the legacy fluid model, as dynamics._consts has them
    m = np.maximum(model.body_mass, 1e-9)
    diag = np.einsum("bii->bi", model.body_inertia)
    box = np.sqrt(np.maximum(6.0 / m[:, None] * (diag.sum(1, keepdims=True) - 2 * diag), 1e-8))
    half = box / 2.0
    area = np.stack([4 * half[:, 1] * half[:, 2], 4 * half[:, 0] * half[:, 2], 4 * half[:, 0] * half[:, 1]], axis=1)
    it = np.stack([half[:, 1] ** 4 * half[:, 2] + half[:, 2] ** 4 * half[:, 1],
                   half[:, 0] ** 4 * half[:, 2] + half[:, 2] ** 4 * half[:, 0],
                   half[:, 0] ** 4 * half[:, 1] + half[:, 1] ** 4 * half[:, 0]], axis=1)
    floats = [
        model.body_pos, [dynamics.quat_np(model.body_quat[b]) for b in range(nb)], model.body_com, model.body_mass,
        model.body_inertia, box.mean(axis=1), area, it,
        [j.axis for j in joints], [j.pos for j in joints], [j.ref for j in joints],
        per_dof["armature"], per_dof["damping"], per_dof["stiffness"], per_dof["springref"], model.gravity,
        model.contact_offset - model.body_com[model.contact_body], model.contact_radius, model.contact_margin,
        model.contact_friction, model.contact_solref, model.contact_solimp,
        model.limit_range[:, 0], model.limit_range[:, 1], model.limit_solref, model.limit_solimp,
        [a.gear for a in model.actuators], [a.ctrlrange[0] for a in model.actuators],
        [a.ctrlrange[1] for a in model.actuators], [model.fluid_viscosity, model.fluid_density],
    ]
    ints = [
        model.parent, first, [j.jtype for j in joints], [j.q_idx for j in joints], model.contact_body,
        model.limit_q_idx, [a.q_idx for a in model.actuators],
    ]
    P = np.concatenate([np.asarray(x, np.float64).reshape(-1) for x in floats]).astype(np.float32)
    I = np.concatenate([np.asarray(x, np.int64).reshape(-1) for x in ints]).astype(np.int32)
    return P, I


def _check(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, frame_skip: int) -> None:
    if dynamics._pair_rows(model):
        raise NotImplementedError("geom-pair contacts are not ported yet; leave enable_pair_contacts off")
    nq, nu = model.nq, len(model.actuators)
    if q.dim() != 2 or q.shape[1] != nq or qd.shape != q.shape or ctrl.shape != (q.shape[0], nu):
        raise ValueError(f"fused_step takes q, qd [E, {nq}] and ctrl [E, {nu}], got {tuple(q.shape)}, "
                         f"{tuple(qd.shape)} and {tuple(ctrl.shape)}")
    if not (q.dtype == qd.dtype == ctrl.dtype == torch.float32):
        raise TypeError(f"fused_step takes float32 tensors, got {q.dtype}, {qd.dtype} and {ctrl.dtype}")
    if not (q.device == qd.device == ctrl.device):
        raise ValueError(f"q on {q.device}, qd on {qd.device}, ctrl on {ctrl.device}")
    if frame_skip < 0:
        raise ValueError(f"frame_skip must not be negative, got {frame_skip}")


def _kernel(model: Model):
    sig = signature(model)
    if sig not in _fns:
        from tianshou_tpu_torch.ops.kernels._build import load

        lib = load(build_target(model))
        built = (ctypes.c_int * 8)()
        lib.tt_physics_fused_signature.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.tt_physics_fused_signature.restype = None
        lib.tt_physics_fused_signature(built)
        if tuple(built[:6]) != sig:
            raise RuntimeError(f"library built for sizes {tuple(built[:6])}, model has {sig}")
        fn = lib.tt_physics_fused
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fns[sig] = fn
    return _fns[sig]


def _device_consts(model: Model, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The packed constants on ``device``, copied once and kept on the model."""
    cache = model.__dict__.setdefault("_fused_consts", {})
    if device not in cache:
        P, I = pack_model(model)
        cache[device] = (torch.from_numpy(P).to(device), torch.from_numpy(I).to(device))
    return cache[device]


def fused_step(model: Model, q: torch.Tensor, qd: torch.Tensor, ctrl: torch.Tensor, frame_skip: int = 1,
               substeps: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance ``frame_skip`` model timesteps for env-first float32 state
    ``q, qd [E, nq]`` and controls ``ctrl [E, nu]``; ``substeps`` resolves as
    :func:`tianshou_tpu_torch.env.physics.dynamics.resolve_substeps`.
    Returns new ``(q, qd)``; the inputs are not written.

    On CUDA tensors this launches the hand-written kernel on the current
    stream or raises; it never falls back to the plain version. On CPU
    tensors it runs :func:`fused_step_reference`.
    """
    global _launches
    _check(model, q, qd, ctrl, frame_skip)
    if q.device.type == "cpu":
        return fused_step_reference(model, q, qd, ctrl, frame_skip, substeps)
    if q.device.type != "cuda":
        raise ValueError(f"fused_step runs on cuda or cpu, got {q.device}")
    if getattr(model, "contact_model", "penalty") != "constraint" and (
            len(model.contact_radius) or len(model.limit_q_idx)):
        raise NotImplementedError("the fused kernel computes contact_model='constraint' only; "
                                  "the penalty model runs in fused_step_reference")
    if not (q.is_contiguous() and qd.is_contiguous() and ctrl.is_contiguous()):
        raise ValueError("fused_step needs contiguous q, qd and ctrl")
    substeps = dynamics.resolve_substeps(model, substeps)
    fn = _kernel(model)
    q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
    if q.shape[0] == 0:
        return q_out, qd_out
    P, I = _device_consts(model, q.device)
    has_free = int(any(j.jtype == FREE for j in model.joints))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(P.data_ptr(), P.numel(), I.data_ptr(), I.numel(), q.data_ptr(), qd.data_ptr(), ctrl.data_ptr(),
                 q_out.data_ptr(), qd_out.data_ptr(), q.shape[0], frame_skip * substeps,
                 float(model.timestep / substeps), int(getattr(model, "contact_iterations", 30)), has_free,
                 _BLOCK_THREADS, stream)
    if err != 0:
        raise RuntimeError(f"fused_step kernel launch failed: CUDA error {err}")
    _launches += 1
    return q_out, qd_out
