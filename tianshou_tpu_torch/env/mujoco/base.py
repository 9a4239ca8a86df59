"""Base class for device MuJoCo-class locomotion envs (port of
``tianshou_tpu/env/mujoco/base.py``).

Task structure (observations, rewards, termination, reset noise, horizons)
mirrors the Gymnasium MuJoCo v4 envs; dynamics run on the
:mod:`tianshou_tpu_torch.env.physics` core with models loaded from the
packaged asset XMLs. The env is batched: ``step`` is the counterpart of the
JAX package's ``batch_step``, and the task hooks take ``[E, ...]`` tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Env, EnvStep
from tianshou_tpu_torch.env.physics import dynamics as dyn
from tianshou_tpu_torch.env.physics import load_mjcf
from tianshou_tpu_torch.ops.kernels.physics_fused import fused_step, fused_step_reference

__all__ = ["PhysState", "MujocoEnv"]

PHYSICS_MODES = ("auto", "fused", "plain")


class PhysState(NamedTuple):
    q: torch.Tensor   # [E, nq] float32
    qd: torch.Tensor  # [E, nq] float32
    t: torch.Tensor   # [E] int32


class MujocoEnv(Env):
    xml: str = ""
    frame_skip: int = 5
    max_episode_steps = 1000
    # integrator substeps per model timestep; None = dynamics.resolve_substeps
    substeps: int | None = None
    # APGD contact-solver iterations; None = model default (12). Ant sets 30:
    # its many-row contact QP needs them.
    contact_iterations: int | None = None
    # gym reset_noise_scale
    reset_noise_scale: float = 0.1
    reset_noise_kind: str = "uniform"  # qpos noise; qvel noise is scaled normal
    # geom-pair (self-collision) contact rows in the constraint QP; off unless a
    # task turns them on (Humanoid). The plane-contact tasks ship no candidate
    # pairs anyway: their contype/conaffinity masks disable self-collision.
    enable_pair_contacts: bool = False
    # "auto": the fused kernel on CUDA tensors, the plain version on CPU
    # tensors; "fused": always the kernel (raises on CPU tensors); "plain":
    # always the plain version, for comparisons and timing
    physics_mode: str = "auto"

    def __init__(self, max_episode_steps: int | None = None, physics_mode: str | None = None) -> None:
        if max_episode_steps is not None:
            self.max_episode_steps = max_episode_steps
        if physics_mode is not None:
            self.physics_mode = physics_mode
        if self.physics_mode not in PHYSICS_MODES:
            raise ValueError(f"physics_mode must be one of {PHYSICS_MODES}, got {self.physics_mode!r}")
        self.model = load_mjcf(self.xml)
        self._qpos0: dict[torch.device, torch.Tensor] = {}
        if self.contact_iterations is not None:
            self.model.contact_iterations = int(self.contact_iterations)
        if self.enable_pair_contacts:
            self.model.enable_pair_contacts = True
        self.physics_route  # raises for physics_mode="fused" on a model the kernel does not step
        # gym MujocoEnv action space == actuator ctrlrange
        self.action_space = Box(
            low=[a.ctrlrange[0] for a in self.model.actuators],
            high=[a.ctrlrange[1] for a in self.model.actuators],
        )
        obs_dim = int(self._obs(*dyn.init_state(self.model, 1, device="cpu")).shape[1])
        self.observation_space = Box(low=[-np.inf] * obs_dim, high=[np.inf] * obs_dim)

    # -- task hooks, over [E, ...] tensors ---------------------------------
    def _obs(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _reward(self, q0, qd0, q1, qd1, action) -> torch.Tensor:
        raise NotImplementedError

    def _terminated(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        return torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)

    def qpos0(self, device: str | torch.device) -> torch.Tensor:
        """The model's home ``qpos0`` as float32 ``[nq]`` on ``device``, copied
        once and kept (as ``Box.bounds`` keeps its bounds): the collector resets
        on every step, and a host-to-device copy there could not be captured in
        a CUDA graph."""
        device = torch.device(device)
        if device not in self._qpos0:
            self._qpos0[device] = torch.as_tensor(self.model.qpos0, dtype=torch.float32, device=device)
        return self._qpos0[device]

    @property
    def dt(self) -> float:
        return self.model.timestep * self.frame_skip

    # -- Env protocol ---------------------------------------------------
    def reset_noise(self, num_envs: int, generator: torch.Generator, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The additive reset noise ``(dq, dqd)``, each ``[E, nq]``."""
        s, shape = self.reset_noise_scale, (num_envs, self.model.nq)
        dq = (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) * s
        if self.reset_noise_kind == "uniform":
            dqd = s * torch.randn(shape, generator=generator, device=device)
        else:  # both uniform (hopper/walker style)
            dqd = (torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0) * s
        return dq, dqd

    def reset_from_noise(self, dq: torch.Tensor, dqd: torch.Tensor) -> tuple[PhysState, torch.Tensor]:
        """Reset with the noise handed over (as :meth:`reset_noise` draws it)."""
        q0 = self.qpos0(dq.device)
        q, qd = (q0 + dq).to(torch.float32), dqd.to(torch.float32)
        st = PhysState(q, qd, torch.zeros(q.shape[0], dtype=torch.int32, device=q.device))
        return st, self._obs(q, qd)

    def reset(self, num_envs: int, generator: torch.Generator, device: torch.device):
        return self.reset_from_noise(*self.reset_noise(num_envs, generator, device))

    @property
    def physics_route(self) -> str:
        """How :meth:`step` runs the dynamics: ``"kernel"`` (``fused_step``: the hand-written kernel
        on CUDA tensors, its plain version on CPU tensors) or ``"plain"`` (``dynamics.step`` on any
        device; on the card a program captures it in its CUDA graph). A model with geom-pair contact
        rows takes ``"plain"``: the kernel has no pair rows, as the TPU kernel has none, and the JAX
        package steps such a model through its vmapped ``dynamics.step``."""
        if dyn._pair_rows(self.model):
            if self.physics_mode == "fused":
                raise ValueError(f"physics_mode='fused': the fused kernel has no geom-pair rows, and "
                                 f"{type(self).__name__} enables them; use 'auto' or 'plain'")
            return "plain"
        return "plain" if self.physics_mode == "plain" else "kernel"

    def _physics(self, q: torch.Tensor, qd: torch.Tensor, a: torch.Tensor):
        if self.physics_route == "plain":
            return fused_step_reference(self.model, q, qd, a, frame_skip=self.frame_skip, substeps=self.substeps)
        if self.physics_mode == "fused" and q.device.type != "cuda":
            raise ValueError(f"physics_mode='fused' launches the CUDA kernel; the state is on {q.device}")
        return fused_step(self.model, q.contiguous(), qd.contiguous(), a.contiguous(),
                          frame_skip=self.frame_skip, substeps=self.substeps)

    def step(self, state: PhysState, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        """states ``[E, nq]``-leaves, actions ``[E, nu]`` -> batched EnvStep."""
        a = torch.clamp(action.to(torch.float32), *self.action_space.bounds(action.device))
        q1, qd1 = self._physics(state.q, state.qd, a)
        t = state.t + 1
        terminated = self._terminated(q1, qd1)
        return EnvStep(
            state=PhysState(q1, qd1, t),
            obs=self._obs(q1, qd1),
            reward=self._reward(state.q, state.qd, q1, qd1, a).to(torch.float32),
            terminated=terminated,
            truncated=(t >= self.max_episode_steps) & ~terminated,
            info=Batch(),
        )
