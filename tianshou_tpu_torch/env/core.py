"""Batched device environments (port of ``tianshou_tpu/env/core.py``).

The JAX package writes a single-env ``step`` and ``vmap``s it. Here an
:class:`Env` steps a whole batch of ``E`` environments with the env axis
written out: ``reset(num_envs, generator, device)`` and
``step(state, action, generator)`` take and return tensors with a leading
``E`` axis. Randomness comes from an explicit ``torch.Generator`` on the
envs' device. Auto-reset is the collector's job, so that the true terminal
``obs_next`` stays visible (reference collector.py:857-1067).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["Box", "Discrete", "MultiDiscrete", "Space", "EnvStep", "Env", "VectorDeviceEnv"]


# ---------------------------------------------------------------------------
# Space descriptors (reference utils/space_info.py reads the same fields)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Space:
    shape: tuple[int, ...]
    dtype: Any

    def sample(self, num: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
        """``num`` independent samples, stacked on a leading axis."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    n: int = 2

    def __init__(self, n: int) -> None:
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "shape", ())
        object.__setattr__(self, "dtype", torch.int64)

    def sample(self, num: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
        return torch.randint(0, self.n, (num,), generator=generator, device=device)


@dataclasses.dataclass(frozen=True)
class Box(Space):
    low: tuple = ()
    high: tuple = ()

    def __init__(self, low, high, shape: tuple[int, ...] | None = None, dtype=torch.float32) -> None:
        low_arr = np.broadcast_to(np.asarray(low, np.float32), shape) if shape else np.asarray(low, np.float32)
        high_arr = np.broadcast_to(np.asarray(high, np.float32), shape) if shape else np.asarray(high, np.float32)
        object.__setattr__(self, "low", tuple(low_arr.ravel().tolist()))
        object.__setattr__(self, "high", tuple(high_arr.ravel().tolist()))
        object.__setattr__(self, "shape", tuple(low_arr.shape))
        object.__setattr__(self, "dtype", dtype)
        object.__setattr__(self, "_on_device", {})  # device -> (low, high) tensors, copied once

    @property
    def low_arr(self) -> np.ndarray:
        return np.asarray(self.low, np.float32).reshape(self.shape)

    @property
    def high_arr(self) -> np.ndarray:
        return np.asarray(self.high, np.float32).reshape(self.shape)

    @property
    def _bounded(self) -> bool:
        return all(math.isfinite(b) for b in (*self.low, *self.high))

    def bounds(self, device: str | torch.device) -> tuple[torch.Tensor, torch.Tensor]:
        """``(low, high)`` as tensors of the box's shape on ``device``."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = tuple(
                torch.tensor(b, dtype=self.dtype, device=device).reshape(self.shape) for b in (self.low, self.high))
        return self._on_device[device]

    def sample(self, num: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
        """``num`` samples, ``[num, *shape]``, as :meth:`sample_from` makes them from one ``torch.rand``
        and, where a bound is not finite, one ``torch.randn``; no host sync."""
        shape = (num, *self.shape)
        u = torch.rand(shape, dtype=self.dtype, device=device, generator=generator)
        g = None if self._bounded else torch.randn(shape, dtype=self.dtype, device=device, generator=generator)
        return self.sample_from(u, g)

    def sample_from(self, u: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """The samples of uniforms ``u`` in [0, 1) and standard normals ``g`` (needed only where a
        bound is not finite), as the JAX package makes them: ``low + u (high - low)`` in the
        dimensions with both bounds finite, ``g`` in the others."""
        low, high = self.bounds(u.device)
        box = low + (high - low) * u
        if self._bounded:
            return box
        return torch.where(torch.isfinite(low) & torch.isfinite(high), box, g)


@dataclasses.dataclass(frozen=True)
class MultiDiscrete(Space):
    """``k`` discrete sub-actions, the i-th in ``[0, nvec[i])``."""

    nvec: tuple = ()

    def __init__(self, nvec) -> None:
        nv = tuple(int(x) for x in np.asarray(nvec).ravel())
        object.__setattr__(self, "nvec", nv)
        object.__setattr__(self, "shape", (len(nv),))
        object.__setattr__(self, "dtype", torch.int64)
        object.__setattr__(self, "_on_device", {})  # device -> float32 nvec, copied once

    def sample(self, num: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
        """``[num, k]`` int64 samples: ``floor(u * nvec)`` of float32 uniforms, as the JAX package draws them."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = torch.tensor(self.nvec, dtype=torch.float32, device=device)
        u = torch.rand((num, *self.shape), generator=generator, device=device)
        return (u * self._on_device[device]).to(torch.int64)


# ---------------------------------------------------------------------------
# Env protocol
# ---------------------------------------------------------------------------


class EnvStep(NamedTuple):
    """Result of one batched env step: the gymnasium 5-tuple plus carried state."""

    state: Any
    obs: Any
    reward: torch.Tensor      # [E] float32
    terminated: torch.Tensor  # [E] bool
    truncated: torch.Tensor   # [E] bool
    info: Any                 # Batch of [E, ...] tensors


class Env:
    """Base class for batched device environments.

    Subclasses implement ``reset`` and ``step`` over a batch of envs;
    instances hold only static config.
    """

    observation_space: Space
    action_space: Space
    max_episode_steps: int | None = None

    def reset(self, num_envs: int, generator: torch.Generator, device: torch.device) -> tuple[Any, Any]:
        raise NotImplementedError

    def step(self, state: Any, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        raise NotImplementedError

    def carry_through_reset(self, old_state: Any, reset_state: Any) -> Any:
        """Merge persistent sub-state into a fresh reset state when the
        collector auto-resets a finished episode."""
        return reset_state

    def empty_info(self) -> Any:
        """The per-env info schema (fixed shapes); empty unless an env says otherwise."""
        from tianshou_tpu_torch.data.batch import Batch

        return Batch()

    @property
    def name(self) -> str:
        return type(self).__name__


class VectorDeviceEnv:
    """``num_envs`` identical envs on one device (the analogue of the
    reference's ``DummyVectorEnv``, env/venvs.py:389-424)."""

    def __init__(self, env: Env, num_envs: int, device: str | torch.device | None = None) -> None:
        self.env = env
        self.num_envs = num_envs
        self.device = resolve_device(device)

    @property
    def observation_space(self) -> Space:
        return self.env.observation_space

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    def reset(self, generator: torch.Generator) -> tuple[Any, Any]:
        return self.env.reset(self.num_envs, generator, self.device)

    def step(self, states: Any, actions: torch.Tensor, generator: torch.Generator) -> EnvStep:
        return self.env.step(states, actions, generator)

    def carry_through_reset(self, old_state: Any, reset_state: Any) -> Any:
        return self.env.carry_through_reset(old_state, reset_state)

    def __len__(self) -> int:
        return self.num_envs
