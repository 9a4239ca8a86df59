"""Exploration noise processes (port of ``tianshou_tpu/exploration/noise.py``;
reference tianshou/exploration/random.py): ``GaussianNoise`` (:20) and
``OUNoise`` (:35).

Both draw standard normals from an explicit ``torch.Generator`` on the
device of the action they perturb; ``from_noise`` takes the normals
themselves, so that tests can hand over what a JAX key draws. OU's state is
carried by the caller, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["GaussianNoise", "OUNoise"]


def _normal(shape: tuple[int, ...], generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class GaussianNoise:
    mu: float = 0.0
    sigma: float = 1.0

    def from_noise(self, eps: torch.Tensor) -> torch.Tensor:
        return self.mu + self.sigma * eps

    def sample(self, generator: torch.Generator, shape: tuple[int, ...],
               device: torch.device | str = "cpu") -> torch.Tensor:
        return self.from_noise(_normal(shape, generator, device))


@dataclasses.dataclass(frozen=True)
class OUNoise:
    """Ornstein-Uhlenbeck process; ``x`` is the carried state (``x0`` to start)."""

    mu: float = 0.0
    sigma: float = 0.3
    theta: float = 0.15
    dt: float = 1e-2
    x0: float = 0.0

    def init(self, shape: tuple[int, ...], device: torch.device | str = "cpu") -> torch.Tensor:
        return torch.full(shape, self.x0, dtype=torch.float32, device=device)

    def step_from_noise(self, x: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """One step driven by the standard normals ``eps``: ``dw = eps * sqrt(dt)``."""
        dw = eps * math.sqrt(self.dt)
        return x + self.theta * (self.mu - x) * self.dt + self.sigma * dw

    def step(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.step_from_noise(x, _normal(x.shape, generator, x.device))

    def from_noise(self, eps: torch.Tensor) -> torch.Tensor:
        return self.step_from_noise(torch.full_like(eps, self.x0), eps)

    def sample(self, generator: torch.Generator, shape: tuple[int, ...],
               device: torch.device | str = "cpu") -> torch.Tensor:
        """Stateless fallback: one OU step from ``x0``."""
        return self.from_noise(_normal(shape, generator, device))
