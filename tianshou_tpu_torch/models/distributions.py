"""Probability distributions (port of ``tianshou_tpu/models/distributions.py``;
only ``Categorical`` and ``Normal`` so far).

The JAX package keeps a distribution as a pytree of its parameters; here it
is a small class over tensors. Sampling takes an explicit
``torch.Generator`` and draws on the parameters' device:

- ``Categorical.sample`` is Gumbel-max over uniforms, as
  ``jax.random.categorical`` draws it, so that a CUDA graph can capture it
  (``torch.multinomial`` synchronizes with the host);
- ``Normal.sample`` is ``loc + scale * eps`` with standard normal ``eps``.

``from_noise`` takes the uniforms or normals themselves, so that tests can
hand over the numbers the JAX key draws. ``log_prob`` and ``entropy`` of
``Normal`` sum over the trailing event axis.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Categorical", "Normal"]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class Categorical:
    """Categorical over the last axis of ``logits``."""

    def __init__(self, logits: torch.Tensor) -> None:
        self.logits = logits

    def from_noise(self, uniform: torch.Tensor) -> torch.Tensor:
        """``argmax(logits + gumbel)`` with ``gumbel = -log(-log(u))``
        (``jax.random.gumbel`` of uniforms in ``[tiny, 1)``)."""
        return torch.argmax(self.logits - torch.log(-torch.log(uniform)), dim=-1)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        u = torch.rand(self.logits.shape, generator=generator, device=self.logits.device, dtype=self.logits.dtype)
        return self.from_noise(u.clamp_(min=torch.finfo(self.logits.dtype).tiny))

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return torch.gather(logp, -1, value.to(torch.int64)[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        return -(torch.exp(logp) * logp).sum(-1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1)

    @property
    def probs(self) -> torch.Tensor:
        return torch.softmax(self.logits, dim=-1)

    def kl_divergence(self, other: Categorical) -> torch.Tensor:
        logp = torch.log_softmax(self.logits, dim=-1)
        logq = torch.log_softmax(other.logits, dim=-1)
        return (torch.exp(logp) * (logp - logq)).sum(-1)


class Normal:
    """Diagonal Gaussian."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        self.loc = loc
        self.scale = scale

    def from_noise(self, eps: torch.Tensor) -> torch.Tensor:
        return self.loc + self.scale * eps

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        eps = torch.randn(self.loc.shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        return self.from_noise(eps)

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        z = (value - self.loc) / self.scale
        return (-0.5 * z**2 - torch.log(self.scale) - _HALF_LOG_2PI).sum(-1)

    def entropy(self) -> torch.Tensor:
        return (0.5 + _HALF_LOG_2PI + torch.log(self.scale)).sum(-1)

    def mode(self) -> torch.Tensor:
        return self.loc

    def kl_divergence(self, other: Normal) -> torch.Tensor:
        var_ratio = (self.scale / other.scale) ** 2
        t1 = ((self.loc - other.loc) / other.scale) ** 2
        return (0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))).sum(-1)
