"""Probability distributions (port of ``tianshou_tpu/models/distributions.py``:
``Categorical``, ``MaskedCategorical``, ``Normal`` and ``TanhNormal``).

The JAX package keeps a distribution as a pytree of its parameters; here it
is a small class over tensors. Sampling takes an explicit
``torch.Generator`` and draws on the parameters' device:

- ``Categorical.sample`` is Gumbel-max over uniforms, as
  ``jax.random.categorical`` draws it, so that a CUDA graph can capture it
  (``torch.multinomial`` synchronizes with the host);
- ``Normal.sample`` is ``loc + scale * eps`` with standard normal ``eps``;
- ``TanhNormal.sample_and_log_prob`` squashes such a sample with ``tanh``
  and corrects the log-density by ``2 * (log 2 - u - softplus(-2u))``
  (reference sac.py:25-39), the JAX formula term for term.

``from_noise`` takes the uniforms or normals themselves, so that tests can
hand over the numbers the JAX key draws. ``log_prob`` and ``entropy`` of
``Normal`` sum over the trailing event axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["Categorical", "MaskedCategorical", "Normal", "TanhNormal"]

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)
_LOG_2 = math.log(2.0)


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


def MaskedCategorical(logits: torch.Tensor, mask: torch.Tensor) -> Categorical:
    """A :class:`Categorical` with the actions where ``mask`` is False filled
    with the dtype's most negative finite value (not ``-inf``, so that the
    log-probabilities stay finite), reference dqn.py:145."""
    return Categorical(logits=torch.where(mask, logits, torch.finfo(logits.dtype).min))


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


class TanhNormal:
    """``tanh`` of a diagonal Gaussian, with the change-of-variables
    log-prob: ``log N(u) - sum log(1 - tanh(u)^2)``, the correction written
    stably as ``2 * (log 2 - u - softplus(-2u))``."""

    def __init__(self, loc: torch.Tensor, scale: torch.Tensor) -> None:
        self.loc = loc
        self.scale = scale

    def _log_prob_pre_tanh(self, u: torch.Tensor) -> torch.Tensor:
        z = (u - self.loc) / self.scale
        log_base = (-0.5 * z**2 - torch.log(self.scale) - _HALF_LOG_2PI).sum(-1)
        correction = (2.0 * (_LOG_2 - u - F.softplus(-2.0 * u))).sum(-1)
        return log_base - correction

    def from_noise(self, eps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(tanh(u), log_prob)`` for ``u = loc + scale * eps``; ``z`` is
        recomputed from ``u``, as the JAX package does."""
        u = self.loc + self.scale * eps
        return torch.tanh(u), self._log_prob_pre_tanh(u)

    def sample_and_log_prob(self, generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
        eps = torch.randn(self.loc.shape, generator=generator, device=self.loc.device, dtype=self.loc.dtype)
        return self.from_noise(eps)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        return self.sample_and_log_prob(generator)[0]

    def log_prob(self, action: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        """Of an action in (-1, 1), clipped to ``±(1 - eps)`` before ``atanh``."""
        return self._log_prob_pre_tanh(torch.atanh(action.clamp(-1 + eps, 1 - eps)))

    def mode(self) -> torch.Tensor:
        return torch.tanh(self.loc)
