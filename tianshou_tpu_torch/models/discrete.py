"""Discrete-action nets (port of ``tianshou_tpu/models/discrete.py``; reference
utils/net/discrete.py): ``DiscreteActor`` and ``DiscreteCritic`` (the
on-policy pair, over :class:`tianshou_tpu_torch.models.mlp.MLP`; they take
``input_dim``) and ``NoisyLinear`` (Rainbow).

Where the centring lives: the flax layer stores ``mu_w`` and ``mu_b`` as
draws from ``[0, 2/sqrt(in))`` and subtracts ``1/sqrt(in)`` in its forward.
This layer stores the centred means themselves, drawn from
``[-1/sqrt(in), 1/sqrt(in))``, in PyTorch's ``[out, in]`` layout;
:func:`tianshou_tpu_torch.models.convert.noisy_linear_params_from_flax`
subtracts the shift and transposes. A constant shift leaves the gradients
unchanged, so both train alike.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.models.mlp import MLP

__all__ = ["DiscreteActor", "DiscreteCritic", "NoisyLinear", "Noise", "factorized_noise"]


class DiscreteActor(nn.Module):
    """obs -> action logits (reference discrete.py:29)."""

    def __init__(self, hidden_sizes: Sequence[int], action_dim: int, *, input_dim: int) -> None:
        super().__init__()
        self.mlp = MLP(input_dim, hidden_sizes, action_dim)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.mlp(obs)


class DiscreteCritic(nn.Module):
    """obs -> value, or ``last_size`` values per observation (reference discrete.py:94)."""

    def __init__(self, hidden_sizes: Sequence[int], last_size: int = 1, *, input_dim: int) -> None:
        super().__init__()
        self.last_size = last_size
        self.mlp = MLP(input_dim, hidden_sizes, last_size)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        out = self.mlp(obs)
        return out[:, 0] if self.last_size == 1 else out

#: what a noisy forward takes: nothing (mean weights), a generator that draws
#: the factorized noise, or the pair ``(eps_in [in], eps_out [out])`` itself
Noise = torch.Generator | tuple[torch.Tensor, torch.Tensor] | None


def factorized_noise(n: int, generator: torch.Generator, device: torch.device | str) -> torch.Tensor:
    """``f(e) = sign(e) * sqrt(|e|)`` of ``n`` standard normal draws."""
    e = torch.randn(n, generator=generator, device=device)
    return e.sign() * e.abs().sqrt()


class NoisyLinear(nn.Module):
    """Factorized-Gaussian noisy layer for Rainbow (reference discrete.py:317):
    ``y = x @ (mu_w + sigma_w * outer(eps_out, eps_in)).T + mu_b + sigma_b * eps_out``.

    ``forward(x, noise)`` resamples nothing by itself: ``noise=None`` uses the
    mean weights (evaluation, acting, target computation), a
    ``torch.Generator`` draws fresh factorized noise on ``x``'s device, and a
    pair ``(eps_in, eps_out)`` is used as given.
    """

    def __init__(self, in_features: int, features: int, sigma0: float = 0.5) -> None:
        super().__init__()
        self.in_features = in_features
        self.features = features
        bound = 1.0 / math.sqrt(in_features)
        sig_init = sigma0 / math.sqrt(in_features)
        self.mu_w = nn.Parameter(torch.empty(features, in_features).uniform_(-bound, bound))
        self.mu_b = nn.Parameter(torch.empty(features).uniform_(-bound, bound))
        self.sigma_w = nn.Parameter(torch.full((features, in_features), sig_init))
        self.sigma_b = nn.Parameter(torch.full((features,), sig_init))

    def forward(self, x: torch.Tensor, noise: Noise = None) -> torch.Tensor:
        if noise is None:
            return F.linear(x, self.mu_w, self.mu_b)
        if isinstance(noise, torch.Generator):
            eps_in = factorized_noise(self.in_features, noise, x.device)
            eps_out = factorized_noise(self.features, noise, x.device)
        else:
            eps_in, eps_out = noise
        w = self.mu_w + self.sigma_w * torch.outer(eps_out, eps_in)
        b = self.mu_b + self.sigma_b * eps_out
        return F.linear(x, w, b)
