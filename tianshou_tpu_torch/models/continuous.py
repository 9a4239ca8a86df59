"""Continuous-control actors and critics (port of
``tianshou_tpu/models/continuous.py``; reference utils/net/continuous.py):
``ContinuousActorDeterministic`` (DDPG, TD3), ``ContinuousActorProbabilistic``
(PPO, and with ``conditioned_sigma`` SAC and REDQ), ``ContinuousCritic`` and
``EnsembleCritic`` (REDQ's N critics as one batched product, output
``[N, B]``). The BCQ nets (``Perturbation``, ``VAE``) are not ported yet.

Like the MLPs of :mod:`tianshou_tpu_torch.models.mlp` they take
``input_dim``. ``ppo_init`` is the reference MuJoCo-PPO recipe
(mujoco_ppo.py:109-120): tanh activations, orthogonal kernels with gain
sqrt(2), the final mu layer at gain 0.01 and log-sigma from ``sigma_init``.
:mod:`tianshou_tpu_torch.models.convert` carries flax weights across.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.models.mlp import MLP, EnsembleLinear, _dense

__all__ = ["ContinuousActorDeterministic", "ContinuousActorProbabilistic", "ContinuousCritic", "EnsembleCritic",
           "SIGMA_MIN", "SIGMA_MAX"]

SIGMA_MIN, SIGMA_MAX = -20.0, 2.0  # reference continuous.py:25


class ContinuousActorDeterministic(nn.Module):
    """obs -> ``max_action * tanh(MLP(obs))`` (reference continuous.py:32)."""

    def __init__(self, hidden_sizes: Sequence[int], action_dim: int, max_action: float = 1.0, *,
                 input_dim: int) -> None:
        super().__init__()
        self.max_action = max_action
        self.mlp = MLP(input_dim, hidden_sizes, action_dim)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.max_action * torch.tanh(self.mlp(obs))


class ContinuousActorProbabilistic(nn.Module):
    """obs -> ``(mu, sigma)`` of a diagonal Gaussian (reference continuous.py:172).

    ``conditioned_sigma``: log-sigma is a second head on the features;
    otherwise it is a learned state-independent parameter (zeros, or
    ``sigma_init`` with ``ppo_init``). Either is clipped to
    ``[SIGMA_MIN, SIGMA_MAX]``.

    ``sde``: generalized state-dependent exploration (gSDE,
    arXiv:2005.05719). The actor learns a log-sigma matrix
    ``log_sigma_mat [F, A]`` (``F`` the last hidden width, ``sigma_init``
    everywhere) and returns ``(mu, sigma(s), feat)`` with the marginal std
    ``sigma_a(s) = sqrt(sum_f feat_f(s)^2 exp(2 log_sigma_fa) + 1e-12)``; the
    collector samples ``mu + feat^T (eps * exp(log_sigma))`` with ``eps``
    carried between resamples
    (:class:`tianshou_tpu_torch.algorithm.modelfree.onpolicy.OnPolicyActorCritic`).
    """

    def __init__(self, hidden_sizes: Sequence[int], action_dim: int, conditioned_sigma: bool = False,
                 ppo_init: bool = False, sigma_init: float = -0.5, sde: bool = False, *, input_dim: int) -> None:
        super().__init__()
        self.conditioned_sigma = conditioned_sigma
        self.sde = sde
        self.hidden_sizes, self.action_dim = tuple(hidden_sizes), action_dim
        gain = math.sqrt(2.0) if ppo_init else None
        self.mlp = MLP(input_dim, hidden_sizes, activation=torch.tanh if ppo_init else F.relu, orthogonal_gain=gain)
        self.mu = _dense(self.mlp.output_dim, action_dim, 0.01 if ppo_init else None)
        if sde:
            self.log_sigma_mat = nn.Parameter(torch.full((self.mlp.output_dim, action_dim), sigma_init))
        elif conditioned_sigma:
            self.sigma = _dense(self.mlp.output_dim, action_dim)
        else:
            self.log_sigma = nn.Parameter(torch.full((action_dim,), sigma_init if ppo_init else 0.0))

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, ...]:
        feat = self.mlp(obs)
        mu = self.mu(feat)
        if self.sde:
            log_sigma = self.log_sigma_mat.clamp(SIGMA_MIN, SIGMA_MAX)
            var = (feat**2) @ torch.exp(2.0 * log_sigma)
            return mu, torch.sqrt(var + 1e-12), feat
        if self.conditioned_sigma:
            log_sigma = self.sigma(feat).clamp(SIGMA_MIN, SIGMA_MAX)
        else:
            log_sigma = self.log_sigma.clamp(SIGMA_MIN, SIGMA_MAX).expand_as(mu)
        return mu, torch.exp(log_sigma)


class ContinuousCritic(nn.Module):
    """(obs, act?) -> scalar value (reference continuous.py:99); with
    ``use_action`` the flattened action (``action_dim`` wide) is concatenated
    to the flattened observation."""

    def __init__(self, hidden_sizes: Sequence[int], use_action: bool = True, ppo_init: bool = False, *,
                 input_dim: int, action_dim: int = 0) -> None:
        super().__init__()
        self.use_action = use_action
        width = input_dim + (action_dim if use_action else 0)
        self.mlp = MLP(width, hidden_sizes, 1, activation=torch.tanh if ppo_init else F.relu,
                       orthogonal_gain=math.sqrt(2.0) if ppo_init else None)

    def reset_parameters(self) -> None:
        self.mlp.reset_parameters()

    def forward(self, obs: torch.Tensor, act: torch.Tensor | None = None) -> torch.Tensor:
        x = obs.reshape(obs.shape[0], -1)
        if self.use_action and act is not None:
            x = torch.cat([x.to(torch.float32), act.reshape(act.shape[0], -1).to(torch.float32)], dim=-1)
        return self.mlp(x)[:, 0]


class EnsembleCritic(nn.Module):
    """``ensemble_size`` independent Q(obs, act) critics evaluated as one
    batched product per layer (reference REDQ's ``EnsembleLinear`` stack,
    net/common.py:518): ReLU after each hidden layer, output ``[N, B]``."""

    def __init__(self, ensemble_size: int, hidden_sizes: Sequence[int], *, input_dim: int, action_dim: int) -> None:
        super().__init__()
        widths = [input_dim + action_dim, *hidden_sizes, 1]
        self.layers = nn.ModuleList(EnsembleLinear(ensemble_size, a, b) for a, b in zip(widths, widths[1:]))

    def reset_parameters(self) -> None:
        for layer in self.layers:
            layer.reset_parameters()

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        x = torch.cat([obs.reshape(obs.shape[0], -1).to(torch.float32),
                       act.reshape(act.shape[0], -1).to(torch.float32)], dim=-1)
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)[..., 0]
