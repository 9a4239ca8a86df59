"""Continuous-control actors and critics (port of
``tianshou_tpu/models/continuous.py``; reference utils/net/continuous.py):
``ContinuousActorDeterministic`` (DDPG, TD3), ``ContinuousActorProbabilistic``
(PPO, and with ``conditioned_sigma`` SAC and REDQ), ``ContinuousCritic`` and
``EnsembleCritic`` (REDQ's N critics as one batched product, output
``[N, B]``), and BCQ's ``Perturbation`` and conditional ``VAE``.

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
           "Perturbation", "SIGMA_MIN", "SIGMA_MAX", "VAE"]

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


class Perturbation(nn.Module):
    """BCQ's action perturbation (reference continuous.py:378): ``(obs, act) ->
    clip(act + phi * max_action * tanh(MLP([obs, act])), +-max_action)``."""

    def __init__(self, hidden_sizes: Sequence[int], action_dim: int, max_action: float = 1.0, phi: float = 0.05, *,
                 input_dim: int) -> None:
        super().__init__()
        self.max_action, self.phi = max_action, phi
        self.mlp = MLP(input_dim + action_dim, hidden_sizes, action_dim)

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
        noise = self.phi * self.max_action * torch.tanh(self.mlp(torch.cat([obs, act], dim=-1)))
        return (act + noise).clamp(-self.max_action, self.max_action)


class VAE(nn.Module):
    """BCQ's conditional VAE (reference continuous.py:415): the encoder MLP on
    ``[obs, act]``, the latent's mean and log-std heads (log-std clipped to
    ``[-4, 15]``), and the decoder MLP on ``[obs, z]`` with a
    ``max_action * tanh`` output. The forward takes the reparameterization's
    standard normals ``noise [B, latent_dim]``; ``decode`` without ``z`` draws
    them from ``generator`` and uses ``clip(0.5 * noise, -0.5, 0.5)``
    (:meth:`latent`)."""

    def __init__(self, encoder_hidden: Sequence[int], decoder_hidden: Sequence[int], action_dim: int,
                 latent_dim: int, max_action: float = 1.0, *, input_dim: int) -> None:
        super().__init__()
        self.latent_dim, self.max_action = latent_dim, max_action
        self.encoder = MLP(input_dim + action_dim, encoder_hidden)
        self.mean_head = _dense(self.encoder.output_dim, latent_dim)
        self.logstd_head = _dense(self.encoder.output_dim, latent_dim)
        self.decoder = MLP(input_dim + latent_dim, decoder_hidden, action_dim, flatten_input=False)

    def forward(self, obs: torch.Tensor, act: torch.Tensor, noise: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(reconstruction, mean, std)`` of ``act`` given ``obs``."""
        h = self.encoder(torch.cat([obs, act], dim=-1))
        mean = self.mean_head(h)
        std = torch.exp(self.logstd_head(h).clamp(-4.0, 15.0))
        return self.decode(obs, mean + std * noise), mean, std

    @staticmethod
    def latent(noise: torch.Tensor) -> torch.Tensor:
        """The latent of a decode without ``z``: ``clip(0.5 * noise, -0.5, 0.5)``."""
        return (noise * 0.5).clamp(-0.5, 0.5)

    def decode(self, obs: torch.Tensor, z: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
        if z is None:
            z = self.latent(torch.randn((obs.shape[0], self.latent_dim), generator=generator, device=obs.device))
        return self.max_action * torch.tanh(self.decoder(torch.cat([obs, z], dim=-1)))
