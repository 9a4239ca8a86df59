"""Discrete-action nets (port of ``tianshou_tpu/models/discrete.py``; reference
utils/net/discrete.py): ``DiscreteActor`` and ``DiscreteCritic`` (the
on-policy pair, over :class:`tianshou_tpu_torch.models.mlp.MLP`; they take
``input_dim``), ``NoisyLinear`` and the MLP ``RainbowNet`` (Rainbow), the
implicit-quantile machinery of IQN and FQF (``CosineEmbedding``,
``ImplicitQuantileNetwork`` with its separate ``features`` / ``quantiles``
and its alias ``FullQuantileFunction``, ``FractionProposalNetwork``), the
``IntrinsicCuriosityModule`` and ``MaskedQNet``.

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

from tianshou_tpu_torch.models.mlp import MLP, _dense

__all__ = ["DiscreteActor", "DiscreteCritic", "NoisyLinear", "Noise", "factorized_noise", "RainbowNet",
           "CosineEmbedding", "ImplicitQuantileNetwork", "FullQuantileFunction", "FractionProposalNetwork",
           "IntrinsicCuriosityModule", "MaskedQNet"]


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

    def reset_parameters(self) -> None:
        self.mlp.reset_parameters()

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


class RainbowNet(nn.Module):
    """Dueling noisy distributional head over an MLP trunk (reference
    atari_network.py:154 over utils/net/discrete.py:317): the value stream
    ``v1 -> v2`` over the atoms, the advantage stream ``a1 -> a2`` over
    actions x atoms, mean-advantage subtraction, softmax over the atoms.
    ``forward(obs, noise)`` takes the noise as ``RainbowAtariNet`` does."""

    def __init__(self, hidden_sizes: Sequence[int], action_dim: int, num_atoms: int = 51, sigma0: float = 0.5, *,
                 input_dim: int) -> None:
        super().__init__()
        self.action_dim, self.num_atoms = action_dim, num_atoms
        self.trunk = MLP(input_dim, hidden_sizes)
        h = hidden_sizes[-1]
        self.v1 = NoisyLinear(h, h, sigma0)
        self.v2 = NoisyLinear(h, num_atoms, sigma0)
        self.a1 = NoisyLinear(h, h, sigma0)
        self.a2 = NoisyLinear(h, action_dim * num_atoms, sigma0)

    def forward(self, obs: torch.Tensor, noise: torch.Generator | Sequence[Noise] | None = None) -> torch.Tensor:
        feat = self.trunk(obs)
        n = [noise] * 4 if noise is None or isinstance(noise, torch.Generator) else noise
        v = self.v2(F.relu(self.v1(feat, n[0])), n[1]).reshape(-1, 1, self.num_atoms)
        a = self.a2(F.relu(self.a1(feat, n[2])), n[3]).reshape(-1, self.action_dim, self.num_atoms)
        return F.softmax(v + a - a.mean(dim=1, keepdim=True), dim=-1)


class CosineEmbedding(nn.Module):
    """Fractions ``[B, K]`` -> ``relu(Dense(cos(tau * i * pi)))`` ``[B, K,
    embedding_dim]`` for ``i = 1..num_cosines`` (reference discrete.py:126)."""

    def __init__(self, embedding_dim: int, num_cosines: int = 64) -> None:
        super().__init__()
        self.num_cosines = num_cosines
        self.linear = _dense(num_cosines, embedding_dim)

    def forward(self, taus: torch.Tensor) -> torch.Tensor:
        i = torch.arange(1, self.num_cosines + 1, dtype=torch.float32, device=taus.device)
        return F.relu(self.linear(torch.cos(taus[..., None] * i * math.pi)))


class _QuantileHead(nn.Module):
    """What IQN's MLP and Atari nets share: a trunk (``features``), the
    cosine embedding of the fractions, and ``head(relu(merge(feat *
    embedding)))`` (``quantiles``) -> ``[B, K, A]``."""

    trunk: nn.Module

    def _make_head(self, feat_dim: int, action_dim: int, num_cosines: int) -> None:
        self.cos_emb = CosineEmbedding(feat_dim, num_cosines)
        self.merge = _dense(feat_dim, feat_dim)
        self.head = _dense(feat_dim, action_dim)

    def features(self, obs: torch.Tensor) -> torch.Tensor:
        return self.trunk(obs)

    def quantiles(self, feat: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
        mixed = feat[:, None, :] * self.cos_emb(taus)
        return self.head(F.relu(self.merge(mixed)))

    def forward(self, obs: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
        return self.quantiles(self.features(obs), taus)


class ImplicitQuantileNetwork(_QuantileHead):
    """IQN head over an MLP trunk (reference discrete.py:163): ``psi(obs) *
    phi(tau) -> Q(tau)``, ``[B, K, A]``; FQF drives ``features`` and
    ``quantiles`` apart."""

    def __init__(self, hidden_sizes: Sequence[int], action_dim: int, num_cosines: int = 64, *,
                 input_dim: int) -> None:
        super().__init__()
        self.trunk = MLP(input_dim, hidden_sizes)
        self._make_head(hidden_sizes[-1], action_dim, num_cosines)


#: FQF's quantile function is the same net (reference discrete.py:255)
FullQuantileFunction = ImplicitQuantileNetwork


class FractionProposalNetwork(nn.Module):
    """FQF's fraction proposal (reference discrete.py:219): features ->
    ``(taus [B, K+1], tau_hats [B, K], entropy [B])``; its Dense starts
    from flax's ``xavier_uniform``."""

    def __init__(self, num_fractions: int, *, input_dim: int) -> None:
        super().__init__()
        self.linear = nn.Linear(input_dim, num_fractions)
        nn.init.xavier_uniform_(self.linear.weight)
        nn.init.zeros_(self.linear.bias)

    def forward(self, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        logits = self.linear(feat)
        probs = F.softmax(logits, dim=-1)
        tau = torch.cat([torch.zeros_like(probs[:, :1]), torch.cumsum(probs, dim=-1)], dim=-1)
        tau_hat = (tau[:, 1:] + tau[:, :-1]) / 2.0
        entropy = -(probs * F.log_softmax(logits, dim=-1)).sum(-1)
        return tau, tau_hat, entropy


class IntrinsicCuriosityModule(nn.Module):
    """ICM (reference discrete.py:377): two feature MLPs (``obs`` and
    ``obs_next``), a forward model on ``[phi1, one_hot(act)]`` and an inverse
    model on ``[phi1, phi2]``; returns ``(0.5 * |phi2_hat - phi2|^2, act
    logits)``, the first the intrinsic reward."""

    def __init__(self, feature_hidden: Sequence[int], action_dim: int, hidden_sizes: Sequence[int] = (256,), *,
                 input_dim: int) -> None:
        super().__init__()
        self.action_dim = action_dim
        self.phi = MLP(input_dim, feature_hidden)
        self.phi_next = MLP(input_dim, feature_hidden)
        f = self.phi.output_dim
        self.forward_model = MLP(f + action_dim, hidden_sizes, f, flatten_input=False)
        self.inverse_model = MLP(2 * f, hidden_sizes, action_dim, flatten_input=False)

    def forward(self, obs: torch.Tensor, act: torch.Tensor, obs_next: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        phi1, phi2 = self.phi(obs), self.phi_next(obs_next)
        act_oh = F.one_hot(act.to(torch.int64), self.action_dim).to(phi1.dtype)
        phi2_hat = self.forward_model(torch.cat([phi1, act_oh], dim=-1))
        mse = 0.5 * ((phi2_hat - phi2) ** 2).sum(-1)
        return mse, self.inverse_model(torch.cat([phi1, phi2], dim=-1))


class MaskedQNet(nn.Module):
    """Q net over dict observations ``{obs, mask}``: an MLP on the flattened
    board, ``-1e9`` where the action is invalid (the action-mask pattern of
    the reference's tic-tac-toe example)."""

    def __init__(self, hidden_sizes: Sequence[int], action_dim: int, *, input_dim: int) -> None:
        super().__init__()
        self.mlp = MLP(input_dim, hidden_sizes, action_dim)

    def forward(self, obs) -> torch.Tensor:
        q = self.mlp(obs.obs.reshape(obs.obs.shape[0], -1))
        return torch.where(obs.mask, q, -1e9)
