"""Recurrent networks (port of ``tianshou_tpu/models/recurrent.py``; reference
utils/net/common.py:372 ``Recurrent``, net/continuous.py:241
``RecurrentActorProb``, :325 ``RecurrentCritic``).

Two call paths, as in the JAX package:
- training on frame-stacked samples: ``forward(obs [B, L, O])`` runs the
  LSTM over the L steps from a zero carry and returns the last step's output;
- acting: ``step(obs [B, O], carry)`` advances one step; the collector
  carries the state and resets it where an episode ends.

The cell is ``torch.nn.LSTMCell`` stepped in a loop over L (the JAX package
scans flax's ``OptimizedLSTMCell``; neither runs a hand-written kernel),
initialized as flax initializes its cell, with the input-side bias, which
flax's cell lacks, held at zero.
The carry is ``(c, h)``, flax's order; :func:`tianshou_tpu_torch.models.convert.recurrent_params_from_flax`
carries the weights across.
"""

from __future__ import annotations

import torch
from torch import nn

from tianshou_tpu_torch.models.mlp import _init_dense_, _lecun_normal_

__all__ = ["RecurrentActorProb", "RecurrentCritic", "RecurrentQNet"]

Carry = tuple[torch.Tensor, torch.Tensor]


class _LSTMCore(nn.Module):
    """A Dense embedding with a ReLU, then the LSTM cell."""

    def __init__(self, input_dim: int, hidden_size: int) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.embed = nn.Linear(input_dim, hidden_size)
        self.cell = nn.LSTMCell(hidden_size, hidden_size)
        # flax's cell has no input-side bias: a zero buffer in its place, so that nothing trains it
        del self.cell.bias_ih
        self.cell.register_buffer("bias_ih", torch.zeros(4 * hidden_size))
        _init_dense_(self.embed)
        # flax's initializers per gate: lecun normal on the input, orthogonal on the hidden state, zero bias
        _lecun_normal_(self.cell.weight_ih, hidden_size)
        for gate in self.cell.weight_hh.detach().split(hidden_size):
            nn.init.orthogonal_(gate)
        nn.init.zeros_(self.cell.bias_hh)

    def zero_carry(self, batch: int, device: torch.device | str) -> Carry:
        z = torch.zeros(batch, self.hidden_size, device=device)
        return z, z.clone()

    def one_step(self, obs: torch.Tensor, carry: Carry | None) -> tuple[torch.Tensor, Carry]:
        """``obs [B, O]`` and the carry ``(c, h)`` (None: zeros) -> (output [B, H], new carry)."""
        x = torch.relu(self.embed(obs.to(torch.float32)))
        if carry is None:
            carry = self.zero_carry(x.shape[0], x.device)
        c, h = carry
        h, c = self.cell(x, (h, c))
        return h, (c, h)

    def sequence(self, obs: torch.Tensor) -> torch.Tensor:
        """``obs [B, L, O]`` (or ``[B, O]``: one step) from a zero carry -> the last output ``[B, H]``."""
        if obs.dim() == 2:
            obs = obs[:, None]
        carry = None
        for t in range(obs.shape[1]):
            y, carry = self.one_step(obs[:, t], carry)
        return y


class RecurrentQNet(nn.Module):
    """LSTM Q-network: obs (stacked ``[B, L, O]`` for training, ``[B, O]``
    and a carry for acting) -> Q values ``[B, A]``."""

    def __init__(self, hidden_size: int, action_dim: int, *, input_dim: int) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.core = _LSTMCore(input_dim, hidden_size)
        self.head = nn.Linear(hidden_size, action_dim)
        _init_dense_(self.head)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.head(self.core.sequence(obs))

    def step(self, obs: torch.Tensor, carry: Carry | None) -> tuple[torch.Tensor, Carry]:
        y, carry = self.core.one_step(obs, carry)
        return self.head(y), carry

    def zero_carry(self, batch: int, device: torch.device | str) -> Carry:
        return self.core.zero_carry(batch, device)


class RecurrentActorProb(nn.Module):
    """LSTM Gaussian actor: ``(mu, sigma)`` with ``sigma = exp(clip(., -20, 2))``."""

    def __init__(self, hidden_size: int, action_dim: int, *, input_dim: int) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.core = _LSTMCore(input_dim, hidden_size)
        self.mu = nn.Linear(hidden_size, action_dim)
        self.sigma = nn.Linear(hidden_size, action_dim)
        _init_dense_(self.mu)
        _init_dense_(self.sigma)

    def _heads(self, feat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.mu(feat), torch.exp(self.sigma(feat).clamp(-20.0, 2.0))

    def forward(self, obs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self._heads(self.core.sequence(obs))

    def step(self, obs: torch.Tensor, carry: Carry | None):
        y, carry = self.core.one_step(obs, carry)
        return self._heads(y), carry

    def zero_carry(self, batch: int, device: torch.device | str) -> Carry:
        return self.core.zero_carry(batch, device)


class RecurrentCritic(nn.Module):
    """LSTM critic: the last output, concatenated with the action when one
    is given (``action_dim`` wide), -> a value ``[B]``."""

    def __init__(self, hidden_size: int, *, input_dim: int, action_dim: int = 0) -> None:
        super().__init__()
        self.hidden_size = hidden_size
        self.core = _LSTMCore(input_dim, hidden_size)
        self.head = nn.Linear(hidden_size + action_dim, 1)
        _init_dense_(self.head)

    def forward(self, obs: torch.Tensor, act: torch.Tensor | None = None) -> torch.Tensor:
        feat = self.core.sequence(obs)
        if act is not None:
            feat = torch.cat([feat, act.reshape(act.shape[0], -1).to(feat.dtype)], dim=-1)
        return self.head(feat)[:, 0]
