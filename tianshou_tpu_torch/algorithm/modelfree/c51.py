"""C51 categorical DQN (arXiv:1707.06887) + Rainbow (port of
``tianshou_tpu/algorithm/modelfree/c51.py``; reference ``modelfree/c51.py``
``C51Policy:16`` / ``C51:70`` and ``modelfree/rainbow.py:18``).

The Bellman shift runs the n-step return over the support atoms (reference
``_target_q`` returns the support, c51.py:121) and the projection uses the
clamp trick (c51.py:137-146). As in the JAX package, the next-state
distribution is evaluated at the n-step terminal index's ``obs_next`` (the
state the shifted support belongs to), where the reference uses the 1-step
``batch.obs_next`` even for n_step > 1.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import TrainState
from tianshou_tpu_torch.algorithm.modelfree.dqn import QLearningOffPolicyAlgorithm
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.ops.returns import nstep_returns, value_mask

__all__ = ["C51", "RainbowDQN"]


class C51(QLearningOffPolicyAlgorithm):
    """Model must map obs -> [B, A, num_atoms] probabilities (softmax last)."""

    def __init__(self, *args, num_atoms: int = 51, v_min: float = -10.0, v_max: float = 10.0,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.num_atoms = num_atoms
        self.v_min = v_min
        self.v_max = v_max
        self.delta_z = (v_max - v_min) / (num_atoms - 1)
        self._supports: dict[torch.device, torch.Tensor] = {}

    def init(self, device: str | torch.device | None = None) -> TrainState:
        ts = super().init(device)
        self.support(next(ts.model.parameters()).device)  # made here, never inside a CUDA graph's capture
        return ts

    def support(self, device: torch.device) -> torch.Tensor:
        """The ``[num_atoms]`` support atoms on ``device`` (made once per device)."""
        if device not in self._supports:
            self._supports[device] = torch.linspace(self.v_min, self.v_max, self.num_atoms, device=device)
        return self._supports[device]

    def _probs(self, model: nn.Module, obs: Any, generator: torch.Generator | None = None) -> torch.Tensor:
        return model(obs)

    def _q(self, model: nn.Module, obs: Any) -> torch.Tensor:
        probs = self._probs(model, obs)
        return (probs * self.support(probs.device)).sum(-1)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def preprocess(self, ts: TrainState, buffer, buf_state, batch: Batch, indices: torch.Tensor,
                   generator: torch.Generator) -> Batch:
        rews, ends, obs_next_t, terminated_t = self._nstep_terminal(buffer, buf_state, batch, indices)
        support = self.support(rews.device)
        mask = value_mask(terminated_t)
        support_b = support[None, :] * mask[:, None]
        returns = nstep_returns(rews, ends, support_b, self.gamma)
        target_support = returns.clamp(self.v_min, self.v_max)  # [B, atoms]

        # next-state distribution at the greedy action (double selection)
        probs_sel = self._probs(ts.model, obs_next_t)
        a_star = (probs_sel * support).sum(-1).argmax(dim=-1)
        probs_t = self._probs(ts.target if self.use_target else ts.model, obs_next_t)
        next_dist = probs_t[torch.arange(a_star.shape[0], device=a_star.device), a_star]  # [B, atoms]

        # projection (clamp trick, c51.py:137)
        proj = (
            1.0 - (target_support[:, None, :] - support[None, :, None]).abs() / self.delta_z
        ).clamp(0.0, 1.0)  # [B, atoms_i, atoms_j]
        batch.target_dist = (proj * next_dist[:, None, :]).sum(-1)  # [B, atoms]
        return batch

    # ------------------------------------------------------------------
    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        """One optimizer step on the (weighted) cross-entropy between the
        projected target and the current distribution, in place. The
        per-sample cross-entropy is returned as ``td_error`` (the Rainbow
        priority, reference c51.py:155)."""
        weight = batch.get("weight")
        probs = self._probs(ts.model, batch.obs, generator)
        curr = probs[torch.arange(probs.shape[0], device=probs.device), batch.act.to(torch.int64)]
        ce = -(batch.target_dist * torch.log(curr + 1e-8)).sum(-1)
        loss = (ce if weight is None else weight * ce).mean()
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        self._sync_target(ts)
        return ts, Batch(loss=loss.detach(), td_error=ce.detach())


class RainbowDQN(C51):
    """C51 over a noisy dueling net (reference rainbow.py:18). The model's
    forward takes the noise; the loss forward of each update draws fresh
    factorized noise from the update's generator (under a CUDA graph, the
    generator the graph registered), while action selection and target
    computation use the mean weights."""

    def _probs(self, model: nn.Module, obs: Any, generator: torch.Generator | None = None) -> torch.Tensor:
        return model(obs, generator)
