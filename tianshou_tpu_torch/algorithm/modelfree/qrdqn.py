"""QRDQN, quantile regression DQN (port of ``tianshou_tpu/algorithm/modelfree/qrdqn.py``;
reference ``modelfree/qrdqn.py``: ``QRDQNPolicy:18``, ``QRDQN:26``;
arXiv:1710.10044).

The model maps observations to ``[B, A, num_quantiles]``; Q is the mean over
the quantiles. The target is the target net's quantiles at its greedy action,
``[B, K]``, shifted by the n-step return (``nstep_returns`` keeps trailing
dims). The loss is the quantile Huber loss at the fixed fractions
``(i + 0.5) / K``, a float32 buffer on the device made at ``init``. With a
prioritized buffer the TD error of the means is written back.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import TrainState, weighted_mean
from tianshou_tpu_torch.algorithm.modelfree.dqn import QLearningOffPolicyAlgorithm
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["QRDQN", "pick", "quantile_huber_loss"]


def quantile_huber_loss(curr: torch.Tensor, target: torch.Tensor, taus: torch.Tensor,
                        kappa: float = 1.0) -> torch.Tensor:
    """``curr [B, K]``, ``target [B, K']``, ``taus [B, K]`` -> per-sample loss
    ``[B]``: the Huber loss of ``u = target - curr`` weighted by
    ``|tau - 1{u < 0}|``, the mean over the target quantiles, the sum over the
    current ones (reference qrdqn.py:96-108)."""
    u = target[:, None, :] - curr[:, :, None]  # [B, K, K']
    huber = torch.where(u.abs() <= kappa, 0.5 * u**2, kappa * (u.abs() - 0.5 * kappa))
    w = (taus[:, :, None] - (u < 0).to(torch.float32)).abs()
    return (w * huber).mean(-1).sum(-1)


def pick(z: torch.Tensor, act: torch.Tensor, dim: int) -> torch.Tensor:
    """``z``'s entries at the action ``act [B]`` along ``dim`` (1 or 2) of a
    ``[B, ., .]`` tensor, that dim dropped."""
    shape = list(z.shape)
    shape[dim] = 1
    return z.gather(dim, act.to(torch.int64).reshape(-1, 1, 1).expand(shape)).squeeze(dim)


class QRDQN(QLearningOffPolicyAlgorithm):
    def __init__(self, *args, num_quantiles: int = 200, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.num_quantiles = num_quantiles
        self._taus: dict[torch.device, torch.Tensor] = {}

    def init(self, device: str | torch.device | None = None) -> TrainState:
        ts = super().init(device)
        self.taus(ts.step.device)  # made here, never inside a CUDA graph's capture
        return ts

    def taus(self, device: torch.device) -> torch.Tensor:
        """The ``[num_quantiles]`` fractions ``(i + 0.5) / K`` on ``device`` (made once per device)."""
        if device not in self._taus:
            self._taus[device] = (torch.arange(self.num_quantiles, dtype=torch.float32, device=device) + 0.5) \
                / self.num_quantiles
        return self._taus[device]

    def _q(self, model: nn.Module, obs: Any) -> torch.Tensor:
        return model(obs).mean(-1)  # the mean over the quantiles of [B, A, K]

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | None = None) -> torch.Tensor:
        """The target net's quantiles at its greedy action, ``[B, K]``; draws nothing."""
        zt = (ts.target if self.use_target else ts.model)(obs_next)
        return pick(zt, zt.mean(-1).argmax(dim=-1), 1)

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        """One optimizer step on the (weighted) quantile Huber loss, in place."""
        returns = batch.returns
        curr = pick(ts.model(batch.obs), batch.act, 1)  # [B, K]
        taus = self.taus(curr.device).expand(curr.shape[0], self.num_quantiles)
        loss = weighted_mean(quantile_huber_loss(curr, returns, taus), batch.get("weight"))
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        self._sync_target(ts)
        td = (returns.mean(-1) - curr.detach().mean(-1)).abs()
        return ts, Batch(loss=loss.detach(), td_error=td)
