"""IQN, implicit quantile networks (port of ``tianshou_tpu/algorithm/modelfree/iqn.py``;
reference ``modelfree/iqn.py``: ``IQNPolicy:21`` tau sampling, ``IQN:103``;
arXiv:1806.06923).

The model is an implicit-quantile net, ``model(obs, taus) -> [B, K, A]``.
Fractions are drawn in three places, each from the generator it is given
(under a CUDA graph, the generator the graph registered), or handed over as
:class:`tianshou_tpu_torch.algorithm.base.Draws`:

- ``forward`` draws ``[B, sample_size]`` per act (``Draws.taus``);
- ``_target_q`` draws the target's ``[B, target_sample_size]`` and then the
  double-Q selection's ``[B, online_sample_size]`` (``Draws.target_taus`` and
  ``Draws.online_taus``: the JAX package splits the preprocess key in two);
- ``update_step`` draws ``[B, sample_size]`` (``Draws.taus``).
"""

from __future__ import annotations

from typing import Any

import torch

from tianshou_tpu_torch.algorithm.base import ActOut, Draws, TrainState, uniform, weighted_mean
from tianshou_tpu_torch.algorithm.modelfree.dqn import QLearningOffPolicyAlgorithm
from tianshou_tpu_torch.algorithm.modelfree.qrdqn import pick, quantile_huber_loss
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["IQN"]


class IQN(QLearningOffPolicyAlgorithm):
    def __init__(self, *args, sample_size: int = 32, online_sample_size: int = 8, target_sample_size: int = 8,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.sample_size = sample_size
        self.online_sample_size = online_sample_size
        self.target_sample_size = target_sample_size

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | Draws | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        taus = uniform(generator, "taus", (obs.shape[0], self.sample_size), obs.device)
        q = ts.model(obs, taus).mean(1)  # [B, A]
        return ActOut(act=q.argmax(dim=-1), state=state, info=Batch(q=q))

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | Draws | None) -> torch.Tensor:
        """The target net's quantiles ``[B, target_sample_size]`` at the online
        net's greedy action (double selection)."""
        b, dev = obs_next.shape[0], obs_next.device
        z_t = (ts.target if self.use_target else ts.model)(
            obs_next, uniform(generator, "target_taus", (b, self.target_sample_size), dev))  # [B, Kt, A]
        taus_o = uniform(generator, "online_taus", (b, self.online_sample_size), dev)
        a_star = ts.model(obs_next, taus_o).mean(1).argmax(dim=-1)
        return pick(z_t, a_star, 2)

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        """One optimizer step on the (weighted) quantile Huber loss at freshly drawn fractions, in place."""
        returns = batch.returns
        taus = uniform(generator, "taus", (returns.shape[0], self.sample_size), returns.device)
        curr = pick(ts.model(batch.obs, taus), batch.act, 2)  # [B, K]
        loss = weighted_mean(quantile_huber_loss(curr, returns, taus), batch.get("weight"))
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        self._sync_target(ts)
        td = (returns.mean(-1) - curr.detach().mean(-1)).abs()
        return ts, Batch(loss=loss.detach(), td_error=td)
