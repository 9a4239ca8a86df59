"""Discrete CQL on QRDQN (port of ``tianshou_tpu/algorithm/imitation/discrete_cql.py``;
reference ``imitation/discrete_cql.py:23``; arXiv:2006.04779): the quantile
Huber loss plus the conservative penalty ``min_q_weight * (logsumexp Q -
Q(a))`` of the quantiles' means.
"""

from __future__ import annotations

from typing import Any

import torch

from tianshou_tpu_torch.algorithm.base import TrainState, weighted_mean
from tianshou_tpu_torch.algorithm.modelfree.qrdqn import QRDQN, pick, quantile_huber_loss
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["DiscreteCQL"]


class DiscreteCQL(QRDQN):
    run_mode = "offline"

    def __init__(self, *args: Any, min_q_weight: float = 10.0, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.min_q_weight = min_q_weight

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        returns = batch.returns
        z = ts.model(batch.obs)  # [B, A, K]
        curr = pick(z, batch.act, 1)
        taus = self.taus(curr.device).expand(curr.shape[0], self.num_quantiles)
        qr = weighted_mean(quantile_huber_loss(curr, returns, taus), batch.get("weight"))
        q = z.mean(-1)
        q_a = q.gather(-1, batch.act.to(torch.int64)[:, None])[:, 0]
        cql = (torch.logsumexp(q, dim=-1) - q_a).mean()
        loss = qr + self.min_q_weight * cql
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        self._sync_target(ts)
        td = (returns.mean(-1) - curr.detach().mean(-1)).abs()
        return ts, Batch(loss=loss.detach(), qr_loss=qr.detach(), cql_loss=cql.detach(), td_error=td)
