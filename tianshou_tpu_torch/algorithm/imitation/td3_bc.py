"""TD3+BC (port of ``tianshou_tpu/algorithm/imitation/td3_bc.py``; reference
``imitation/td3_bc.py:14``; arXiv:2106.06860): TD3 whose actor's loss adds a
behaviour-cloning term, ``-lambda * mean Q(s, pi(s)) + mean |pi(s) - a|^2``
with ``lambda = alpha / max(mean |Q|, 1e-8)`` (a constant of the loss). The
critics, the delayed actor step (a select on the device) and the targets are
TD3's.
"""

from __future__ import annotations

from typing import Any

import torch

from tianshou_tpu_torch.algorithm.base import Draws, Snapshot, TrainState, optimizer_tensors
from tianshou_tpu_torch.algorithm.modelfree.td3 import TD3
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["TD3BC"]


class TD3BC(TD3):
    run_mode = "offline"

    def __init__(self, *args: Any, alpha: float = 2.5, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.bc_alpha = alpha

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        td1 = batch.returns - ts.model["critic"](batch.obs, batch.act)
        td2 = batch.returns - ts.model["critic2"](batch.obs, batch.act)
        c_loss = self._weighted_mean(td1**2 + td2**2, batch.get("weight"))
        self._minimize(ts, c_loss, "critic", "critic2")
        a = ts.model["actor"](batch.obs)
        q = ts.model["critic"](batch.obs, a)
        lmbda = self.bc_alpha / q.detach().abs().mean().clamp(min=1e-8)
        bc = ((a - batch.act) ** 2).sum(-1).mean()
        a_loss = -lmbda * q.mean() + bc
        snapshot = Snapshot(optimizer_tensors(ts.optim["actor"]))
        snapshot.take()
        self._minimize(ts, a_loss, "actor")
        snapshot.restore_where(ts.step % self.update_actor_freq != 0)
        ts.step += 1
        self._polyak(ts)
        return ts, Batch(loss=c_loss.detach(), actor_loss=a_loss.detach(), bc_loss=bc.detach(),
                         td_error=((td1 + td2) / 2.0).detach())
