"""BDQN, branching dueling Q-network (port of ``tianshou_tpu/algorithm/modelfree/bdqn.py``;
reference ``modelfree/bdqn.py``: ``BDQNPolicy:29``, ``BDQN:106``;
arXiv:1711.08946).

The model maps observations to ``[B, num_branches, action_per_branch]``
(:class:`tianshou_tpu_torch.models.mlp.BranchingNet`); an action is the
per-branch argmax, ``[B, K]``, stored per row in the replay. Exploration is
eps-greedy per sample over the whole branch vector: ``randint [B, K]``, then
``uniform [B]``. The target is one scalar per sample: the mean over branches
of the target net's branch-Q at the online net's argmax (double) or its own.
The n-step horizon defaults to 1.
"""

from __future__ import annotations

from typing import Any

import torch

from tianshou_tpu_torch.algorithm.base import ActOut, TrainState, weighted_mean
from tianshou_tpu_torch.algorithm.modelfree.dqn import QLearningOffPolicyAlgorithm
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["BDQN"]


class BDQN(QLearningOffPolicyAlgorithm):
    def __init__(self, *args, is_double: bool = True, **kwargs) -> None:
        kwargs.setdefault("n_step_return_horizon", 1)
        super().__init__(*args, **kwargs)
        self.is_double = is_double

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        q = ts.model(obs)  # [B, K, A]
        return ActOut(act=q.argmax(dim=-1), state=state, info=Batch(q=q))

    def exploration_noise(self, ts: TrainState, act: torch.Tensor, obs: Any,
                          generator: torch.Generator, training: bool = True) -> torch.Tensor:
        """eps-greedy per sample over the whole branch vector (bdqn.py:74)."""
        rand_act = torch.randint(0, self.model.action_per_branch, act.shape, generator=generator,
                                 device=act.device, dtype=act.dtype)
        u = torch.rand(act.shape[:1], generator=generator, device=act.device)
        return self.eps_greedy(ts, act, rand_act, u[:, None], training)

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | None = None) -> torch.Tensor:
        """The mean over branches of the target's branch-Q at the greedy action ``[B]`` (bdqn.py:152)."""
        q_t = (ts.target if self.use_target else ts.model)(obs_next)
        a_star = (ts.model(obs_next) if self.is_double else q_t).argmax(dim=-1)
        return q_t.gather(-1, a_star[..., None])[..., 0].mean(-1)

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        """One optimizer step on the (weighted) branch-mean squared TD error, in place."""
        q_a = ts.model(batch.obs).gather(-1, batch.act.to(torch.int64)[..., None])[..., 0]  # [B, K]
        td = batch.returns[:, None] - q_a
        loss = weighted_mean((td**2).mean(-1), batch.get("weight"))
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        self._sync_target(ts)
        return ts, Batch(loss=loss.detach(), td_error=td.detach().mean(-1))
