"""Discrete SAC (port of ``tianshou_tpu/algorithm/modelfree/discrete_sac.py``;
reference ``modelfree/discrete_sac.py``: ``DiscreteSACPolicy:31``,
``DiscreteSAC:83``; arXiv:1910.07207).

A categorical actor (logits ``[B, A]``) and twin per-action Q critics
(``[B, A]``); the target and the actor loss are exact expectations over the
categorical distribution. The train state is SAC's
(:class:`tianshou_tpu_torch.algorithm.modelfree.sac.SAC`): ``actor``,
``critic``, ``critic2`` and, with ``alpha="auto"``, ``log_alpha`` in the
model, target copies of both critics, an optimizer per key.

The order inside an update is the JAX package's: both critics step first;
the actor's loss then reads the stepped critics with the alpha from before
the update; ``log_alpha`` steps last (Adam 3e-4 by default) on
``-log_alpha * (target_entropy - entropy)``; the target critics follow by
polyak averaging. ``target_entropy`` defaults to ``0.98 * log(n)``, the log
taken in float32. ``forward`` samples the categorical from its generator,
or takes the mode under ``deterministic`` with ``deterministic_eval``.

The n-step targets come from the terminal row, so for ``n > 1`` the sampled
row's ``obs_next`` is never read; the port does not gather it (as the DQN
family drops it in both packages), where the JAX DiscreteSAC gathers it
unread. The results are the same.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, Draws, TrainState
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Discrete, Space
from tianshou_tpu_torch.models.distributions import Categorical

__all__ = ["DiscreteSAC"]


class DiscreteSAC(SAC):
    def __init__(self, actor: nn.Module, critic: nn.Module, action_space: Space, alpha: float | str = "auto",
                 target_entropy: float | None = None, **kwargs: Any) -> None:
        if not isinstance(action_space, Discrete):
            raise TypeError(f"DiscreteSAC needs a Discrete action space, got {action_space}")
        kwargs.setdefault("action_scaling", False)
        kwargs.setdefault("action_bound_method", "clip")  # the JAX class's default (a discrete action ignores it)
        if target_entropy is None:  # 0.98 x the entropy of the uniform policy
            target_entropy = 0.98 * float(torch.log(torch.tensor(float(action_space.n), dtype=torch.float32)))
        super().__init__(actor=actor, critic=critic, action_space=action_space, alpha=alpha,
                         target_entropy=target_entropy, **kwargs)
        if self.n_step > 1:
            self.update_sample_drop_keys = ("obs_next",)

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        dist = Categorical(logits=ts.model["actor"](obs))
        act = dist.mode() if deterministic and self.deterministic_eval else dist.sample(generator)
        return ActOut(act=act, state=state, info=Batch())

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | Draws | None) -> torch.Tensor:
        """``sum_a pi(a|s') (min Q_target(s', a) - alpha log pi(a|s'))``; draws nothing."""
        logits = ts.model["actor"](obs_next)
        q = torch.minimum(ts.target["critic"](obs_next), ts.target["critic2"](obs_next))
        return (F.softmax(logits, dim=-1) * (q - self._alpha(ts) * F.log_softmax(logits, dim=-1))).sum(-1)

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        weight, act = batch.get("weight"), batch.act.to(torch.int64)[:, None]
        td1 = batch.returns - ts.model["critic"](batch.obs).gather(1, act)[:, 0]
        td2 = batch.returns - ts.model["critic2"](batch.obs).gather(1, act)[:, 0]
        c_loss = self._weighted_mean(td1**2 + td2**2, weight) / 2.0
        self._minimize(ts, c_loss, "critic", "critic2")
        alpha = self._alpha(ts)
        logits = ts.model["actor"](batch.obs)
        probs, logp = F.softmax(logits, dim=-1), F.log_softmax(logits, dim=-1)
        q = torch.minimum(ts.model["critic"](batch.obs), ts.model["critic2"](batch.obs))  # the stepped critics
        ent = -(probs * logp).sum(-1)
        a_loss = (probs * (alpha * logp - q)).sum(-1).mean()
        self._minimize(ts, a_loss, "actor")
        if self.auto_alpha:
            self._minimize(ts, -(ts.model.log_alpha * (self.target_entropy - ent.detach())).mean(), "log_alpha")
        ts.step += 1
        self._polyak(ts)
        c_loss = c_loss.detach()
        return ts, Batch(loss=c_loss, actor_loss=a_loss.detach(), critic_loss=c_loss, entropy=ent.detach().mean(),
                         td_error=((td1 + td2) / 2.0).detach())
