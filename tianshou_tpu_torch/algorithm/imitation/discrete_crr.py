"""Discrete CRR, critic-regularized regression (port of
``tianshou_tpu/algorithm/imitation/discrete_crr.py``; reference
``imitation/discrete_crr.py:33``; arXiv:2006.15134).

An actor (logits) and a critic (Q) share one optimizer. The critic regresses
on the one-step target ``rew + gamma * (1 - terminated) * E_pi'[Q'(s')]``
from the lagged actor and critic (the online ones without a target net). The
actor's loss is the cross-entropy on the dataset's action weighted by the
advantage ``Q(s, a) - E_pi[Q(s, .)]``: ``clip(exp(adv / beta), 0,
ratio_upper_bound)`` (``"exp"``), ``adv > 0`` (``"binary"``) or 1 (``"all"``).
``min_q_weight`` weighs the conservative term ``logsumexp Q - Q(a)``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, OfflineAlgorithm, TrainState, sync_target
from tianshou_tpu_torch.algorithm.imitation.discrete_bcq import init_with_target
from tianshou_tpu_torch.algorithm.optim import OptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Discrete, Space
from tianshou_tpu_torch.models.distributions import Categorical

__all__ = ["DiscreteCRR"]


class DiscreteCRR(OfflineAlgorithm):
    def __init__(
        self,
        actor: nn.Module,      # obs -> logits [B, A]
        critic: nn.Module,     # obs -> Q [B, A]
        action_space: Space,
        optim: OptimizerFactory | None = None,
        gamma: float = 0.99,
        policy_improvement_mode: str = "exp",  # "exp" | "binary" | "all"
        ratio_upper_bound: float = 20.0,
        beta: float = 1.0,
        min_q_weight: float = 10.0,
        target_update_freq: int = 0,
        **kwargs: Any,
    ) -> None:
        if not isinstance(action_space, Discrete):
            raise TypeError(f"DiscreteCRR needs a Discrete action space, got {action_space}")
        if policy_improvement_mode not in ("exp", "binary", "all"):
            raise ValueError(f"policy_improvement_mode must be 'exp', 'binary' or 'all', got {policy_improvement_mode!r}")
        super().__init__(action_space=action_space, gamma=gamma, optim=optim, **kwargs)
        self.actor = actor
        self.critic = critic
        self.mode = policy_improvement_mode
        self.ratio_upper_bound = ratio_upper_bound
        self.beta = beta
        self.min_q_weight = min_q_weight
        self.target_update_freq = target_update_freq
        self.use_target = target_update_freq > 0

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """Copies of the actor and the critic, one optimizer over both, and their lagged copy."""
        return init_with_target({"actor": self.actor, "critic": self.critic}, self.optim, self.use_target, device)

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        dist = Categorical(logits=ts.model["actor"](obs))
        return ActOut(act=dist.mode() if deterministic else dist.sample(generator), state=state, info=Batch())

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        act = batch.act.to(torch.int64)
        with torch.no_grad():  # the one-step target of the lagged nets (reference crr.py:140)
            lagged = ts.target if self.use_target else ts.model
            v_next = (lagged["critic"](batch.obs_next) * Categorical(logits=lagged["actor"](batch.obs_next)).probs).sum(-1)
            target = batch.rew + self.gamma * (1.0 - batch.terminated.to(torch.float32)) * v_next
        q = ts.model["critic"](batch.obs)
        q_a = q.gather(-1, act[:, None])[:, 0]
        critic_loss = ((q_a - target) ** 2).mean()
        dist = Categorical(logits=ts.model["actor"](batch.obs))
        with torch.no_grad():
            adv = q_a - (q * dist.probs).sum(-1)
            if self.mode == "exp":
                w = torch.exp(adv / self.beta).clamp(0.0, self.ratio_upper_bound)
            elif self.mode == "binary":
                w = (adv > 0).to(torch.float32)
            else:
                w = torch.ones_like(adv)
        actor_loss = -(w * dist.log_prob(act)).mean()
        cql = (torch.logsumexp(q, dim=-1) - q_a).mean()  # the min-Q term (reference crr.py:168)
        loss = actor_loss + critic_loss + self.min_q_weight * cql
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        if self.use_target:
            sync_target(ts.target, ts.model, ts.step, self.target_update_freq)
        return ts, Batch(loss=loss.detach(), actor_loss=actor_loss.detach(), critic_loss=critic_loss.detach())
