"""A2C, advantage actor-critic (port of ``tianshou_tpu/algorithm/modelfree/a2c.py``;
reference modelfree/a2c.py:156): the policy-gradient loss on GAE advantages,
the value MSE weighted by ``vf_coef`` and the entropy bonus by ``ent_coef``;
gradient clipping is the optimizer factory's ``max_grad_norm``."""

from __future__ import annotations

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.modelfree.onpolicy import OnPolicyActorCritic
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["A2C"]


class A2C(OnPolicyActorCritic):
    def __init__(self, actor, critic, action_space, optim=None, gamma: float = 0.99,
                 gae_lambda: float = 0.95, vf_coef: float = 0.5, ent_coef: float = 0.01, **kwargs) -> None:
        super().__init__(actor=actor, critic=critic, action_space=action_space, optim=optim, gamma=gamma,
                         gae_lambda=gae_lambda, vf_coef=vf_coef, ent_coef=ent_coef, **kwargs)

    def loss_minibatch(self, model: nn.Module, mb: Batch) -> tuple[torch.Tensor, Batch]:
        dist = self._dist(model, mb.obs)
        logp = dist.log_prob(mb.act)
        actor_loss = -(logp * mb.adv).mean()
        vf_loss = ((mb.returns - self._value(model, mb.obs)) ** 2).mean()
        ent = dist.entropy().mean()
        loss = actor_loss + self.vf_coef * vf_loss - self.ent_coef * ent
        return loss, Batch(loss=loss, actor_loss=actor_loss, vf_loss=vf_loss, entropy=ent)
