"""REINFORCE, vanilla policy gradient (port of
``tianshou_tpu/algorithm/modelfree/reinforce.py``; reference
modelfree/reinforce.py ``Reinforce`` :315): no critic, Monte-Carlo returns
to go (``DiscountedReturnComputation`` :249), standardized by the running
return statistics by default."""

from __future__ import annotations

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.modelfree.onpolicy import OnPolicyActorCritic
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["Reinforce"]


class Reinforce(OnPolicyActorCritic):
    def __init__(self, actor, action_space, optim=None, gamma: float = 0.99,
                 return_standardization: bool = True, **kwargs) -> None:
        super().__init__(actor=actor, critic=None, action_space=action_space, optim=optim, gamma=gamma,
                         return_standardization=return_standardization, **kwargs)

    def loss_minibatch(self, model: nn.Module, mb: Batch) -> tuple[torch.Tensor, Batch]:
        logp = self._dist(model, mb.obs).log_prob(mb.act)
        loss = -(logp * mb.returns).mean()
        return loss, Batch(loss=loss)
