"""Behaviour cloning (port of ``tianshou_tpu/algorithm/imitation/bc.py``;
reference ``imitation/imitation_base.py``: ``ImitationPolicy`` :37,
``OfflineImitationLearning`` :158).

The model maps observations to logits (discrete actions: cross-entropy on
the dataset's action, acting by argmax) or to actions (continuous: the
summed squared error, acting by the output itself).
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, OfflineAlgorithm, TrainState
from tianshou_tpu_torch.algorithm.optim import OptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Space
from tianshou_tpu_torch.models.distributions import Categorical
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["ImitationLearning"]


class ImitationLearning(OfflineAlgorithm):
    """Model: obs -> logits (discrete) or action (continuous)."""

    def __init__(self, model: nn.Module, action_space: Space, optim: OptimizerFactory | None = None,
                 **kwargs: Any) -> None:
        kwargs.setdefault("action_scaling", False)
        super().__init__(action_space=action_space, optim=optim, **kwargs)
        self.model = model

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """A fresh TrainState on ``device``: a copy of the model and its optimizer."""
        dev = resolve_device(device)
        model = copy.deepcopy(self.model).to(dev)
        return TrainState(model=model, target=None, optim=self.optim.create(model.parameters()), hparams={},
                          step=torch.zeros((), dtype=torch.int64, device=dev))

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        out = ts.model(obs)
        return ActOut(act=out.argmax(dim=-1) if self.is_discrete else out, state=state, info=Batch())

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        out = ts.model(batch.obs)
        if self.is_discrete:
            loss = -Categorical(logits=out).log_prob(batch.act).mean()
        else:
            loss = ((out - batch.act) ** 2).sum(-1).mean()
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        return ts, Batch(loss=loss.detach())
