"""Random action policy (port of ``tianshou_tpu/algorithm/random_policy.py``;
reference algorithm_base.py:1063 ``RandomActionPolicy``): uniform samples of
the action space, usable wherever an algorithm is expected (prefill,
baselines). Actions of a ``Discrete`` space are int64."""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, Algorithm, TrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Space
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["RandomActionPolicy"]


class RandomActionPolicy(Algorithm):
    def __init__(self, action_space: Space, **kwargs) -> None:
        super().__init__(action_space=action_space, **kwargs)

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """A state without weights: an empty module, no target, no optimizer."""
        return TrainState(model=nn.Module(), target=None, optim=None, hparams={},
                          step=torch.zeros((), dtype=torch.int64, device=resolve_device(device)))

    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        """One uniform sample per observation row, on the observation's device."""
        act = self.action_space.sample(obs.shape[0], generator, obs.device)
        return ActOut(act=act, state=state, info=Batch())

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        return ts, Batch()
