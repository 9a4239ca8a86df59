"""ICM, the intrinsic curiosity module as a wrapper (port of
``tianshou_tpu/algorithm/modelbased/icm.py``; reference ``modelbased/icm.py``:
``ICMOffPolicyWrapper`` :112, ``ICMOnPolicyWrapper`` :187; arXiv:1705.05363).

The wrapper adds ``reward_scale`` times the forward model's prediction error
(:class:`tianshou_tpu_torch.models.discrete.IntrinsicCuriosityModule`) to the
reward before the wrapped algorithm's update: off-policy to the sampled
batch's returns after the wrapped ``preprocess``, on-policy to the rollout's
rewards. After the wrapped update the ICM net takes one step on
``((1 - w) * inverse loss + w * forward loss) * lr_scale``.

The JAX package namespaces the ICM's parameters under ``"icm"`` beside the
wrapped algorithm's and hands the wrapped update the rest. Here the train
state's model is ``ModuleDict({"wrapped": the wrapped model, "icm": the ICM
net})`` and its optimizers ``{"wrapped": ..., "icm": ...}``; the wrapped
algorithm sees a view of the train state with its own model and
optimizer(s) and the shared target, step and hyper-parameters, which it
updates in place.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, Draws, OffPolicyAlgorithm, OnPolicyAlgorithm, TrainState
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, OptimizerFactory, init_adam_state
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["ICMOffPolicyWrapper", "ICMOnPolicyWrapper"]


class _ICMMixin:
    """What both wrappers share: the ICM net, its optimizer, the train state's
    layout, the intrinsic reward, the ICM step and the acting hooks."""

    def _icm_setup(self, wrapped, model: nn.Module, optim: OptimizerFactory | None, lr_scale: float,
                   reward_scale: float, forward_loss_weight: float) -> None:
        self.wrapped = wrapped
        self.icm_model = model
        self.icm_optim = optim if optim is not None else AdamOptimizerFactory(lr=1e-3)
        self.lr_scale = lr_scale
        self.reward_scale = reward_scale
        self.forward_loss_weight = forward_loss_weight

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """The wrapped algorithm's train state, its model and optimizer(s)
        under ``"wrapped"`` beside a copy of the ICM net and its optimizer."""
        inner = self.wrapped.init(device)
        icm = copy.deepcopy(self.icm_model).to(resolve_device(device))
        opt = self.icm_optim.create(icm.parameters())
        if isinstance(opt, torch.optim.Adam):
            init_adam_state(opt)
        return dataclasses.replace(inner, model=nn.ModuleDict({"wrapped": inner.model, "icm": icm}),
                                   optim={"wrapped": inner.optim, "icm": opt})

    @staticmethod
    def inner(ts: TrainState) -> TrainState:
        """The wrapped algorithm's view of the train state."""
        return dataclasses.replace(ts, model=ts.model["wrapped"], optim=ts.optim["wrapped"])

    @torch.no_grad()
    def _intrinsic(self, ts: TrainState, obs, act, obs_next) -> torch.Tensor:
        return self.reward_scale * ts.model["icm"](obs, act, obs_next)[0]

    def _icm_update(self, ts: TrainState, obs, act, obs_next) -> Batch:
        """One step of the ICM net on its forward and inverse losses."""
        mse, act_hat = ts.model["icm"](obs, act, obs_next)
        forward_loss = mse.mean()
        inverse_loss = F.cross_entropy(act_hat, act.to(torch.int64))
        loss = ((1 - self.forward_loss_weight) * inverse_loss + self.forward_loss_weight * forward_loss) * self.lr_scale
        opt = ts.optim["icm"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        self.icm_optim.step(opt)
        return Batch(icm_loss=loss.detach(), icm_forward_loss=forward_loss.detach(),
                     icm_inverse_loss=inverse_loss.detach())

    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        return self.wrapped.forward(self.inner(ts), obs, generator, state, deterministic)

    def exploration_noise(self, ts: TrainState, act: torch.Tensor, obs: Any, generator: torch.Generator,
                          training: bool = True) -> torch.Tensor:
        return self.wrapped.exploration_noise(self.inner(ts), act, obs, generator, training)

    def map_action(self, act: torch.Tensor) -> torch.Tensor:
        return self.wrapped.map_action(act)


class ICMOffPolicyWrapper(_ICMMixin, OffPolicyAlgorithm):
    """The bonus is added to the sampled batch's returns after the wrapped
    ``preprocess``, from the ICM net as it is before the update. The sample
    keeps ``obs_next`` whatever the wrapped algorithm drops, since the ICM
    reads it."""

    def __init__(self, wrapped: OffPolicyAlgorithm, model: nn.Module, optim: OptimizerFactory | None = None,
                 lr_scale: float = 1.0, reward_scale: float = 0.01, forward_loss_weight: float = 0.2) -> None:
        super().__init__(action_space=wrapped.action_space, gamma=wrapped.gamma)
        self._icm_setup(wrapped, model, optim, lr_scale, reward_scale, forward_loss_weight)
        self.n_step = wrapped.n_step

    def preprocess(self, ts: TrainState, buffer, buf_state, batch: Batch, indices: torch.Tensor,
                   generator: torch.Generator | Draws | None = None) -> Batch:
        batch = self.wrapped.preprocess(self.inner(ts), buffer, buf_state, batch, indices, generator)
        bonus = self._intrinsic(ts, batch.obs, batch.act, batch.obs_next)
        batch.returns = batch.returns + bonus.reshape(bonus.shape + (1,) * (batch.returns.dim() - 1))
        return batch

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        _, stats = self.wrapped.update_step(self.inner(ts), batch, generator)
        stats.update(self._icm_update(ts, batch.obs, batch.act, batch.obs_next))
        return ts, stats

    def postprocess(self, ts: TrainState, buffer, buf_state, batch: Batch, indices: torch.Tensor, stats: Batch):
        return self.wrapped.postprocess(self.inner(ts), buffer, buf_state, batch, indices, stats)


class ICMOnPolicyWrapper(_ICMMixin, OnPolicyAlgorithm):
    """The bonus of the ICM net as it is before the update is added to the
    rollout's rewards; the ICM step follows the wrapped update over the whole
    rollout."""

    def __init__(self, wrapped: OnPolicyAlgorithm, model: nn.Module, optim: OptimizerFactory | None = None,
                 lr_scale: float = 1.0, reward_scale: float = 0.01, forward_loss_weight: float = 0.2) -> None:
        super().__init__(action_space=wrapped.action_space, gamma=wrapped.gamma)
        self._icm_setup(wrapped, model, optim, lr_scale, reward_scale, forward_loss_weight)

    def rollout_grad_steps(self, n: int, repeat: int, batch_size: int) -> int:
        return self.wrapped.rollout_grad_steps(n, repeat, batch_size)

    def update_rollout(self, ts: TrainState, rollout: Batch, generator: torch.Generator | None, repeat: int,
                       batch_size: int, perm: torch.Tensor | None = None) -> tuple[TrainState, Batch]:
        T, E = rollout.rew.shape

        def flat(x: torch.Tensor) -> torch.Tensor:
            return x.reshape(T * E, *x.shape[2:])

        obs, act, obs_next = flat(rollout.obs), flat(rollout.act), flat(rollout.obs_next)
        rollout = rollout.copy()
        rollout.rew = rollout.rew + self._intrinsic(ts, obs, act, obs_next).reshape(T, E)
        _, stats = self.wrapped.update_rollout(self.inner(ts), rollout, generator, repeat, batch_size, perm)
        stats.update(self._icm_update(ts, obs, act, obs_next))
        return ts, stats
