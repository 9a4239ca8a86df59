"""GAIL, generative adversarial imitation learning (port of
``tianshou_tpu/algorithm/imitation/gail.py``; reference
``imitation/gail.py:31``; arXiv:1606.03476).

PPO with a discriminator ``D(s, a)`` (a logit) trained to tell the expert's
transitions (label 1) from the policy's (label 0). Each ``update_rollout``
takes ``disc_update_num`` discriminator steps on ``batch_size`` expert rows
and ``batch_size`` rollout rows, drawn on the device, then replaces the
rollout's reward by ``-log(1 - sigmoid(D)) = softplus(D)`` and runs PPO's
update over it. The expert data lives on the algorithm's device. The train
state's model holds ``actor``, ``critic`` and ``disc``; its optimizers are
``{"ac": PPO's, "disc": the discriminator's}``, as the JAX ``opt_state``.
Indices come from the generator, or from
:class:`tianshou_tpu_torch.algorithm.base.Draws` (``expert_indices``,
``policy_indices``), with PPO's minibatches as ``perm``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algorithm.base import Draws, TrainState
from tianshou_tpu_torch.algorithm.modelfree.ppo import PPO
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, OptimizerFactory, init_adam_state
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["GAIL"]


class GAIL(PPO):
    def __init__(
        self,
        *args: Any,
        disc_net: nn.Module,             # (obs, act) -> logit [B]
        expert_obs: np.ndarray | torch.Tensor,
        expert_act: np.ndarray | torch.Tensor,
        disc_optim: OptimizerFactory | None = None,
        disc_update_num: int = 4,
        **kwargs: Any,
    ) -> None:
        super().__init__(*args, **kwargs)
        self.disc_net = disc_net
        self.expert_obs, self.expert_act = torch.as_tensor(expert_obs), torch.as_tensor(expert_act)
        self.disc_optim = disc_optim if disc_optim is not None else AdamOptimizerFactory(lr=1e-3)
        self.disc_update_num = disc_update_num

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """PPO's train state with the discriminator added to the model and its
        optimizer beside PPO's; the expert data moves to the same device."""
        ts = super().init(device)
        dev = ts.step.device
        self.expert_obs, self.expert_act = self.expert_obs.to(dev), self.expert_act.to(dev)
        ts.model["disc"] = copy.deepcopy(self.disc_net).to(dev)
        disc_opt = self.disc_optim.create(ts.model["disc"].parameters())
        if isinstance(disc_opt, torch.optim.Adam):
            init_adam_state(disc_opt)
        ts.optim = {"ac": ts.optim, "disc": disc_opt}
        return ts

    def _disc_step(self, ts: TrainState, obs: torch.Tensor, act: torch.Tensor, ei: torch.Tensor,
                   pi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One discriminator step (reference gail.py:214); returns (loss, accuracy)."""
        disc, opt = ts.model["disc"], ts.optim["disc"]
        d_exp = disc(self.expert_obs[ei], self.expert_act[ei])
        d_pol = disc(obs[pi], act[pi])
        loss = F.softplus(-d_exp).mean() + F.softplus(d_pol).mean()  # BCE: expert -> 1, policy -> 0
        acc = ((d_exp > 0).to(torch.float32).mean() + (d_pol < 0).to(torch.float32).mean()) / 2.0
        opt.zero_grad(set_to_none=True)
        loss.backward()
        self.disc_optim.step(opt)
        return loss.detach(), acc.detach()

    def update_rollout(self, ts: TrainState, rollout: Batch, generator: torch.Generator | Draws | None, repeat: int,
                       batch_size: int, perm: torch.Tensor | None = None) -> tuple[TrainState, Batch]:
        T, E = rollout.rew.shape
        obs = rollout.obs.reshape(T * E, *rollout.obs.shape[2:])
        act = rollout.act.reshape(T * E, *rollout.act.shape[2:])
        dev = obs.device
        steps = []
        for i in range(self.disc_update_num):
            if isinstance(generator, Draws):
                ei, pi = generator.expert_indices[i].to(dev), generator.policy_indices[i].to(dev)
            else:
                ei = torch.randint(0, self.expert_obs.shape[0], (batch_size,), generator=generator, device=dev)
                pi = torch.randint(0, T * E, (batch_size,), generator=generator, device=dev)
            steps.append(self._disc_step(ts, obs, act, ei, pi))
        with torch.no_grad():  # the adversarial reward (reference gail.py:188)
            rollout = rollout.copy()
            rollout.rew = F.softplus(ts.model["disc"](obs, act)).reshape(T, E)
        _, stats = super().update_rollout(dataclasses.replace(ts, optim=ts.optim["ac"]), rollout, generator, repeat,
                                          batch_size, perm)
        stats.disc_loss = torch.stack([s[0] for s in steps]).mean()
        stats.disc_acc = torch.stack([s[1] for s in steps]).mean()
        return ts, stats
