"""DDPG family base + DDPG (port of ``tianshou_tpu/algorithm/modelfree/ddpg.py``;
reference ``modelfree/ddpg.py``: ``ContinuousPolicyWithExplorationNoise``
:45, ``ContinuousDeterministicPolicy`` :114, ``ActorCriticOffPolicyAlgorithm``
:196 and ``DDPG`` :342).

The train state holds the nets in a ``ModuleDict`` keyed as the JAX
package's ``params`` (``actor``, ``critic``, and ``critic2`` for the twin
critics), their lagged copies in a second one keyed as its
``target_params``, and one optimizer per net in a dict keyed as its
``opt_state``: the actor's from ``policy_optim``, each critic's from
``critic_optim``. Every update steps the critic first; the actor's loss then
runs through the stepped critic, and its gradients reach the actor's
parameters only (``backward(inputs=...)``), never a critic's ``.grad``. The
targets follow the online nets by :func:`polyak_update` on every step. With
prioritized replay the TD error is written back as the new priority.
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, Draws, OffPolicyAlgorithm, TrainState, polyak_update, weighted_mean
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, OptimizerFactory, init_adam_state
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.env.core import Space
from tianshou_tpu_torch.exploration.noise import GaussianNoise
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["DDPG", "ContinuousOffPolicyBase"]


class ContinuousOffPolicyBase(OffPolicyAlgorithm):
    """Shared: the actor, the critics, their optimizers, exploration noise
    and the polyak-averaged targets."""

    #: the nets the targets copy, keyed as the JAX ``target_params``
    target_keys: tuple[str, ...] = ("actor", "critic")
    #: a second critic, ``critic2``, of the same shape and its own initial weights
    twin_critics: bool = False

    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module,
        action_space: Space,
        policy_optim: OptimizerFactory | None = None,
        critic_optim: OptimizerFactory | None = None,
        gamma: float = 0.99,
        tau: float = 0.005,
        n_step_return_horizon: int = 1,
        exploration_noise: GaussianNoise | None = GaussianNoise(sigma=0.1),
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("action_scaling", True)
        super().__init__(action_space=action_space, gamma=gamma, **kwargs)
        self.actor = actor
        self.critic = critic
        self.policy_optim = policy_optim if policy_optim is not None else AdamOptimizerFactory(lr=1e-3)
        self.critic_optim = critic_optim if critic_optim is not None else AdamOptimizerFactory(lr=1e-3)
        self.tau = tau
        self.n_step = n_step_return_horizon
        self.noise = exploration_noise

    # ------------------------------------------------------------------
    def _nets(self) -> dict[str, nn.Module]:
        """Fresh copies of the nets, keyed as the JAX ``params``."""
        nets = {"actor": copy.deepcopy(self.actor), "critic": copy.deepcopy(self.critic)}
        if self.twin_critics:  # its own initial weights: the JAX package draws it from a key of its own
            nets["critic2"] = copy.deepcopy(self.critic)
            nets["critic2"].reset_parameters()
        return nets

    def _factory(self, key: str) -> OptimizerFactory:
        return self.policy_optim if key == "actor" else self.critic_optim

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """A fresh TrainState on ``device``: the nets, their targets (copies
        that take no gradient) and one optimizer per net, its state made now
        (a delayed update snapshots it from the first step on)."""
        dev = resolve_device(device)
        model = nn.ModuleDict(self._nets()).to(dev)
        optim = {k: self._factory(k).create(net.parameters()) for k, net in model.items()}
        for opt in optim.values():
            if isinstance(opt, torch.optim.Adam):
                init_adam_state(opt)
        target = nn.ModuleDict({k: copy.deepcopy(model[k]) for k in self.target_keys})
        target.requires_grad_(False)
        return TrainState(model=model, target=target, optim=optim, hparams={},
                          step=torch.zeros((), dtype=torch.int64, device=dev))

    # ------------------------------------------------------------------
    def exploration_noise(self, ts: TrainState, act: torch.Tensor, obs: Any,
                          generator: torch.Generator, training: bool = True) -> torch.Tensor:
        """``act`` plus the noise process's sample, in training only. The
        collector stores this raw action; ``map_action`` clips it for the env."""
        if self.noise is None or not training:
            return act
        return act + self.noise.sample(generator, act.shape, act.device)

    def _minimize(self, ts: TrainState, loss: torch.Tensor, *keys: str) -> None:
        """One optimizer step of each net of ``keys`` on ``loss``; the
        gradients reach those nets' parameters and nothing else."""
        opts = [ts.optim[k] for k in keys]
        params = [p for opt in opts for group in opt.param_groups for p in group["params"]]
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        loss.backward(inputs=params)
        for k, opt in zip(keys, opts):
            self._factory(k).step(opt)

    def _polyak(self, ts: TrainState) -> None:
        polyak_update((p for k in self.target_keys for p in ts.target[k].parameters()),
                      (p for k in self.target_keys for p in ts.model[k].parameters()), self.tau)

    _weighted_mean = staticmethod(weighted_mean)

    def postprocess(self, ts: TrainState, buffer, buf_state, batch: Batch, indices: torch.Tensor, stats: Batch):
        """PER priority writeback of the TD error (reference prio.py:81)."""
        if isinstance(buffer, PrioritizedReplayBuffer) and "td_error" in stats:
            return buffer.update_weight(buf_state, indices, stats.td_error)
        return buf_state


class DDPG(ContinuousOffPolicyBase):
    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        return ActOut(act=ts.model["actor"](obs), state=state, info=Batch())

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | Draws | None) -> torch.Tensor:
        return ts.target["critic"](obs_next, ts.target["actor"](obs_next))

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        """The critic's step on the (weighted) squared TD error, then the
        actor's on ``-Q`` through the stepped critic, then the targets."""
        weight = batch.get("weight")
        td = batch.returns - ts.model["critic"](batch.obs, batch.act)
        c_loss = self._weighted_mean(td**2, weight)
        self._minimize(ts, c_loss, "critic")
        a_loss = -ts.model["critic"](batch.obs, ts.model["actor"](batch.obs)).mean()
        self._minimize(ts, a_loss, "actor")
        ts.step += 1
        self._polyak(ts)
        c_loss, a_loss = c_loss.detach(), a_loss.detach()
        return ts, Batch(loss=c_loss + a_loss, actor_loss=a_loss, critic_loss=c_loss, td_error=td.detach())
