"""Deep Q-Network family base + DQN (port of
``tianshou_tpu/algorithm/modelfree/dqn.py``; reference
``tianshou/algorithm/modelfree/dqn.py``).

``QLearningOffPolicyAlgorithm``: eps-greedy exploration (reference :153),
n-step targets, and a lagged target network synced every
``target_update_freq`` gradient steps, counted after the step (:277).
``DQN``: double-DQN targets by default (:365-379) and an optional Huber
loss (:392). With a prioritized buffer the TD error is written back as the
new priority (:401).

Invalid-action masks (reference :145): an observation ``Batch`` with a
``mask`` (``[B, n]`` bool, True where an action is valid) restricts the
greedy action (Q at ``-inf`` where masked), eps-greedy's random action
(uniform over the valid actions) and the target: ``-1e9`` on the target net's
Q, ``-inf`` on the double-Q selection. C51 and Rainbow inherit the acting.
"""

from __future__ import annotations

import copy
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, OffPolicyAlgorithm, TrainState, sync_target
from tianshou_tpu_torch.algorithm.optim import OptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.prio import PrioritizedReplayBuffer
from tianshou_tpu_torch.env.core import Discrete, MultiDiscrete, Space
from tianshou_tpu_torch.models.distributions import Categorical
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["DQN", "QLearningOffPolicyAlgorithm", "RecurrentDQN", "RecurrentDQN_Mixin"]


class QLearningOffPolicyAlgorithm(OffPolicyAlgorithm):
    """Shared machinery of the DQN family: eps-greedy policy, n-step targets,
    lagged target network."""

    def __init__(
        self,
        model: nn.Module,
        action_space: Space,
        optim: OptimizerFactory | None = None,
        gamma: float = 0.99,
        n_step_return_horizon: int = 1,
        target_update_freq: int = 0,
        eps_training: float = 0.0,
        eps_inference: float = 0.0,
    ) -> None:
        if not isinstance(action_space, (Discrete, MultiDiscrete)):
            raise TypeError(f"Q-learning needs a Discrete or MultiDiscrete action space, got {action_space}")
        super().__init__(action_space=action_space, gamma=gamma, optim=optim)
        self.model = model
        self.n_step = n_step_return_horizon
        # targets come from the n-step terminal row and update_step reads
        # only (obs, act, returns, weight), so for n_step > 1 the sampled
        # row's frame-stacked obs_next is never gathered
        if self.n_step > 1:
            self.update_sample_drop_keys = ("obs_next",)
        self.target_update_freq = target_update_freq
        self.use_target = target_update_freq > 0
        self.eps_training = eps_training
        self.eps_inference = eps_inference

    # ------------------------------------------------------------------
    def init(self, device: str | torch.device | None = None) -> TrainState:
        """A fresh TrainState on ``device``: a copy of ``self.model`` as the
        online net, a second copy as the target net, and a new optimizer."""
        dev = resolve_device(device)
        model = copy.deepcopy(self.model).to(dev)
        target = None
        if self.use_target:
            target = copy.deepcopy(model)
            target.requires_grad_(False)
        def scalar(v: float) -> torch.Tensor:
            return torch.full((), v, dtype=torch.float32, device=dev)

        return TrainState(
            model=model,
            target=target,
            optim=self.optim.create(model.parameters()),
            hparams={"eps_training": scalar(self.eps_training), "eps_inference": scalar(self.eps_inference)},
            step=torch.zeros((), dtype=torch.int64, device=dev),
        )

    # ------------------------------------------------------------------
    def _q(self, model: nn.Module, obs: Any) -> torch.Tensor:
        """Subclasses may reduce distributional output to scalar Q here."""
        return model(obs)

    @staticmethod
    def _action_mask(obs: Any) -> torch.Tensor | None:
        """The valid-action mask of an observation ``Batch`` that has one."""
        return obs.mask if isinstance(obs, Batch) and "mask" in obs else None

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        q = self._q(ts.model, obs)
        mask = self._action_mask(obs)
        if mask is not None:
            q = torch.where(mask, q, -torch.inf)
        return ActOut(act=q.argmax(dim=-1), state=state, info=Batch(q=q))

    def exploration_noise(self, ts: TrainState, act: torch.Tensor, obs: Any,
                          generator: torch.Generator, training: bool = True) -> torch.Tensor:
        """eps-greedy (dqn.py:153), over the valid actions when ``obs`` has a
        mask; ``training`` picks eps_training or eps_inference (dqn.py:158),
        read from its device scalar."""
        mask = self._action_mask(obs)
        if mask is None:
            rand_act = torch.randint(0, self.action_space.n, act.shape, generator=generator,
                                     device=act.device, dtype=act.dtype)
        else:
            u = torch.rand(mask.shape, generator=generator, device=act.device)
            rand_act = self.masked_random_action(mask, u.clamp_(min=torch.finfo(u.dtype).tiny)).to(act.dtype)
        return self.eps_greedy(ts, act, rand_act, torch.rand(act.shape, generator=generator, device=act.device),
                               training)

    @staticmethod
    def masked_random_action(mask: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
        """A uniform draw over the valid actions from ``uniform`` (``[B, n]``
        in ``[tiny, 1)``): Gumbel-max over logits 0 where valid and ``-inf``
        elsewhere, as ``jax.random.categorical`` draws it."""
        return Categorical(logits=torch.where(mask, 0.0, -torch.inf)).from_noise(uniform)

    def eps_greedy(self, ts: TrainState, act: torch.Tensor, rand_act: torch.Tensor, uniform: torch.Tensor,
                   training: bool) -> torch.Tensor:
        """``rand_act`` where ``uniform < eps``, else ``act``."""
        eps = ts.hparams["eps_training" if training else "eps_inference"]
        return torch.where(uniform < eps, rand_act, act)

    # ------------------------------------------------------------------
    def _online(self, ts: TrainState) -> nn.Module:
        """The online net the target net copies (FQF's train state also holds
        the fraction net)."""
        return ts.model

    def _sync_target(self, ts: TrainState) -> TrainState:
        """The target net takes the online weights every ``target_update_freq``
        gradient steps (tianshou_tpu dqn.py:115-123), by :func:`sync_target`."""
        if self.use_target:
            sync_target(ts.target, self._online(ts), ts.step, self.target_update_freq)
        return ts

    def postprocess(self, ts: TrainState, buffer, buf_state, batch: Batch,
                    indices: torch.Tensor, stats: Batch):
        """PER priority writeback (reference dqn.py:401 / prio.py:81)."""
        if isinstance(buffer, PrioritizedReplayBuffer):
            return buffer.update_weight(buf_state, indices, stats.td_error)
        return buf_state


class RecurrentDQN_Mixin:
    """LSTM-carry acting for a Q-learning algorithm whose model is a
    :class:`tianshou_tpu_torch.models.recurrent.RecurrentQNet` (reference
    Recurrent net/common.py:372 and the collector's hidden-state carry).
    Training reads frame-stacked samples (the buffer's ``stack_num``) through
    the model's sequence path; acting steps the cell once per env step from
    the carry the collector holds, zeros at the start and where an episode
    ended."""

    def init_policy_state(self, num_envs: int, device: str | torch.device | None = None):
        """The zero carry ``(c, h)``, ``[num_envs, hidden_size]`` each."""
        return self.model.zero_carry(num_envs, resolve_device(device))

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        q, new_state = ts.model.step(obs, state)
        mask = self._action_mask(obs)
        if mask is not None:
            q = torch.where(mask, q, -torch.inf)
        return ActOut(act=q.argmax(dim=-1), state=new_state, info=Batch(q=q))


class DQN(QLearningOffPolicyAlgorithm):
    def __init__(self, *args, is_double: bool = True, huber_loss_delta: float | None = None,
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.is_double = is_double
        self.huber_loss_delta = huber_loss_delta

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | None = None) -> torch.Tensor:
        """The bootstrap value; draws nothing, so ``generator`` is unused.
        With a mask, masked actions take ``-1e9`` on the target's Q and
        ``-inf`` on the online net's double-Q selection."""
        q_t = self._q(ts.target if self.use_target else ts.model, obs_next)
        mask = self._action_mask(obs_next)
        if mask is not None:
            q_t = torch.where(mask, q_t, -1e9)
        if self.is_double:
            q_sel = self._q(ts.model, obs_next)
            if mask is not None:
                q_sel = torch.where(mask, q_sel, -torch.inf)
            return q_t.gather(-1, q_sel.argmax(dim=-1)[:, None])[:, 0]
        return q_t.max(dim=-1).values

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        """One Adam step on the (weighted) squared or Huber TD error, in place."""
        returns = batch.returns
        weight = batch.get("weight")
        q = self._q(ts.model, batch.obs)
        q_a = q.gather(-1, batch.act.to(torch.int64)[:, None])[:, 0]
        td = returns - q_a
        if self.huber_loss_delta is not None:
            elem = F.huber_loss(q_a, returns, reduction="none", delta=self.huber_loss_delta)
        else:
            elem = td**2
        loss = (elem if weight is None else weight * elem).mean()
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        self._sync_target(ts)
        stats = Batch(loss=loss.detach(), q_mean=q.detach().mean(), td_error=td.detach())
        return ts, stats


class RecurrentDQN(RecurrentDQN_Mixin, DQN):
    """DQN over a ``RecurrentQNet`` with the collector-carried LSTM state."""
