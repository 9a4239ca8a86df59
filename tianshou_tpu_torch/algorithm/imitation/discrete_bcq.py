"""Discrete BCQ (port of ``tianshou_tpu/algorithm/imitation/discrete_bcq.py``;
reference ``imitation/discrete_bcq.py``: ``DiscreteBCQPolicy`` :37,
``DiscreteBCQ`` :130; arXiv:1910.01708).

A Q net and an imitation head share one optimizer. Acting keeps the actions
whose imitation log-probability is within ``log(unlikely_action_threshold)``
of the best one (``logp - max logp >= log tau``) and takes the argmax of Q
over them (``-inf`` elsewhere). The n-step target selects that way with the
online nets and reads the target net's Q. The loss is the squared TD error,
the imitation cross-entropy and ``imitation_logits_penalty`` times the mean
squared logit. The target nets take the online weights every
``target_update_freq`` steps by a select on the device.

One departure, stated by ``tests/test_torch_imitation_discrete.py``: for
n > 1 the sampled row's ``obs_next`` is not gathered (the update reads only
``obs``, ``act`` and the n-step returns), as the DQN family drops it; the JAX
class gathers it unread.
"""

from __future__ import annotations

import copy
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, OfflineAlgorithm, TrainState, sync_target
from tianshou_tpu_torch.algorithm.optim import OptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Discrete, Space
from tianshou_tpu_torch.models.distributions import Categorical
from tianshou_tpu_torch.ops.returns import nstep_returns, value_mask
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["DiscreteBCQ", "init_with_target"]


def init_with_target(nets: dict[str, nn.Module], factory: OptimizerFactory, use_target: bool,
                     device: str | torch.device | None) -> TrainState:
    """A TrainState on ``device`` over copies of ``nets`` in one ``ModuleDict``
    (keyed as the JAX ``params``), one optimizer over all of them (the JAX
    ``opt_state["all"]``) and, with ``use_target``, a lagged copy of the whole."""
    dev = resolve_device(device)
    model = nn.ModuleDict({k: copy.deepcopy(v) for k, v in nets.items()}).to(dev)
    target = None
    if use_target:
        target = copy.deepcopy(model)
        target.requires_grad_(False)
    return TrainState(model=model, target=target, optim=factory.create(model.parameters()), hparams={},
                      step=torch.zeros((), dtype=torch.int64, device=dev))


class DiscreteBCQ(OfflineAlgorithm):
    def __init__(
        self,
        model: nn.Module,            # obs -> Q [B, A]
        imitator: nn.Module,         # obs -> logits [B, A]
        action_space: Space,
        optim: OptimizerFactory | None = None,
        gamma: float = 0.99,
        n_step_return_horizon: int = 1,
        target_update_freq: int = 8000,
        unlikely_action_threshold: float = 0.3,
        imitation_logits_penalty: float = 1e-2,
        **kwargs: Any,
    ) -> None:
        if not isinstance(action_space, Discrete):
            raise TypeError(f"DiscreteBCQ needs a Discrete action space, got {action_space}")
        super().__init__(action_space=action_space, gamma=gamma, optim=optim, **kwargs)
        self.model = model
        self.imitator = imitator
        self.n_step = n_step_return_horizon
        if self.n_step > 1:
            self.update_sample_drop_keys = ("obs_next",)
        self.target_update_freq = target_update_freq
        self.use_target = target_update_freq > 0
        # log(tau) in float32, as jnp.log computes it
        self.log_tau = float(torch.log(torch.tensor(unlikely_action_threshold, dtype=torch.float32)))
        if not math.isfinite(self.log_tau):
            raise ValueError(f"unlikely_action_threshold must be positive, got {unlikely_action_threshold}")
        self.penalty = imitation_logits_penalty

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """Copies of the Q net and the imitator, keyed ``model`` and ``imitator``,
        one optimizer over both, and their lagged copy."""
        return init_with_target({"model": self.model, "imitator": self.imitator}, self.optim, self.use_target,
                                device)

    def _select(self, model: nn.Module, obs: Any) -> tuple[torch.Tensor, torch.Tensor]:
        """(the filtered greedy action, Q) of ``model``'s nets."""
        q = model["model"](obs)
        logp = F.log_softmax(model["imitator"](obs), dim=-1)
        keep = logp - logp.max(dim=-1, keepdim=True).values >= self.log_tau
        return torch.where(keep, q, -torch.inf).argmax(dim=-1), q

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        act, q = self._select(ts.model, obs)
        return ActOut(act=act, state=state, info=Batch(q=q))

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any) -> torch.Tensor:
        """The target net's Q at the action the online nets select (reference bcq.py:100)."""
        act, _ = self._select(ts.model, obs_next)
        q_t = (ts.target if self.use_target else ts.model)["model"](obs_next)
        return q_t.gather(-1, act[:, None])[:, 0]

    @torch.no_grad()
    def preprocess(self, ts: TrainState, buffer, buf_state, batch: Batch, indices: torch.Tensor,
                   generator: torch.Generator | None = None) -> Batch:
        """``batch.returns``: n-step returns bootstrapped at the chain's terminal row."""
        rews, ends, obs_next_t, terminated_t = self._nstep_terminal(buffer, buf_state, batch, indices)
        batch.returns = nstep_returns(rews, ends, self._target_q(ts, obs_next_t) * value_mask(terminated_t),
                                      self.gamma)
        return batch

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        act = batch.act.to(torch.int64)
        q_a = ts.model["model"](batch.obs).gather(-1, act[:, None])[:, 0]
        td = batch.returns - q_a
        logits = ts.model["imitator"](batch.obs)
        ce = -Categorical(logits=logits).log_prob(act).mean()
        loss = (td**2).mean() + ce + self.penalty * (logits**2).mean()
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        if self.use_target:
            sync_target(ts.target, ts.model, ts.step, self.target_update_freq)
        return ts, Batch(loss=loss.detach(), ce_loss=ce.detach(), td_error=td.detach())
