"""CQL, conservative Q-learning for continuous actions (port of
``tianshou_tpu/algorithm/imitation/cql.py``; reference ``imitation/cql.py:32``;
arXiv:2006.04779).

SAC's actor and twin critics with the CQL(H) penalty on each critic:
``cql_weight * (temperature * mean logsumexp(Q_cat / temperature) - mean
Q(s, a))`` over ``Q_cat [B, 3R]``: ``R = num_repeat_actions`` random actions
in ``[-1, 1)`` (less their log density ``A * log 0.5``), and ``R`` samples
each of the stepped actor at ``obs`` and at ``obs_next`` (less their
log-probabilities). With ``with_lagrange`` the penalty's weight is ``clip(exp
log_cql_alpha, 0, 1e6)``, a 0-d parameter of the model stepped by its own
Adam at ``cql_alpha_lr`` on ``-exp(log_cql_alpha) * (penalty - 2 *
lagrange_threshold) / 2``; without it the weight is 1. ``preprocess`` is the
one-step target of SAC's ``_target_q``. One update, in the JAX package's
order: the actor's step against the critics as they were, the candidate
actions, the critics' step, the Lagrange multiplier's step, the entropy
alpha's step, the targets' polyak average.

Every draw comes from the generator or from
:class:`tianshou_tpu_torch.algorithm.base.Draws`: ``target`` (preprocess,
k2), and from the gradient step's k3 ``actor``, ``cql_rand``, ``cql_cur`` and
``cql_next``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import Draws, TrainState, standard_normal, uniform
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, OptimizerFactory, init_adam_state
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["CQL"]


class CQL(SAC):
    run_mode = "offline"

    def __init__(
        self,
        *args: Any,
        cql_alpha_lr: float = 1e-4,
        cql_weight: float = 1.0,
        with_lagrange: bool = True,
        lagrange_threshold: float = 10.0,
        temperature: float = 1.0,
        num_repeat_actions: int = 10,
        **kwargs: Any,
    ) -> None:
        super().__init__(*args, **kwargs)
        self.cql_weight = cql_weight
        self.with_lagrange = with_lagrange
        self.lagrange_threshold = lagrange_threshold
        self.temperature = temperature
        self.num_repeat_actions = num_repeat_actions
        self.cql_alpha_optim = AdamOptimizerFactory(lr=cql_alpha_lr)

    def _factory(self, key: str) -> OptimizerFactory:
        return self.cql_alpha_optim if key == "log_cql_alpha" else super()._factory(key)

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """As SAC's; with ``with_lagrange`` the model also holds a 0-d
        ``log_cql_alpha`` parameter at zero, stepped by an Adam of its own."""
        ts = super().init(device)
        if self.with_lagrange:
            ts.model.register_parameter("log_cql_alpha", nn.Parameter(torch.zeros((), device=ts.step.device)))
            ts.optim["log_cql_alpha"] = self.cql_alpha_optim.create([ts.model.log_cql_alpha])
            init_adam_state(ts.optim["log_cql_alpha"])
        return ts

    @torch.no_grad()
    def preprocess(self, ts: TrainState, buffer, buf_state, batch: Batch, indices: torch.Tensor,
                   generator: torch.Generator | Draws | None = None) -> Batch:
        """The one-step target ``rew + gamma * (1 - terminated) * _target_q(obs_next)``."""
        tq = self._target_q(ts, batch.obs_next, generator)
        batch.returns = batch.rew + self.gamma * (1.0 - batch.terminated.to(torch.float32)) * tq
        return batch

    def _candidates(self, ts: TrainState, obs: torch.Tensor, source: torch.Generator | Draws | None,
                    field: str) -> tuple[torch.Tensor, torch.Tensor]:
        """``R`` samples of the actor per row of ``obs``, repeated row by row:
        ``([B * R, A], [B * R] log-probabilities)``."""
        dist = self._dist(ts.model, obs)
        dist.loc = dist.loc.repeat_interleave(self.num_repeat_actions, dim=0)
        dist.scale = dist.scale.repeat_interleave(self.num_repeat_actions, dim=0)
        return dist.from_noise(standard_normal(source, field, dist.loc))

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        B, R, A = batch.obs.shape[0], self.num_repeat_actions, self.action_dim
        # the actor's step against the critics as they are (SAC-style)
        a_loss, logp = self._actor_loss(ts, batch, generator, self._alpha(ts))
        self._minimize(ts, a_loss, "actor")
        # the candidate actions of the penalty, from the stepped actor
        with torch.no_grad():
            rand_act = uniform(generator, "cql_rand", (B * R, A), batch.obs.device)
            if not isinstance(generator, Draws):  # handed draws are the actions in [-1, 1) themselves
                rand_act = rand_act * 2.0 - 1.0
            cur_act, cur_logp = self._candidates(ts, batch.obs, generator, "cql_cur")
            next_act, next_logp = self._candidates(ts, batch.obs_next, generator, "cql_next")
            obs_rep = batch.obs.repeat_interleave(R, dim=0)
            log_rand_density = A * math.log(0.5)
            cql_alpha = ts.model.log_cql_alpha.detach().exp().clamp(0.0, 1e6) if self.with_lagrange else 1.0

        def penalty(critic: nn.Module, q_data: torch.Tensor) -> torch.Tensor:
            q_cat = torch.cat([critic(obs_rep, rand_act).reshape(B, R) - log_rand_density,
                               critic(obs_rep, cur_act).reshape(B, R) - cur_logp.reshape(B, R),
                               critic(obs_rep, next_act).reshape(B, R) - next_logp.reshape(B, R)], dim=1)
            lse = torch.logsumexp(q_cat / self.temperature, dim=1)
            return (lse.mean() * self.temperature - q_data.mean()) * self.cql_weight

        q1 = ts.model["critic"](batch.obs, batch.act)
        q2 = ts.model["critic2"](batch.obs, batch.act)
        td = ((q1 - batch.returns) ** 2).mean() + ((q2 - batch.returns) ** 2).mean()
        cql_pen = penalty(ts.model["critic"], q1) + penalty(ts.model["critic2"], q2)
        c_loss = td + cql_alpha * cql_pen
        self._minimize(ts, c_loss, "critic", "critic2")
        cql_pen = cql_pen.detach()
        if self.with_lagrange:  # the multiplier of the penalty's budget (reference cql.py:330)
            la = ts.model.log_cql_alpha
            self._minimize(ts, -(torch.exp(la) * (cql_pen - 2 * self.lagrange_threshold)).mean() / 2.0,
                           "log_cql_alpha")
        if self.auto_alpha:
            self._minimize(ts, self._alpha_loss(ts, logp), "log_alpha")
        ts.step += 1
        self._polyak(ts)
        return ts, Batch(loss=c_loss.detach(), actor_loss=a_loss.detach(), td_loss=td.detach(), cql_penalty=cql_pen,
                         td_error=((q1 + q2) / 2 - batch.returns).detach())
