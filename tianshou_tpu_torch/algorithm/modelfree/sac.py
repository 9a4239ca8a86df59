"""SAC, soft actor-critic with automatic entropy tuning (port of
``tianshou_tpu/algorithm/modelfree/sac.py``; reference ``modelfree/sac.py``:
``SACPolicy`` :54, ``Alpha``/``FixedAlpha``/``AutoAlpha`` :134-209 and
``SAC`` :212; arXiv:1812.05905).

The actor is a tanh-squashed Gaussian
(:class:`tianshou_tpu_torch.models.distributions.TanhNormal`), the critics
are twins with a min-Q target and a halved loss. ``alpha`` is a fixed
number, or with ``"auto"`` a learned 0-d ``log_alpha`` parameter of the
train state's model with an optimizer of its own (``alpha_optim``, Adam at
3e-4 by default) and ``target_entropy = -action_dim`` by default. The alpha
loss reads the log-probabilities of the actor's loss and the ``log_alpha``
from before the step; the stats report ``exp`` of the new one. The target
action is sampled from the online actor. ``deterministic_eval`` acts by the
mode, ``tanh(loc)``.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, Draws, TrainState, standard_normal
from tianshou_tpu_torch.algorithm.modelfree.ddpg import ContinuousOffPolicyBase
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, OptimizerFactory, init_adam_state
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Space
from tianshou_tpu_torch.models.distributions import TanhNormal

__all__ = ["SAC"]


class SAC(ContinuousOffPolicyBase):
    target_keys = ("critic", "critic2")
    twin_critics = True

    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module,
        action_space: Space,
        alpha: float | str = "auto",
        alpha_optim: OptimizerFactory | None = None,
        target_entropy: float | None = None,
        deterministic_eval: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("exploration_noise", None)  # the stochastic policy explores itself
        kwargs.setdefault("action_bound_method", None)  # tanh already bounds
        super().__init__(actor=actor, critic=critic, action_space=action_space, **kwargs)
        self.auto_alpha = alpha == "auto"
        self.fixed_alpha = 0.2 if self.auto_alpha else float(alpha)
        self.alpha_optim = alpha_optim if alpha_optim is not None else AdamOptimizerFactory(lr=3e-4)
        self.target_entropy = target_entropy if target_entropy is not None else -float(self.action_dim)
        self.deterministic_eval = deterministic_eval

    # ------------------------------------------------------------------
    def _factory(self, key: str) -> OptimizerFactory:
        return self.alpha_optim if key == "log_alpha" else super()._factory(key)

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """As the base class; with ``alpha="auto"`` the model also holds a 0-d
        ``log_alpha`` parameter at zero, stepped by an optimizer of its own."""
        ts = super().init(device)
        if self.auto_alpha:
            ts.model.register_parameter("log_alpha", nn.Parameter(torch.zeros((), device=ts.step.device)))
            ts.optim["log_alpha"] = self.alpha_optim.create([ts.model.log_alpha])
            if isinstance(ts.optim["log_alpha"], torch.optim.Adam):
                init_adam_state(ts.optim["log_alpha"])
        return ts

    def _alpha(self, ts: TrainState) -> torch.Tensor | float:
        """``exp(log_alpha)``, a constant of the losses that read it, or the fixed alpha."""
        return ts.model.log_alpha.detach().exp() if self.auto_alpha else self.fixed_alpha

    def _dist(self, model: nn.Module, obs: torch.Tensor) -> TanhNormal:
        mu, sigma = model["actor"](obs)
        return TanhNormal(loc=mu, scale=sigma)

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        dist = self._dist(ts.model, obs)
        act = dist.mode() if deterministic and self.deterministic_eval else dist.sample(generator)
        return ActOut(act=act, state=state, info=Batch())

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | Draws | None) -> torch.Tensor:
        dist = self._dist(ts.model, obs_next)
        a_next, logp = dist.from_noise(standard_normal(generator, "target", dist.loc))
        q = torch.minimum(ts.target["critic"](obs_next, a_next), ts.target["critic2"](obs_next, a_next))
        return q - self._alpha(ts) * logp

    def _actor_loss(self, ts: TrainState, batch: Batch, generator: torch.Generator | Draws | None,
                    alpha: torch.Tensor | float) -> tuple[torch.Tensor, torch.Tensor]:
        """``(mean(alpha * logp - Q), logp)`` for a fresh sample of the actor."""
        dist = self._dist(ts.model, batch.obs)
        act, logp = dist.from_noise(standard_normal(generator, "actor", dist.loc))
        q = torch.minimum(ts.model["critic"](batch.obs, act), ts.model["critic2"](batch.obs, act))
        return (alpha * logp - q).mean(), logp

    def _alpha_loss(self, ts: TrainState, logp: torch.Tensor) -> torch.Tensor:
        """``-mean(log_alpha * (logp + target_entropy))`` (reference sac.py:188)."""
        return -(ts.model.log_alpha * (logp.detach() + self.target_entropy)).mean()

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        weight = batch.get("weight")
        td1 = batch.returns - ts.model["critic"](batch.obs, batch.act)
        td2 = batch.returns - ts.model["critic2"](batch.obs, batch.act)
        c_loss = self._weighted_mean(td1**2 + td2**2, weight) / 2.0
        self._minimize(ts, c_loss, "critic", "critic2")
        alpha = self._alpha(ts)
        a_loss, logp = self._actor_loss(ts, batch, generator, alpha)
        self._minimize(ts, a_loss, "actor")
        if self.auto_alpha:
            self._minimize(ts, self._alpha_loss(ts, logp), "log_alpha")
            alpha = ts.model.log_alpha.detach().exp()
        else:
            alpha = torch.full((), alpha, dtype=torch.float32, device=ts.step.device)
        ts.step += 1
        self._polyak(ts)
        c_loss = c_loss.detach()
        return ts, Batch(loss=c_loss, actor_loss=a_loss.detach(), critic_loss=c_loss, alpha=alpha,
                         entropy=-logp.detach().mean(), td_error=((td1 + td2) / 2.0).detach())
