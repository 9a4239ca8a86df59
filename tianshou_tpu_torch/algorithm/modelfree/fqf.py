"""FQF, fully parameterized quantile function (port of
``tianshou_tpu/algorithm/modelfree/fqf.py``; reference ``modelfree/fqf.py``:
``FQFPolicy:27``, ``FQF:109``; arXiv:1911.02140).

A fraction proposal net over the implicit-quantile model's features gives
the fractions ``taus [B, K+1]``, their midpoints ``tau_hats [B, K]`` and
their entropy. The train state's ``model`` is a ``ModuleDict`` of ``model``
(the implicit-quantile net) and ``fraction``
(:class:`tianshou_tpu_torch.models.discrete.FractionProposalNetwork`), keyed
as the JAX ``params``, with one optimizer each: ``optim`` (Adam) on the
model and ``fraction_optim`` on the fraction net, by default optax's
``rmsprop(2.5e-9)``, whose decay is 0.9. The target net copies the model
only.

One backward of ``q_loss + fraction_loss`` feeds both optimizers, as the JAX
update takes one gradient of the sum with respect to both groups. Gradients
stop only where the JAX update stops them (``fqf.py:96-112``): at the
quantiles at the inner fractions and at the current quantiles inside the
fraction loss. So the Q loss reaches the fraction net through ``tau_hats``,
and the fraction loss and the entropy reach the model's trunk through the
features. The target's fractions come from the online trunk and fraction
net, its quantiles from the target net.
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, TrainState, weighted_mean
from tianshou_tpu_torch.algorithm.modelfree.dqn import QLearningOffPolicyAlgorithm
from tianshou_tpu_torch.algorithm.modelfree.qrdqn import pick, quantile_huber_loss
from tianshou_tpu_torch.algorithm.optim import OptimizerFactory, RMSpropOptimizerFactory, init_adam_state
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.models.discrete import FractionProposalNetwork
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["FQF"]


class FQF(QLearningOffPolicyAlgorithm):
    """``model`` is an implicit-quantile net with ``features`` and ``quantiles``."""

    def __init__(self, *args, num_fractions: int = 32, ent_coef: float = 10.0,
                 fraction_optim: OptimizerFactory | None = None, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.num_fractions = num_fractions
        self.ent_coef = ent_coef
        self.fraction_net = FractionProposalNetwork(num_fractions, input_dim=self.model.merge.in_features)
        # optax.rmsprop(2.5e-9): decay 0.9, eps 1e-8 inside the square root
        self.fraction_optim = fraction_optim if fraction_optim is not None else \
            RMSpropOptimizerFactory(lr=2.5e-9, alpha=0.9)

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """The model and the fraction net in one ``ModuleDict``, a target copy
        of the model, and an optimizer per group (their state made now)."""
        dev = resolve_device(device)
        model = nn.ModuleDict({"model": copy.deepcopy(self.model), "fraction": copy.deepcopy(self.fraction_net)})
        model.to(dev)
        optim = {"model": self.optim.create(model["model"].parameters()),
                 "fraction": self.fraction_optim.create(model["fraction"].parameters())}
        for opt in optim.values():
            if isinstance(opt, torch.optim.Adam):
                init_adam_state(opt)
        target = None
        if self.use_target:
            target = copy.deepcopy(model["model"])
            target.requires_grad_(False)
        return TrainState(model=model, target=target, optim=optim,
                          hparams={k: torch.full((), v, dtype=torch.float32, device=dev)
                                   for k, v in (("eps_training", self.eps_training),
                                                ("eps_inference", self.eps_inference))},
                          step=torch.zeros((), dtype=torch.int64, device=dev))

    def _online(self, ts: TrainState) -> nn.Module:
        return ts.model["model"]

    # ------------------------------------------------------------------
    @staticmethod
    def _widths(taus: torch.Tensor) -> torch.Tensor:
        return (taus[:, 1:] - taus[:, :-1])[:, :, None]

    def _q(self, model: nn.Module, obs: Any) -> torch.Tensor:
        """``sum_k (tau_{k+1} - tau_k) Z(tau_hat_k)`` ``[B, A]`` of a ``ModuleDict`` of both nets."""
        feat = model["model"].features(obs)
        taus, tau_hats, _ = model["fraction"](feat)
        return (self._widths(taus) * model["model"].quantiles(feat, tau_hats)).sum(1)

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        q = self._q(ts.model, obs)
        return ActOut(act=q.argmax(dim=-1), state=state, info=Batch(q=q))

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | None = None) -> torch.Tensor:
        """The target net's quantiles ``[B, K]`` at the online fractions'
        midpoints, at the greedy action of their weighted mean (reference fqf.py:162)."""
        taus, tau_hats, _ = ts.model["fraction"](ts.model["model"].features(obs_next))
        tm = ts.target if self.use_target else ts.model["model"]
        z_t = tm.quantiles(tm.features(obs_next), tau_hats)  # [B, K, A]
        return pick(z_t, (self._widths(taus) * z_t).sum(1).argmax(dim=-1), 2)

    # ------------------------------------------------------------------
    def losses(self, model: nn.Module, batch: Batch) -> tuple[torch.Tensor, ...]:
        """``(loss, q_loss, fraction_loss, td_error)`` of the ``ModuleDict``
        ``model`` on ``batch``, with their autograd graph."""
        net, fnet = model["model"], model["fraction"]
        act, returns = batch.act, batch.returns
        feat = net.features(batch.obs)
        taus, tau_hats, ent = fnet(feat)
        curr = pick(net.quantiles(feat, tau_hats), act, 2)  # [B, K]
        q_loss = weighted_mean(quantile_huber_loss(curr, returns, tau_hats), batch.get("weight"))
        # the fraction loss: dW1/dtau_k ~ 2 Z(tau_k) - Z(tau_hat_{k-1}) - Z(tau_hat_k)
        z_tau_a = pick(net.quantiles(feat, taus[:, 1:-1]), act, 2)
        grad_tau = 2.0 * z_tau_a.detach() - curr[:, :-1].detach() - curr[:, 1:].detach()
        frac_loss = (grad_tau * taus[:, 1:-1]).sum(-1).mean() - self.ent_coef * ent.mean()
        td = (returns.mean(-1) - curr.detach().mean(-1)).abs()
        return q_loss + frac_loss, q_loss, frac_loss, td

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        """One step of each optimizer on the gradient of ``q_loss + fraction_loss``, in place."""
        loss, q_loss, frac_loss, td = self.losses(ts.model, batch)
        for opt in ts.optim.values():
            opt.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim["model"])
        self.fraction_optim.step(ts.optim["fraction"])
        ts.step += 1
        self._sync_target(ts)
        return ts, Batch(loss=loss.detach(), q_loss=q_loss.detach(), fraction_loss=frac_loss.detach(), td_error=td)
