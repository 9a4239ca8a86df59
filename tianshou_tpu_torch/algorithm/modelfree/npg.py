"""NPG, the natural policy gradient (port of
``tianshou_tpu/algorithm/modelfree/npg.py``; reference ``modelfree/npg.py:27``).

The actor steps along the natural gradient: the conjugate-gradient solution
``s`` of ``F s = g``, where ``g`` is the gradient of the surrogate objective
``E[ratio * adv]`` and ``F`` the Hessian of the KL divergence from the
rollout's policy, damped by ``damping * I``. The step is the fixed
``trust_region_size * s``. The critic then takes ``optim_critic_iters``
gradient steps of the train state's one optimizer with the actor's gradients
zero, and the actor is put back, as the JAX package's optax chain over
``{"actor", "critic"}`` steps it (the actor's moments and the shared count
move, its weights do not).

The JAX package takes a forward-mode derivative of the KL's gradient
(``jax.jvp`` of ``jax.grad``) on the flattened actor. Here the
Fisher-vector product is a double backward: the KL's gradient is taken once
with ``create_graph=True``, and each product is the gradient of ``grad · v``
through that graph. The conjugate gradient is a fixed-count loop on flat
tensors with no host read, so the whole ``update_rollout`` is one CUDA graph
on the card. Inside a mesh step every rank holds its share of the minibatch:
the surrogate's gradient, each Fisher-vector product and the reported
objective are averaged over the ranks, so every rank solves the same system
and takes the same step; the critic's gradients go through the optimizer's
hook. Both sides compute the same products in other orders, so the
ten iterations can differ from JAX's by float32 rounding;
``tests/test_torch_trust_region.py`` states the tolerance it measured.
"""

from __future__ import annotations

from collections.abc import Callable

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import TrainState
from tianshou_tpu_torch.algorithm.modelfree.onpolicy import OnPolicyActorCritic
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.utils.data_parallel import active_data_parallel

__all__ = ["NPG", "conjugate_gradient"]


def conjugate_gradient(mvp: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """``iters`` iterations of conjugate gradient for ``A x = b``, ``A`` given
    by its product ``mvp``, from ``x = 0`` (reference npg.py:187), with the
    JAX package's ``1e-8`` guards on both denominators."""
    x = torch.zeros_like(b)
    r, p = b.clone(), b.clone()
    rdotr = b @ b
    for _ in range(iters):
        ap = mvp(p)
        alpha = rdotr / (p @ ap + 1e-8)
        x = x + alpha * p
        r = r - alpha * ap
        new_rdotr = r @ r
        beta = new_rdotr / (rdotr + 1e-8)
        p = r + beta * p
        rdotr = new_rdotr
    return x


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _ranks_mean(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``xs`` as they are; inside a mesh step each one's mean over the ranks,
    in one collective (a mean over this rank's rows becomes the whole
    minibatch's)."""
    dp = active_data_parallel()
    if dp is None:
        return xs
    flat = dp.average(torch.cat([x.reshape(-1) for x in xs]))
    return tuple(v.view_as(x) for v, x in zip(flat.split([x.numel() for x in xs]), xs))


class NPG(OnPolicyActorCritic):
    def __init__(
        self,
        actor,
        critic,
        action_space,
        optim=None,
        trust_region_size: float = 0.5,
        optim_critic_iters: int = 5,
        damping: float = 0.1,
        cg_iters: int = 10,
        advantage_normalization: bool = True,
        **kwargs,
    ) -> None:
        super().__init__(actor=actor, critic=critic, action_space=action_space, optim=optim,
                         advantage_normalization=advantage_normalization, **kwargs)
        self.trust_region_size = trust_region_size
        self.optim_critic_iters = optim_critic_iters
        self.damping = damping
        self.cg_iters = cg_iters

    # ------------------------------------------------------------------
    def _actor_objective(self, actor: nn.Module, mb: Batch, params=None) -> torch.Tensor:
        """The surrogate to maximize, ``E[ratio * adv]`` (reference npg.py:110)."""
        dist = self._actor_dist(actor, mb.obs, params)
        ratio = torch.exp(dist.log_prob(mb.act) - mb.logp_old)
        return (ratio * mb.adv).mean()

    def _kl_to_old(self, actor: nn.Module, mb: Batch, params=None) -> torch.Tensor:
        """``KL(rollout policy || policy)``, averaged over the minibatch."""
        return self._dist_from_batch(mb.dist_old).kl_divergence(self._actor_dist(actor, mb.obs, params)).mean()

    def _natural_step(self, actor: nn.Module, mb: Batch) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(s, objective, sHs)``: the flat search direction (the conjugate
        gradient solution of the damped Fisher system), the surrogate
        objective and ``s · (F + damping I) s``."""
        params = list(actor.parameters())
        obj = self._actor_objective(actor, mb)
        g, obj_all = _ranks_mean(_flat(torch.autograd.grad(obj, params)), obj.detach())
        grad_kl = _flat(torch.autograd.grad(self._kl_to_old(actor, mb), params, create_graph=True))

        def fvp(v: torch.Tensor) -> torch.Tensor:
            hv = torch.autograd.grad(grad_kl @ v, params, retain_graph=True)
            return _ranks_mean(_flat(hv))[0] + self.damping * v

        s = conjugate_gradient(fvp, g, self.cg_iters)
        shs = s @ fvp(s)
        return s, obj_all, shs.detach()

    @torch.no_grad()
    def _set_actor(self, actor: nn.Module, flat: torch.Tensor) -> None:
        """Write the flat vector into the actor's parameters."""
        params = list(actor.parameters())
        torch._foreach_copy_(params, [v.view_as(p) for v, p in zip(flat.split([p.numel() for p in params]), params)])

    def _unflatten(self, actor: nn.Module, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        names, params = zip(*actor.named_parameters())
        return {n: v.view_as(p) for n, v, p in zip(names, flat.split([p.numel() for p in params]), params)}

    # ------------------------------------------------------------------
    def _update_minibatch(self, ts: TrainState, mb: Batch) -> Batch:
        actor = ts.model["actor"]
        s, obj, _ = self._natural_step(actor, mb)
        # the fixed step along the natural direction (reference npg.py:170)
        with torch.no_grad():
            self._set_actor(actor, _flat(actor.parameters()) + self.trust_region_size * s)
        vf_loss, kl = self._critic_steps_and_kl(ts, mb)
        ts.step += 1
        return Batch(loss=-obj, actor_objective=obj, vf_loss=vf_loss, kl=kl)

    def _critic_steps_and_kl(self, ts: TrainState, mb: Batch) -> tuple[torch.Tensor, torch.Tensor]:
        """The critic's steps after the actor's, then the stepped actor's KL
        from the rollout's policy: ``(mean critic loss, kl)``, the whole
        minibatch's inside a mesh step."""
        vf_loss = self._critic_steps(ts, mb)
        with torch.no_grad():
            kl = self._kl_to_old(ts.model["actor"], mb)
        dp = active_data_parallel()
        if dp is None:
            return vf_loss, kl
        out = dp.reduce_stats(Batch(vf_loss=vf_loss, kl=kl))
        return out.vf_loss, out.kl

    def _critic_steps(self, ts: TrainState, mb: Batch) -> torch.Tensor:
        """``optim_critic_iters`` steps of the train state's optimizer on the
        critic's squared error, the actor's gradients zero, the actor put
        back after each; returns the mean loss."""
        actor = list(ts.model["actor"].parameters())
        critic = list(ts.model["critic"].parameters())
        with torch.no_grad():
            kept = [p.clone() for p in actor]
        losses = []
        for _ in range(self.optim_critic_iters):
            loss = ((mb.returns - self._value(ts.model, mb.obs)) ** 2).mean()
            ts.optim.zero_grad(set_to_none=True)
            loss.backward(inputs=critic)
            for p in actor:
                p.grad = torch.zeros_like(p)
            self.optim.step(ts.optim)
            with torch.no_grad():
                torch._foreach_copy_(actor, kept)
            losses.append(loss.detach())
        return torch.stack(losses).mean()

