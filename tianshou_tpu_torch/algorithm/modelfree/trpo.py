"""TRPO, trust region policy optimization (port of
``tianshou_tpu/algorithm/modelfree/trpo.py``; reference ``modelfree/trpo.py:23``,
arXiv:1502.05477).

NPG's search direction ``s``, scaled to the full step
``sqrt(2 max_kl / max(sHs, 1e-8)) * s``, then a backtracking line search
over the fractions ``backtrack_coeff ** i``, ``i < max_backtracks``: the
first fraction whose step keeps the KL within ``max_kl`` and improves the
surrogate is taken, none if no fraction does. As in the JAX package, every
candidate is evaluated and the choice is a select on the device, so the
search has no host branch and a CUDA graph captures it. The fractions are
float32 powers computed once on the CPU, the bits ``jax.lax.pow`` gives.
Inside a mesh step each candidate's objective and KL are the whole
minibatch's (averaged over the ranks in one collective), so every rank
selects the same fraction.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.algorithm.base import TrainState
from tianshou_tpu_torch.algorithm.modelfree.npg import NPG, _flat, _ranks_mean
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["TRPO"]


class TRPO(NPG):
    def __init__(self, *args, max_kl: float = 0.01, backtrack_coeff: float = 0.8, max_backtracks: int = 10,
                 **kwargs) -> None:
        kwargs.setdefault("trust_region_size", max_kl)
        super().__init__(*args, **kwargs)
        self.max_kl = max_kl
        self.backtrack_coeff = backtrack_coeff
        self.max_backtracks = max_backtracks
        # candidate i's fraction, backtrack_coeff ** i in float32
        self._fracs = torch.tensor(backtrack_coeff, dtype=torch.float32) ** torch.arange(max_backtracks)
        self._fracs_on: dict[torch.device, torch.Tensor] = {}

    def _fractions(self, device: torch.device) -> torch.Tensor:
        if device not in self._fracs_on:
            self._fracs_on[device] = self._fracs.to(device)
        return self._fracs_on[device]

    def _update_minibatch(self, ts: TrainState, mb: Batch) -> Batch:
        actor = ts.model["actor"]
        s, obj_old, shs = self._natural_step(actor, mb)
        with torch.no_grad():
            flat = _flat(actor.parameters())
            full_step = torch.sqrt(2.0 * self.max_kl / torch.clamp(shs, min=1e-8)) * s
            fracs = self._fractions(flat.device)
            best = torch.zeros((), dtype=torch.float32, device=flat.device)
            done = torch.zeros((), dtype=torch.bool, device=flat.device)
            for i in range(self.max_backtracks):
                params = self._unflatten(actor, flat + fracs[i] * full_step)
                obj, kl = _ranks_mean(self._actor_objective(actor, mb, params), self._kl_to_old(actor, mb, params))
                ok = (kl <= self.max_kl) & (obj > obj_old) & ~done
                best = torch.where(ok, fracs[i], best)
                done = done | ok
            self._set_actor(actor, flat + best * full_step)
        vf_loss, kl = self._critic_steps_and_kl(ts, mb)
        ts.step += 1
        return Batch(loss=-obj_old, actor_objective=obj_old, vf_loss=vf_loss, kl=kl, step_frac=best,
                     accepted=done.to(torch.float32))
