"""REDQ, randomized ensembled double Q-learning (port of
``tianshou_tpu/algorithm/modelfree/redq.py``; reference ``modelfree/redq.py``:
``REDQPolicy`` :37, ``REDQ`` :134; arXiv:2101.05982).

SAC's tanh-Gaussian actor and alpha over an ensemble of N critics
(:class:`tianshou_tpu_torch.models.continuous.EnsembleCritic`, output
``[N, B]``, one optimizer). The target takes a random subset of M members,
by ``min`` or ``mean``; the subset is drawn on the device as the first M of
the argsort of N float64 uniforms (``jax.random.permutation`` cannot be
reproduced; tests hand JAX's draw over through
:class:`tianshou_tpu_torch.algorithm.base.Draws`), so that a CUDA graph
draws a fresh one on every replay. The actor's loss reads the mean of all N
members. The actor's and alpha's steps are delayed by ``actor_delay``: both
are computed on every update and selected back on the device unless the step
count, read before it advances, is a multiple of it. The target ensemble
follows by polyak. As in the JAX package, REDQ writes no priorities back to
a prioritized buffer.
"""

from __future__ import annotations

from typing import Any

import torch

from tianshou_tpu_torch.algorithm.base import Draws, Snapshot, TrainState, optimizer_tensors, standard_normal
from tianshou_tpu_torch.algorithm.modelfree.sac import SAC
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["REDQ"]


class REDQ(SAC):
    """``critic`` must be an ``EnsembleCritic`` of ``ensemble_size`` members."""

    target_keys = ("critic",)
    twin_critics = False

    def __init__(self, *args: Any, ensemble_size: int = 10, subset_size: int = 2, actor_delay: int = 20,
                 target_mode: str = "min", **kwargs: Any) -> None:
        if target_mode not in ("min", "mean"):
            raise ValueError(f"target_mode must be 'min' or 'mean', got {target_mode!r}")
        super().__init__(*args, **kwargs)
        self.ensemble_size = ensemble_size
        self.subset_size = subset_size
        self.actor_delay = actor_delay
        self.target_mode = target_mode

    def _subset(self, generator: torch.Generator | Draws, device: torch.device) -> torch.Tensor:
        """``[M]`` distinct member indices: the first M of a random permutation of N."""
        if isinstance(generator, Draws):
            return generator.subset.to(device)
        keys = torch.rand(self.ensemble_size, dtype=torch.float64, generator=generator, device=device)
        return keys.argsort()[: self.subset_size]

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | Draws | None) -> torch.Tensor:
        dist = self._dist(ts.model, obs_next)
        a_next, logp = dist.from_noise(standard_normal(generator, "target", dist.loc))
        q_sub = ts.target["critic"](obs_next, a_next)[self._subset(generator, a_next.device)]  # [M, B]
        q = q_sub.min(0).values if self.target_mode == "min" else q_sub.mean(0)
        return q - self._alpha(ts) * logp

    def _actor_loss(self, ts: TrainState, batch: Batch, generator: torch.Generator | Draws | None,
                    alpha: torch.Tensor | float) -> tuple[torch.Tensor, torch.Tensor]:
        dist = self._dist(ts.model, batch.obs)
        act, logp = dist.from_noise(standard_normal(generator, "actor", dist.loc))
        return (alpha * logp - ts.model["critic"](batch.obs, act).mean(0)).mean(), logp

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        weight = batch.get("weight")
        td = batch.returns[None, :] - ts.model["critic"](batch.obs, batch.act)  # [N, B]
        c_loss = self._weighted_mean(td**2, None if weight is None else weight[None, :])
        self._minimize(ts, c_loss, "critic")
        a_loss, logp = self._actor_loss(ts, batch, generator, self._alpha(ts))
        delayed = ["actor", "log_alpha"] if self.auto_alpha else ["actor"]
        snapshot = Snapshot(t for k in delayed for t in optimizer_tensors(ts.optim[k]))
        snapshot.take()
        self._minimize(ts, a_loss, "actor")
        if self.auto_alpha:
            self._minimize(ts, self._alpha_loss(ts, logp), "log_alpha")
        snapshot.restore_where(ts.step % self.actor_delay != 0)
        ts.step += 1
        self._polyak(ts)
        c_loss = c_loss.detach()
        return ts, Batch(loss=c_loss, actor_loss=a_loss.detach(), critic_loss=c_loss, td_error=td.detach().mean(0))

    def postprocess(self, ts: TrainState, buffer, buf_state, batch: Batch, indices: torch.Tensor, stats: Batch):
        return buf_state
