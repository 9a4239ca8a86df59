"""PPO, proximal policy optimization (port of
``tianshou_tpu/algorithm/modelfree/ppo.py``; reference modelfree/ppo.py:16,
arXiv:1707.06347): the clipped surrogate ratio, the dual clip, the value
clip, per-minibatch advantage normalization and the entropy bonus.
``logp_old`` comes from the parameters before the update (reference
ppo.py:157), in :meth:`process_rollout`.

Two options change the update loop:

- ``recompute_advantage`` (reference ppo.py:152-177): before every pass
  after the first, GAE is recomputed with the updated critic (``v_s``,
  ``adv``, ``returns`` and the return statistics; ``logp_old`` stays the
  collection-time policy's).
- ``target_kl``, the KL guard: once a minibatch's ``approx_kl`` exceeds
  ``1.5 * target_kl``, that update and every later one of the rollout leave
  the train state unchanged. The JAX package selects the whole train state
  with ``jnp.where(trip, old, new)``; here every tensor the update writes
  (parameters, the optimizer's step count, moments and learning rate, and
  ``ts.step``) is copied aside before the step and selected back with
  ``torch.where(trip, old, new, out=new)`` after it, on the device
  (:class:`tianshou_tpu_torch.algorithm.base.Snapshot`): a CUDA graph
  replays the guard with no host branch.
"""

from __future__ import annotations

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import Snapshot, TrainState, optimizer_tensors
from tianshou_tpu_torch.algorithm.modelfree.a2c import A2C
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["PPO"]


class PPO(A2C):
    def __init__(self, actor, critic, action_space, optim=None, eps_clip: float = 0.2, dual_clip: float | None = None,
                 value_clip: bool = False, advantage_normalization: bool = True, recompute_advantage: bool = False,
                 target_kl: float | None = None, **kwargs) -> None:
        super().__init__(actor=actor, critic=critic, action_space=action_space, optim=optim,
                         advantage_normalization=advantage_normalization, **kwargs)
        if dual_clip is not None and not dual_clip > 1.0:
            raise ValueError(f"dual_clip must be above 1, got {dual_clip}")
        self.eps_clip = eps_clip
        self.dual_clip = dual_clip
        self.value_clip = value_clip
        self.recompute_advantage = recompute_advantage
        self.target_kl = target_kl

    # ------------------------------------------------------------------
    def update_rollout(self, ts: TrainState, rollout: Batch, generator: torch.Generator | None, repeat: int,
                       batch_size: int, perm: torch.Tensor | None = None) -> tuple[TrainState, Batch]:
        """As the base class; with ``recompute_advantage`` GAE is recomputed
        before every pass after the first, and the KL guard's trip carries
        over from one pass to the next. The stats are the last pass's, with
        ``n_grad_steps`` counting every pass."""
        if not self.recompute_advantage:
            return super().update_rollout(ts, rollout, generator, repeat, batch_size, perm)
        batch = self.process_rollout(ts, rollout)
        self.update_return_stats(ts, batch)
        if perm is None:
            perm = self.minibatch_indices(batch.rew.shape[0], repeat, batch_size, generator, batch.rew.device)
        stopped = torch.zeros((), dtype=torch.bool, device=batch.rew.device)
        stats = Batch()
        for r in range(perm.shape[0]):
            if r > 0:
                fresh = self.process_rollout(ts, rollout)
                self.update_return_stats(ts, fresh)
                batch.v_s, batch.adv, batch.returns = fresh.v_s, fresh.adv, fresh.returns
            if self.target_kl is None:
                stats = super()._passes(ts, batch, perm[r:r + 1])
            else:
                stats, stopped = self._guarded_passes(ts, batch, perm[r:r + 1], stopped)
        stats.n_grad_steps.fill_(perm.shape[0] * perm.shape[1])
        return ts, stats

    def _passes(self, ts: TrainState, batch: Batch, perm: torch.Tensor) -> Batch:
        if self.target_kl is None:
            return super()._passes(ts, batch, perm)
        return self._guarded_passes(ts, batch, perm, torch.zeros((), dtype=torch.bool, device=perm.device))[0]

    def _guarded_passes(self, ts: TrainState, batch: Batch, perm: torch.Tensor,
                        stopped: torch.Tensor) -> tuple[Batch, torch.Tensor]:
        """The minibatch updates of ``perm``, each under the KL guard;
        ``stopped`` (0-d bool) carries the trip in and out. Returns
        ``(mean stats, stopped)``."""
        threshold = 1.5 * self.target_kl
        # every tensor a minibatch update writes: the parameters, Adam's state and rate, the step counter
        snapshot = Snapshot(optimizer_tensors(ts.optim) + [ts.step])
        stats = []
        for r in range(perm.shape[0]):
            for idx in perm[r]:
                snapshot.take()
                s = self._minibatch_step(ts, batch, idx)
                stopped = stopped | (s.approx_kl > threshold)
                snapshot.restore_where(stopped)
                s.kl_stop = stopped.to(torch.float32)
                stats.append(s)
        return self._mean_stats(stats, perm.shape[0] * perm.shape[1]), stopped

    # ------------------------------------------------------------------
    def loss_minibatch(self, model: nn.Module, mb: Batch) -> tuple[torch.Tensor, Batch]:
        dist = self._dist(model, mb.obs)
        logp = dist.log_prob(mb.act)
        ratio = torch.exp(logp - mb.logp_old)
        surr1 = ratio * mb.adv
        surr2 = ratio.clamp(1.0 - self.eps_clip, 1.0 + self.eps_clip) * mb.adv
        if self.dual_clip is not None:
            clip1 = torch.minimum(surr1, surr2)
            clip2 = torch.maximum(clip1, self.dual_clip * mb.adv)
            clip_loss = -torch.where(mb.adv < 0, clip2, clip1).mean()
        else:
            clip_loss = -torch.minimum(surr1, surr2).mean()
        v = self._value(model, mb.obs)
        if self.value_clip:
            v_clip = mb.v_s + (v - mb.v_s).clamp(-self.eps_clip, self.eps_clip)
            vf_loss = torch.maximum((mb.returns - v) ** 2, (mb.returns - v_clip) ** 2).mean()
        else:
            vf_loss = ((mb.returns - v) ** 2).mean()
        ent = dist.entropy().mean()
        loss = clip_loss + self.vf_coef * vf_loss - self.ent_coef * ent
        return loss, Batch(loss=loss, clip_loss=clip_loss, vf_loss=vf_loss, entropy=ent,
                           approx_kl=(mb.logp_old - logp).mean().detach())
