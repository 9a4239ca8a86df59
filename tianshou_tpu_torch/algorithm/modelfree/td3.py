"""TD3, twin delayed DDPG (port of ``tianshou_tpu/algorithm/modelfree/td3.py``;
reference ``modelfree/td3.py``: ``ActorDualCriticsOffPolicyAlgorithm`` :32
and ``TD3`` :105; arXiv:1802.09477).

Twin critics with the min-Q target, target-policy smoothing
(``clip(N * policy_noise, ±noise_clip)`` added to the target actor's action,
then clipped to [-1, 1]) and the delayed actor update. The JAX package
computes the candidate actor step on every update and selects it with
``jnp.where(step % update_actor_freq == 0, new, old)``, the step count read
before it advances. Here the actor's parameters and Adam state are copied
aside, stepped, and selected back on the device
(:class:`tianshou_tpu_torch.algorithm.base.Snapshot`), so that a CUDA graph
replays both sides of the delay with no host branch. Every target net, the
target actor included, follows by polyak on every step.
"""

from __future__ import annotations

from typing import Any

import torch

from tianshou_tpu_torch.algorithm.base import Draws, Snapshot, TrainState, optimizer_tensors, standard_normal
from tianshou_tpu_torch.algorithm.modelfree.ddpg import DDPG
from tianshou_tpu_torch.data.batch import Batch

__all__ = ["TD3"]


class TD3(DDPG):
    target_keys = ("actor", "critic", "critic2")
    twin_critics = True

    def __init__(self, *args: Any, policy_noise: float = 0.2, noise_clip: float = 0.5, update_actor_freq: int = 2,
                 **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.policy_noise = policy_noise
        self.noise_clip = noise_clip
        self.update_actor_freq = update_actor_freq

    @torch.no_grad()
    def _target_q(self, ts: TrainState, obs_next: Any, generator: torch.Generator | Draws | None) -> torch.Tensor:
        a_next = ts.target["actor"](obs_next)
        noise = (standard_normal(generator, "target", a_next) * self.policy_noise).clamp(-self.noise_clip,
                                                                                         self.noise_clip)
        a_next = (a_next + noise).clamp(-1.0, 1.0)
        return torch.minimum(ts.target["critic"](obs_next, a_next), ts.target["critic2"](obs_next, a_next))

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        weight = batch.get("weight")
        td1 = batch.returns - ts.model["critic"](batch.obs, batch.act)
        td2 = batch.returns - ts.model["critic2"](batch.obs, batch.act)
        c_loss = self._weighted_mean(td1**2 + td2**2, weight)
        self._minimize(ts, c_loss, "critic", "critic2")
        a_loss = -ts.model["critic"](batch.obs, ts.model["actor"](batch.obs)).mean()
        snapshot = Snapshot(optimizer_tensors(ts.optim["actor"]))
        snapshot.take()
        self._minimize(ts, a_loss, "actor")
        snapshot.restore_where(ts.step % self.update_actor_freq != 0)
        ts.step += 1
        self._polyak(ts)
        c_loss = c_loss.detach()
        return ts, Batch(loss=c_loss, actor_loss=a_loss.detach(), critic_loss=c_loss,
                         td_error=((td1 + td2) / 2.0).detach())
