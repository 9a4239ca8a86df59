"""BCQ, batch-constrained deep Q-learning for continuous actions (port of
``tianshou_tpu/algorithm/imitation/bcq.py``; reference ``imitation/bcq.py``:
``BCQPolicy`` :34, ``BCQ`` :119; arXiv:1812.02900).

A conditional VAE models the dataset's actions, a perturbation net nudges
its decoded actions, and twin critics score them. Acting decodes
``forward_sampled_times`` candidates per observation, perturbs them and
takes the one the first critic values most (inside the test collector's
graph on the card). One update, in the JAX package's order:

1. the VAE's step on the reconstruction error plus half the KL term;
2. the critics' step towards ``rew + gamma * (1 - terminated) * max_n q``,
   ``q = lmbda * min(q1', q2') + (1 - lmbda) * max(q1', q2')`` over
   ``num_sampled_action`` candidates of ``obs_next`` decoded by the stepped
   VAE and perturbed by the target actor;
3. the perturbation actor's step on ``-Q1`` of the stepped critic at
   candidates of ``obs`` decoded by the stepped VAE;
4. polyak averaging of the target actor and critics.

Every standard normal the VAE and its decodes take comes from the
generator, or from :class:`tianshou_tpu_torch.algorithm.base.Draws`
(``vae``, ``decode_next``, ``decode_actor``; ``decode`` when acting).
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, Draws, TrainState, standard_normal
from tianshou_tpu_torch.algorithm.modelfree.ddpg import ContinuousOffPolicyBase
from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, OptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Space

__all__ = ["BCQ"]


class BCQ(ContinuousOffPolicyBase):
    run_mode = "offline"
    target_keys = ("actor", "critic", "critic2")
    twin_critics = True

    def __init__(
        self,
        actor_perturbation: nn.Module,  # Perturbation(obs, act) -> act
        critic: nn.Module,              # (obs, act) -> q
        vae: nn.Module,                 # VAE(obs, act, noise) -> (recon, mean, std)
        action_space: Space,
        actor_optim: OptimizerFactory | None = None,
        critic_optim: OptimizerFactory | None = None,
        vae_optim: OptimizerFactory | None = None,
        gamma: float = 0.99,
        tau: float = 0.005,
        lmbda: float = 0.75,
        forward_sampled_times: int = 100,
        num_sampled_action: int = 10,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("exploration_noise", None)  # the JAX class adds none
        super().__init__(actor=actor_perturbation, critic=critic, action_space=action_space, policy_optim=actor_optim,
                         critic_optim=critic_optim, gamma=gamma, tau=tau, **kwargs)
        self.vae = vae
        self.vae_optim = vae_optim if vae_optim is not None else AdamOptimizerFactory(lr=1e-3)
        self.lmbda = lmbda
        self.forward_sampled_times = forward_sampled_times
        self.num_sampled_action = num_sampled_action

    def _nets(self) -> dict[str, nn.Module]:
        return {**super()._nets(), "vae": copy.deepcopy(self.vae)}

    def _factory(self, key: str) -> OptimizerFactory:
        return self.vae_optim if key == "vae" else super()._factory(key)

    def _decoded(self, ts: TrainState, obs: torch.Tensor, source: torch.Generator | Draws | None,
                 field: str) -> torch.Tensor:
        """The VAE's decode of ``obs`` at the latent of standard normals drawn
        from ``source`` (or its ``field``)."""
        vae = ts.model["vae"]
        noise = standard_normal(source, field, obs.new_empty((obs.shape[0], vae.latent_dim), dtype=torch.float32))
        return vae.decode(obs, vae.latent(noise))

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | Draws | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        """``forward_sampled_times`` perturbed candidates per observation, the
        first critic's best (reference bcq.py:76)."""
        B, n = obs.shape[0], self.forward_sampled_times
        obs_rep = obs.repeat_interleave(n, dim=0)
        act = ts.model["actor"](obs_rep, self._decoded(ts, obs_rep, generator, "decode"))
        best = ts.model["critic"](obs_rep, act).reshape(B, n).argmax(dim=-1)
        act = act.reshape(B, n, -1)
        return ActOut(act=act.gather(1, best[:, None, None].expand(B, 1, act.shape[-1]))[:, 0], state=state,
                      info=Batch())

    def preprocess(self, ts: TrainState, buffer, buf_state, batch: Batch, indices: torch.Tensor,
                   generator: torch.Generator | Draws | None = None) -> Batch:
        """None: the critics' target is the update's own (the JAX class has no preprocess)."""
        return batch

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | Draws | None = None) -> tuple[TrainState, Batch]:
        B, n = batch.obs.shape[0], self.num_sampled_action
        # 1. the VAE (reference bcq.py:146)
        vae = ts.model["vae"]
        noise = standard_normal(generator, "vae", batch.obs.new_empty((B, vae.latent_dim), dtype=torch.float32))
        recon, mean, std = vae(batch.obs, batch.act, noise)
        kl = (-torch.log(std) + (std**2 + mean**2 - 1) / 2).sum(-1).mean()
        vae_loss = ((recon - batch.act) ** 2).sum(-1).mean() + kl / 2.0
        self._minimize(ts, vae_loss, "vae")
        # 2. the critics, towards the best of n candidates of obs_next (reference bcq.py:160)
        with torch.no_grad():
            obs_next_rep = batch.obs_next.repeat_interleave(n, dim=0)
            a_next = ts.target["actor"](obs_next_rep, self._decoded(ts, obs_next_rep, generator, "decode_next"))
            q1_t = ts.target["critic"](obs_next_rep, a_next)
            q2_t = ts.target["critic2"](obs_next_rep, a_next)
            q_t = self.lmbda * torch.minimum(q1_t, q2_t) + (1 - self.lmbda) * torch.maximum(q1_t, q2_t)
            q_t = q_t.reshape(B, n).max(dim=-1).values
            target = batch.rew + self.gamma * (1.0 - batch.terminated.to(torch.float32)) * q_t
        c_loss = ((ts.model["critic"](batch.obs, batch.act) - target) ** 2).mean() \
            + ((ts.model["critic2"](batch.obs, batch.act) - target) ** 2).mean()
        self._minimize(ts, c_loss, "critic", "critic2")
        # 3. the perturbation actor (reference bcq.py:186)
        with torch.no_grad():
            dec = self._decoded(ts, batch.obs, generator, "decode_actor")
        a_loss = -ts.model["critic"](batch.obs, ts.model["actor"](batch.obs, dec)).mean()
        self._minimize(ts, a_loss, "actor")
        ts.step += 1
        self._polyak(ts)
        return ts, Batch(loss=c_loss.detach(), actor_loss=a_loss.detach(), vae_loss=vae_loss.detach())
