"""Shared on-policy actor(-critic) machinery (port of
``tianshou_tpu/algorithm/modelfree/onpolicy.py``; reference
``ProbabilisticActorPolicy``, modelfree/reinforce.py:68, and
``ActorCriticOnPolicyAlgorithm``, modelfree/a2c.py:32).

A rollout never enters a replay buffer: the collector's time-major
``[T, E]`` transitions feed GAE (or Monte-Carlo returns) directly, and
:meth:`OnPolicyActorCritic.update_rollout` then takes ``repeat`` passes of
shuffled minibatches over the flattened batch, in place. The JAX package
jits this as one program (nested ``lax.scan``); here it is a Python loop
over the minibatches that the trainer captures as one CUDA graph, so
nothing in it reads a device value on the host:

- the minibatch indices (``[repeat, n_mb, mb_size]``) are drawn on the
  device up front by :meth:`OnPolicyActorCritic.minibatch_indices`, the
  argsort of float64 uniforms (``jax.random.permutation`` cannot be
  reproduced; a test hands JAX's draw over through ``perm``);
- the return statistics (``ts.extra``) and every counter are 0-d device
  tensors written in place;
- ``jnp.std``/``jnp.var`` divide by N, so every variance here is taken with
  ``correction=0``.

The train state's ``model`` is a ``ModuleDict`` of ``actor`` and, where
there is one, ``critic``, stepped by one optimizer over both, as the JAX
package's one optax chain over ``{"actor", "critic"}``.

gSDE (an actor with ``sde=True``, arXiv:2005.05719): the collector carries
the policy state ``Batch(eps [E, F, A] standard normals, count [E] int32
steps since the last resample)``. :meth:`OnPolicyActorCritic.forward` draws
fresh noise every step, keeps it where ``count % sde_sample_freq == 0`` and
the carried noise elsewhere, and acts with ``mu + feat^T (eps *
exp(log_sigma_mat))``, marginally ``Normal(mu, sigma(s))``, which
``process_rollout`` and the losses use. The state restarts (fresh noise,
count 0) where an episode ends and is drawn anew at the start of every
collect chunk, all written in place, so a captured chunk replays it. The
initial state is zeros: its noise is resampled at the first step (count 0).
"""

from __future__ import annotations

import copy
from typing import Any

import torch
from torch import nn
from torch.func import functional_call

from tianshou_tpu_torch.algorithm.base import ActOut, OnPolicyAlgorithm, TrainState
from tianshou_tpu_torch.algorithm.optim import init_adam_state
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Discrete, Space
from tianshou_tpu_torch.models.distributions import Categorical, Normal
from tianshou_tpu_torch.ops.returns import gae_advantages, mc_return_to_go
from tianshou_tpu_torch.utils.data_parallel import active_data_parallel
from tianshou_tpu_torch.utils.device import resolve_device
from tianshou_tpu_torch.utils.graph import graphed_step
from tianshou_tpu_torch.utils.tree import tree_leaves

__all__ = ["OnPolicyActorCritic"]


class OnPolicyActorCritic(OnPolicyAlgorithm):
    def __init__(
        self,
        actor: nn.Module,
        critic: nn.Module | None,
        action_space: Space,
        optim=None,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        return_standardization: bool = False,
        advantage_normalization: bool = False,
        ent_coef: float = 0.0,
        vf_coef: float = 0.5,
        deterministic_eval: bool = False,
        sde_sample_freq: int = 4,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("action_scaling", not isinstance(action_space, Discrete))
        super().__init__(action_space=action_space, gamma=gamma, optim=optim, **kwargs)
        self.actor = actor
        self.critic = critic
        self.gae_lambda = gae_lambda
        self.return_standardization = return_standardization
        self.advantage_normalization = advantage_normalization
        self.ent_coef = ent_coef
        self.vf_coef = vf_coef
        self.deterministic_eval = deterministic_eval
        # gSDE's resample cadence in env steps: a rollout-frozen eps would leave
        # an update only num_envs noise draws (arXiv:2005.05719)
        self.sde_sample_freq = sde_sample_freq

    # ------------------------------------------------------------------
    def init(self, device: str | torch.device | None = None) -> TrainState:
        """A fresh TrainState on ``device``: copies of the actor and the
        critic in one ``ModuleDict``, one optimizer over both with its state
        made now (the KL guard snapshots it from the first update on), and,
        with ``return_standardization``, the running return statistics
        (reference A2C ``ret_rms``, a2c.py:112)."""
        dev = resolve_device(device)
        nets = {"actor": copy.deepcopy(self.actor)}
        if self.critic is not None:
            nets["critic"] = copy.deepcopy(self.critic)
        model = nn.ModuleDict(nets).to(dev)
        optim = self.optim.create(model.parameters())
        if isinstance(optim, torch.optim.Adam):
            init_adam_state(optim)

        def scalar(v: float) -> torch.Tensor:
            return torch.full((), v, dtype=torch.float32, device=dev)

        extra = {}
        if self.return_standardization:
            extra = {"ret_mean": scalar(0.0), "ret_var": scalar(1.0), "ret_count": scalar(1e-4)}
        return TrainState(model=model, target=None, optim=optim, hparams={},
                          step=torch.zeros((), dtype=torch.int64, device=dev), extra=extra)

    # ------------------------------------------------------------------
    @property
    def _sde(self) -> bool:
        """A gSDE actor: it returns ``(mu, sigma(s), feat)``."""
        return bool(getattr(self.actor, "sde", False))

    def _dist(self, model: nn.Module, obs: torch.Tensor) -> Categorical | Normal:
        return self._actor_dist(model["actor"], obs)

    def _actor_dist(self, actor: nn.Module, obs: torch.Tensor,
                    params: dict[str, torch.Tensor] | None = None) -> Categorical | Normal:
        """The policy of ``actor``, evaluated at ``params`` in place of its own
        parameters when given (TRPO's line search); a gSDE actor's is the
        marginal ``Normal(mu, sigma(s))``."""
        out = actor(obs) if params is None else functional_call(actor, params, (obs,))
        if self.is_discrete:
            return Categorical(logits=out)
        return Normal(loc=out[0], scale=out[1])

    def _dist_from_batch(self, b: Batch) -> Categorical | Normal:
        """The rollout's policy from the ``dist_old`` that ``process_rollout`` stores."""
        return Categorical(logits=b.logits) if self.is_discrete else Normal(loc=b.loc, scale=b.scale)

    def _value(self, model: nn.Module, obs: torch.Tensor) -> torch.Tensor:
        v = model["critic"](obs)
        return v.reshape(v.shape[0])

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        """A sample of the policy, or its mode when ``deterministic`` and
        ``deterministic_eval``. A gSDE actor with a carried ``state`` acts
        with its noise and returns the advanced state; without one it samples
        the marginal ``Normal(mu, sigma(s))`` (one-shot inference)."""
        if self._sde and not self.is_discrete:
            mu, sigma, feat = ts.model["actor"](obs)
            if deterministic and self.deterministic_eval:
                act = mu
            elif state is None:
                act = Normal(loc=mu, scale=sigma).sample(generator)
            else:
                n = state.eps.shape[0]
                fresh = self._sde_eps(n, generator, mu.device)
                resample = (state.count % self.sde_sample_freq) == 0
                eps = torch.where(resample.reshape(n, 1, 1), fresh, state.eps)
                # einsum("bf,bfa,fa->ba", feat, eps, exp(clip(log_sigma_mat, -20, 2)))
                sig_mat = torch.exp(ts.model["actor"].log_sigma_mat.clamp(-20.0, 2.0))
                act = mu + torch.einsum("bf,bfa->ba", feat, eps * sig_mat)
                state = Batch(eps=eps, count=state.count + 1)
            return ActOut(act=act, state=state, info=Batch())
        dist = self._dist(ts.model, obs)
        act = dist.mode() if deterministic and self.deterministic_eval else dist.sample(generator)
        return ActOut(act=act, state=state, info=Batch())

    # ------------------------------------------------------------------
    # gSDE's noise state (the collector's policy-state hooks, algorithm/base.py)
    def _sde_shape(self, num_envs: int) -> tuple[int, int, int]:
        """``[E, F, A]``, ``F`` the actor's last hidden width."""
        return num_envs, self.actor.hidden_sizes[-1], self.actor.action_dim

    def _sde_eps(self, num_envs: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
        """``[E, F, A]`` standard normals."""
        return torch.randn(self._sde_shape(num_envs), generator=generator, device=device)

    def _sde_noise(self, num_envs: int, generator: torch.Generator, device: torch.device) -> Batch:
        return Batch(eps=self._sde_eps(num_envs, generator, device),
                     count=torch.zeros(num_envs, dtype=torch.int32, device=device))

    def init_policy_state(self, num_envs: int, device: str | torch.device | None = None) -> Any:
        if not self._sde:
            return super().init_policy_state(num_envs, device)
        dev = resolve_device(device)
        return Batch(eps=torch.zeros(self._sde_shape(num_envs), device=dev),
                     count=torch.zeros(num_envs, dtype=torch.int32, device=dev))

    def reset_policy_state(self, num_envs: int, generator: torch.Generator,
                           device: str | torch.device | None = None) -> Any:
        if not self._sde:
            return super().reset_policy_state(num_envs, generator, device)
        # an episode's end restarts the resample schedule; the noise is drawn, as the JAX package draws it
        return self._sde_noise(num_envs, generator, resolve_device(device))

    def refresh_policy_state(self, state: Any, num_envs: int, generator: torch.Generator) -> Any:
        if not self._sde or state is None:
            return state
        return self._sde_noise(num_envs, generator, state.eps.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def process_rollout(self, ts: TrainState, rollout: Batch) -> Batch:
        """Time-major rollout ``[T, E]`` -> flat training batch with targets
        (reference ``_add_returns_and_advantages``, a2c.py:115): GAE with
        truncation-aware bootstrapping, the chain cut at the rollout's last
        step (algorithm_base.py:676-690); with ``return_standardization`` the
        critic works in running-std-scaled space (no mean subtraction), so
        its values are un-scaled for GAE and the targets re-scaled. Adds the
        old log-probabilities and distribution parameters."""
        T, E = rollout.rew.shape

        def flat(x: Any) -> Any:  # merge the [T, E] axes (a Batch observation leaf by leaf)
            return x.map(flat) if isinstance(x, Batch) else x.reshape(T * E, *x.shape[2:])

        obs = flat(rollout.obs)
        term = rollout.terminated.to(torch.float32)
        end = torch.maximum(term, rollout.truncated.to(torch.float32))
        end[-1] = 1.0  # cut the chain at the rollout boundary
        batch = Batch(obs=obs, act=flat(rollout.act), rew=rollout.rew.reshape(T * E))
        if self.critic is not None:
            v_s = self._value(ts.model, obs).reshape(T, E)
            v_s_ = self._value(ts.model, flat(rollout.obs_next)).reshape(T, E)
            batch.v_s = v_s.reshape(T * E)
            if self.return_standardization:
                scale = torch.sqrt(ts.extra["ret_var"] + 1e-8)
                adv = gae_advantages(rollout.rew, v_s * scale, v_s_ * scale, term, end, self.gamma, self.gae_lambda)
                unnorm = adv + v_s * scale
                batch.returns = (unnorm / scale).reshape(T * E)
                batch.unnorm_returns = unnorm.reshape(T * E)
            else:
                adv = gae_advantages(rollout.rew, v_s, v_s_, term, end, self.gamma, self.gae_lambda)
                batch.returns = (adv + v_s).reshape(T * E)
            batch.adv = adv.reshape(T * E)
        else:
            r = mc_return_to_go(rollout.rew, self.gamma, end).reshape(T * E)
            if self.return_standardization:
                # REINFORCE standardizes with the running statistics (reference reinforce.py:249)
                batch.unnorm_returns = r
                r = (r - ts.extra["ret_mean"]) / torch.sqrt(ts.extra["ret_var"] + 1e-8)
            batch.returns = batch.adv = r
        dist = self._dist(ts.model, obs)
        batch.logp_old = dist.log_prob(batch.act)
        batch.dist_old = (Batch(logits=dist.logits) if self.is_discrete
                          else Batch(loc=dist.loc, scale=dist.scale.expand_as(dist.loc)))
        return batch

    def update_return_stats(self, ts: TrainState, batch: Batch) -> TrainState:
        """Parallel-Welford merge of the rollout's unscaled returns into the
        running statistics, in place (reference ``ret_rms.update``,
        a2c.py:149); pops ``unnorm_returns`` off the batch."""
        if "unnorm_returns" not in batch:
            return ts
        x = batch.pop("unnorm_returns")
        m, v, c = ts.extra["ret_mean"], ts.extra["ret_var"], ts.extra["ret_count"]
        dp = active_data_parallel()  # inside a mesh step: the whole rollout's statistics, over every rank
        bm, bv = (x.mean(), x.var(correction=0)) if dp is None else dp.moments(x)
        bc = float(x.shape[0] if dp is None else dp.rows(x.shape[0]))
        delta = bm - m
        tot = c + bc
        new_mean = m + delta * bc / tot
        m2 = v * c + bv * bc + delta * delta * c * bc / tot
        m.copy_(new_mean)
        v.copy_(m2 / tot)
        c.copy_(tot)
        return ts

    # ------------------------------------------------------------------
    def loss_minibatch(self, model: nn.Module, mb: Batch) -> tuple[torch.Tensor, Batch]:
        """Per algorithm: ``(scalar loss, stats Batch of 0-d tensors)``."""
        raise NotImplementedError

    def _update_minibatch(self, ts: TrainState, mb: Batch) -> Batch:
        """One gradient step on :meth:`loss_minibatch`, in place."""
        loss, stats = self.loss_minibatch(ts.model, mb)
        ts.optim.zero_grad(set_to_none=True)
        loss.backward()
        self.optim.step(ts.optim)
        ts.step += 1
        dp = active_data_parallel()  # inside a mesh step: the whole minibatch's stats, the KL guard's too
        return stats.map(torch.Tensor.detach) if dp is None else dp.reduce_stats(stats.map(torch.Tensor.detach))

    def _minibatch_step(self, ts: TrainState, batch: Batch, idx: torch.Tensor) -> Batch:
        """:meth:`_update_minibatch` on rows ``idx`` of ``batch``; inside a
        :class:`~tianshou_tpu_torch.utils.graph.StepGraphs` block (a long
        rollout's update on the card) a replay of its CUDA graph."""
        return graphed_step(self, (ts, *tree_leaves(batch)),
                            lambda i: self._update_minibatch(ts, self._minibatch(batch, i)), idx)

    def rollout_grad_steps(self, n: int, repeat: int, batch_size: int) -> int:
        """``repeat`` passes of ``minibatch_shape``'s minibatches."""
        return repeat * self.minibatch_shape(n, batch_size)[0]

    @staticmethod
    def minibatch_shape(n: int, batch_size: int) -> tuple[int, int]:
        """``(n_mb, mb_size)`` for ``n`` rows: ``max(1, n // batch_size)``
        minibatches of ``n // n_mb`` rows; the rest of a pass is dropped."""
        n_mb = max(1, n // batch_size)
        return n_mb, n // n_mb

    def minibatch_indices(self, n: int, repeat: int, batch_size: int, generator: torch.Generator,
                          device: torch.device) -> torch.Tensor:
        """``[repeat, n_mb, mb_size]`` int64 row indices, one shuffle of the
        ``n`` rows per pass, drawn on ``device`` with no host sync."""
        n_mb, mb_size = self.minibatch_shape(n, batch_size)
        keys = torch.rand((repeat, n), dtype=torch.float64, generator=generator, device=device)
        return keys.argsort(dim=1)[:, : n_mb * mb_size].reshape(repeat, n_mb, mb_size)

    def _minibatch(self, batch: Batch, idx: torch.Tensor) -> Batch:
        """Rows ``idx`` of ``batch``; inside a mesh step this rank's share of
        the global rows, fetched from the ranks that hold them, and normalised
        by the whole minibatch's statistics."""
        dp = active_data_parallel()
        mb = batch[idx] if dp is None else dp.rollout_rows(batch, idx)
        if self.advantage_normalization:
            mean, std = (mb.adv.mean(), mb.adv.std(correction=0)) if dp is None else dp.mean_std(mb.adv)
            mb.adv = (mb.adv - mean) / (std + 1e-8)
        return mb

    @staticmethod
    def _rows(batch: Batch) -> int:
        """The processed batch's row count; inside a mesh step, every rank's."""
        dp = active_data_parallel()
        n = batch.rew.shape[0]
        return n if dp is None else dp.rows(n)

    @staticmethod
    def _mean_stats(stats: list[Batch], n_grad_steps: int) -> Batch:
        """Each statistic averaged over the minibatches, and ``n_grad_steps``."""
        out = Batch({k: torch.stack([s[k] for s in stats]).mean() for k in stats[0].keys()})
        out.n_grad_steps = torch.full((), n_grad_steps, dtype=torch.int32, device=stats[0].loss.device)
        return out

    def update_rollout(self, ts: TrainState, rollout: Batch, generator: torch.Generator | None, repeat: int,
                       batch_size: int, perm: torch.Tensor | None = None) -> tuple[TrainState, Batch]:
        """``repeat`` passes of shuffled minibatches over the processed
        rollout, in place (reference ``OnPolicyAlgorithm.update`` +
        ``_update_with_batch``). ``perm``: the minibatch indices
        (``[repeat, n_mb, mb_size]``); drawn from ``generator`` when None.
        Returns ``(ts, stats)``: the minibatch statistics averaged, and
        ``n_grad_steps``."""
        batch = self.process_rollout(ts, rollout)
        self.update_return_stats(ts, batch)
        return self.run_minibatch_updates(ts, batch, repeat, batch_size, generator, perm)

    def run_minibatch_updates(self, ts: TrainState, batch: Batch, repeat: int, batch_size: int,
                              generator: torch.Generator | None = None,
                              perm: torch.Tensor | None = None) -> tuple[TrainState, Batch]:
        """The ``repeat`` x minibatch loop over an already processed batch."""
        if perm is None:
            perm = self.minibatch_indices(self._rows(batch), repeat, batch_size, generator, batch.rew.device)
        return ts, self._passes(ts, batch, perm)

    def _passes(self, ts: TrainState, batch: Batch, perm: torch.Tensor) -> Batch:
        """One update per minibatch of ``perm``, in order; the averaged stats."""
        stats = [self._minibatch_step(ts, batch, idx) for r in range(perm.shape[0]) for idx in perm[r]]
        return self._mean_stats(stats, perm.shape[0] * perm.shape[1])
