"""PSRL, posterior sampling for tabular RL (port of
``tianshou_tpu/algorithm/modelbased/psrl.py``; reference ``modelbased/psrl.py``:
``PSRLModel`` :24, ``PSRLPolicy`` :163, ``PSRL`` :217; Strens 2000).

The posterior lives in the train state's ``extra``: Dirichlet counts of the
transitions ``trans_count [S, A, S]`` (prior 1), the reward sums and counts
``rew_sum``, ``rew_count [S, A]``, and the greedy ``policy [S]`` with its
``value [S]``. Each ``update_rollout`` adds the rollout's transitions to the
counts (scatter-adds with duplicates: ``index_put_(accumulate=True)`` gives
exact counts), samples a model from the posterior (a Dirichlet draw per
state-action and a normal reward draw), and runs ``value_iterations`` sweeps
of value iteration from the last value, all on the device and in place, so
that the trainer's graph captures the whole update. The observation's first
entry is the state index. Acting reads the policy table. The draws come from
the generator, or from :class:`tianshou_tpu_torch.algorithm.base.Draws`
(``psrl_trans``, ``psrl_rew``): torch's gamma sampler cannot reproduce JAX's.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, Draws, OnPolicyAlgorithm, TrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Discrete
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["PSRL"]


class PSRL(OnPolicyAlgorithm):
    def __init__(
        self,
        n_state: int,
        n_action: int,
        action_space: Discrete,
        gamma: float = 0.99,
        add_done_loop: bool = False,
        value_iterations: int = 100,
        rew_mean_prior: float = 0.0,
        rew_std_prior: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(action_space=action_space, gamma=gamma, **kwargs)
        self.n_state = n_state
        self.n_action = n_action
        self.add_done_loop = add_done_loop
        self.value_iterations = value_iterations
        self.rew_mean_prior = rew_mean_prior
        self.rew_std_prior = rew_std_prior

    def init(self, device: str | torch.device | None = None) -> TrainState:
        """The prior posterior on ``device``; no nets and no optimizer."""
        dev = resolve_device(device)
        S, A = self.n_state, self.n_action
        extra = {
            "trans_count": torch.ones((S, A, S), device=dev),
            "rew_sum": torch.full((S, A), self.rew_mean_prior, device=dev),
            "rew_count": torch.ones((S, A), device=dev),
            "policy": torch.zeros(S, dtype=torch.int64, device=dev),
            "value": torch.zeros(S, device=dev),
        }
        return TrainState(model=nn.ModuleDict(), target=None, optim={}, hparams={},
                          step=torch.zeros((), dtype=torch.int64, device=dev), extra=extra)

    @staticmethod
    def _obs_to_state(obs: torch.Tensor) -> torch.Tensor:
        return obs.reshape(obs.shape[0], -1)[:, 0].to(torch.int64)

    @torch.no_grad()
    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        return ActOut(act=ts.extra["policy"][self._obs_to_state(obs)], state=state, info=Batch())

    def rollout_grad_steps(self, n: int, repeat: int, batch_size: int) -> int:
        return 1  # one posterior update per rollout (the JAX stats' n_grad_steps)

    def sample_posterior(self, ts: TrainState, generator: torch.Generator | Draws | None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """A transition model ``[S, A, S]`` and a reward table ``[S, A]`` drawn
        from the posterior (reference psrl.py:101-117)."""
        x = ts.extra
        if isinstance(generator, Draws):
            trans = generator.psrl_trans.to(x["trans_count"].device)
            noise = generator.psrl_rew.to(x["rew_sum"].device)
        else:
            gamma = torch._standard_gamma(x["trans_count"], generator=generator)
            trans = gamma / gamma.sum(-1, keepdim=True)
            noise = torch.randn(x["rew_sum"].shape, generator=generator, device=x["rew_sum"].device)
        rew = x["rew_sum"] / x["rew_count"] + self.rew_std_prior / torch.sqrt(x["rew_count"]) * noise
        return trans, rew

    def value_iteration(self, trans: torch.Tensor, rew: torch.Tensor, value: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
        """``value_iterations`` sweeps of ``v <- max_a (rew + gamma * trans @ v)``
        from ``value``; returns ``(v, the greedy policy of the last v)``
        (reference psrl.py:163)."""
        v = value
        for _ in range(self.value_iterations):
            v = (rew + self.gamma * (trans @ v)).max(dim=-1).values
        return v, (rew + self.gamma * (trans @ v)).argmax(dim=-1)

    @torch.no_grad()
    def update_rollout(self, ts: TrainState, rollout: Batch, generator: torch.Generator | Draws | None, repeat: int,
                       batch_size: int, perm: torch.Tensor | None = None) -> tuple[TrainState, Batch]:
        """The rollout's counts, a posterior sample and value iteration, in
        place; ``repeat``, ``batch_size`` and ``perm`` are unused."""
        T, E = rollout.rew.shape
        x = ts.extra
        s = self._obs_to_state(rollout.obs.reshape(T * E, -1))
        s_next = self._obs_to_state(rollout.obs_next.reshape(T * E, -1))
        a = rollout.act.reshape(T * E).to(torch.int64)
        ones = torch.ones(T * E, device=s.device)
        x["trans_count"].index_put_((s, a, s_next), ones, accumulate=True)
        x["rew_sum"].index_put_((s, a), rollout.rew.reshape(T * E).to(torch.float32), accumulate=True)
        x["rew_count"].index_put_((s, a), ones, accumulate=True)
        if self.add_done_loop:  # a finished episode loops on its last state under every action
            done = (rollout.terminated | rollout.truncated).reshape(T * E).to(torch.float32)
            actions = torch.arange(self.n_action, device=s.device)
            x["trans_count"].index_put_((s_next[:, None], actions[None, :], s_next[:, None]),
                                        done[:, None].expand(T * E, self.n_action), accumulate=True)
        v, policy = self.value_iteration(*self.sample_posterior(ts, generator), x["value"])
        x["value"].copy_(v)
        x["policy"].copy_(policy)
        ts.step += 1
        return ts, Batch(value_mean=v.mean(), n_grad_steps=torch.ones((), dtype=torch.int32, device=s.device))
