"""The multi-agent dispatcher (port of
``tianshou_tpu/algorithm/multiagent/marl.py``; reference
``tianshou/algorithm/multiagent/marl.py``: ``MultiAgentPolicy`` :74,
dispatch by ``obs.agent_id``; ``MARLDispatcher`` :188, the per-agent reward
column; ``MultiAgentOff/OnPolicyAlgorithm`` :268, :311).

As in the JAX package every agent updates on the FULL batch with a 0/1
dispatch weight (``agent_id == agent``) in place of the reference's slicing
of each agent's rows: the same gradients at static shapes, so that the whole
multi-agent update is one CUDA graph on the card. Each agent's targets run
through its own ``preprocess`` (n-step chains over the shared ring, PER
weights) on a per-agent reward view of the buffer state, and its
``postprocess`` writes PER priorities into the shared tree.

The train state is a dict ``{"agent0": TrainState, ...}``, as the JAX
package's; each agent's update writes its own state in place, and
:meth:`MultiAgentOffPolicyAlgorithm.update` returns the same dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.base import ActOut, Draws, OffPolicyAlgorithm, OnPolicyAlgorithm, TrainState
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.models.distributions import Categorical
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["MultiAgentOffPolicyAlgorithm", "MultiAgentOnPolicyAlgorithm", "MARLRandomPolicy"]


class _Dispatch:
    """Acting that both dispatchers share: each agent acts on every row and
    the ``agent_id`` column selects (reference MultiAgentPolicy:74)."""

    algorithms: list

    def init(self, device: str | torch.device | None = None) -> dict:
        return {f"agent{i}": algo.init(device) for i, algo in enumerate(self.algorithms)}

    @torch.no_grad()
    def forward(self, ts: dict, obs: Batch, generator: torch.Generator | None = None, state: Any = None,
                deterministic: bool = False) -> ActOut:
        acts = None
        for i, algo in enumerate(self.algorithms):
            act = algo.forward(ts[f"agent{i}"], obs, generator, deterministic=deterministic).act
            acts = act if acts is None else torch.where(obs.agent_id == i, act, acts)
        return ActOut(act=acts, state=state, info=Batch())

    def exploration_noise(self, ts: dict, act: torch.Tensor, obs: Batch, generator: torch.Generator,
                          training: bool = True) -> torch.Tensor:
        for i, algo in enumerate(self.algorithms):
            noisy = algo.exploration_noise(ts[f"agent{i}"], act, obs, generator, training)
            act = torch.where(obs.agent_id == i, noisy, act)
        return act

    def map_action(self, act: torch.Tensor) -> torch.Tensor:
        return act


class MultiAgentOffPolicyAlgorithm(_Dispatch, OffPolicyAlgorithm):
    """``algorithms``: one off-policy algorithm per agent (index = agent_id).
    Observations are Batches with keys ``agent_id``, ``obs`` and ``mask``;
    rewards are ``[..., n_agents]`` vectors."""

    def __init__(self, algorithms: list[OffPolicyAlgorithm], action_space, **kwargs) -> None:
        super().__init__(action_space=action_space, **kwargs)
        self.algorithms = algorithms
        self.n_agents = len(algorithms)

    @staticmethod
    def _agent_reward_view(buf_state, agent: int):
        """The buffer state with ``rew`` replaced by the agent's reward column,
        a strided view of the shared ring; every other tensor, a PER tree
        included, is the shared one (the reference MARLDispatcher's buffer
        view, marl.py:188)."""

        def fix(state):
            data = state.data.copy()
            data.rew = state.data.rew[..., agent]
            return dataclasses.replace(state, data=data)

        if hasattr(buf_state, "base"):
            return dataclasses.replace(buf_state, base=fix(buf_state.base))
        return fix(buf_state)

    def update(self, ts: dict, buffer, buf_state, generator: torch.Generator | Draws,
               batch_size: int) -> tuple[dict, Any, Batch]:
        """Sample once and dispatch to every agent with masked weights
        (reference MARLDispatcher.dispatch_update, marl.py:205): each agent's
        own ``preprocess`` over its reward view, its weight ``is_mine`` times
        the PER weight, its ``update_step``, and its ``postprocess`` into the
        shared state, all in place. With :class:`Draws` the buffer takes
        ``generator.indices`` and every agent gets the draws."""
        rows = generator.indices if isinstance(generator, Draws) else generator
        batch, indices = buffer.sample(buf_state, rows, batch_size)
        stats = Batch()
        for i, algo in enumerate(self.algorithms):
            sub_ts = ts[f"agent{i}"]
            b = batch.copy()
            b.rew = batch.rew[:, i]
            is_mine = (batch.obs.agent_id == i).to(torch.float32)
            b = algo.preprocess(sub_ts, buffer, self._agent_reward_view(buf_state, i), b, indices, generator)
            weight = b.get("weight")
            b.weight = is_mine if weight is None else is_mine * weight
            sub_ts, stats[f"agent{i}"] = algo.update_step(sub_ts, b, generator)
            buf_state = algo.postprocess(sub_ts, buffer, buf_state, b, indices, stats[f"agent{i}"])
        return ts, buf_state, stats


class MultiAgentOnPolicyAlgorithm(_Dispatch, OnPolicyAlgorithm):
    """The on-policy dispatcher (reference MultiAgentOnPolicyAlgorithm,
    marl.py:311): each agent runs its own GAE and minibatch loop over the
    SHARED rollout, with its reward column and its advantage zeroed on the
    steps where another agent acted, so that its actor learns only from its
    own decisions while its critic learns every game state's value. Each
    agent's ``process_rollout``, ``update_return_stats`` and
    ``run_minibatch_updates`` are called directly, as the JAX package does
    (not the agent's own ``update_rollout``)."""

    def __init__(self, algorithms: list, action_space) -> None:
        super().__init__(action_space=action_space)
        self.algorithms = algorithms
        self.n_agents = len(algorithms)

    def rollout_grad_steps(self, n: int, repeat: int, batch_size: int) -> int:
        return self.algorithms[0].rollout_grad_steps(n, repeat, batch_size) * self.n_agents

    def update_rollout(self, ts: dict, rollout: Batch, generator: torch.Generator | None, repeat: int,
                       batch_size: int, perm: Any = None) -> tuple[dict, Batch]:
        """In place; ``perm``: each agent's minibatch indices (a sequence of
        ``[repeat, n_mb, mb_size]``), drawn from ``generator`` when None."""
        stats = Batch()
        for i, algo in enumerate(self.algorithms):
            sub_ts = ts[f"agent{i}"]
            r = rollout.copy()
            r.rew = rollout.rew[..., i]
            batch = algo.process_rollout(sub_ts, r)
            algo.update_return_stats(sub_ts, batch)
            batch.adv = batch.adv * (rollout.obs.agent_id == i).reshape(batch.adv.shape).to(torch.float32)
            _, stats[f"agent{i}"] = algo.run_minibatch_updates(sub_ts, batch, repeat, batch_size, generator,
                                                               None if perm is None else perm[i])
        stats.n_grad_steps = stats["agent0"].n_grad_steps * self.n_agents
        return ts, stats


class MARLRandomPolicy(OffPolicyAlgorithm):
    """A mask-aware uniform random agent (reference algorithm/random.py:17):
    no parameters, no update."""

    def __init__(self, action_space, **kwargs) -> None:
        super().__init__(action_space=action_space, **kwargs)

    def init(self, device: str | torch.device | None = None) -> TrainState:
        dev = resolve_device(device)
        return TrainState(model=nn.ModuleDict(), target=None, optim={}, hparams={},
                          step=torch.zeros((), dtype=torch.int64, device=dev))

    @torch.no_grad()
    def forward(self, ts, obs: Batch, generator: torch.Generator | None = None, state: Any = None,
                deterministic: bool = False) -> ActOut:
        """A uniform draw over the valid actions (Gumbel-max of logits 0 where
        valid and ``-inf`` elsewhere, as ``jax.random.categorical``)."""
        mask = obs.mask if "mask" in obs else torch.ones((obs.agent_id.shape[0], self.action_space.n), dtype=torch.bool,
                                                         device=obs.agent_id.device)
        u = torch.rand(mask.shape, generator=generator, device=mask.device)
        act = Categorical(logits=torch.where(mask, 0.0, -torch.inf)).from_noise(u.clamp_(min=torch.finfo(u.dtype).tiny))
        return ActOut(act=act, state=state, info=Batch())

    def update_step(self, ts, batch: Batch, generator=None):
        return ts, Batch()

    def _target_q(self, ts, obs_next: Batch, generator=None) -> torch.Tensor:
        return torch.zeros(obs_next.agent_id.shape[0], device=obs_next.agent_id.device)
