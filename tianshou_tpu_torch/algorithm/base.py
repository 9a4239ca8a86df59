"""Algorithm/Policy base abstractions (port of ``tianshou_tpu/algorithm/base.py``;
reference ``tianshou/algorithm/algorithm_base.py``).

The JAX package keeps all mutable state in a ``TrainState`` pytree and makes
every method a pure function of it. Here :class:`TrainState` holds the live
objects (online module, target module, optimizer, step counter, dynamic
hyper-parameters) and :meth:`Algorithm.update_step` updates them in place,
returning the same state. The step counter and the hyper-parameters are 0-d
tensors on the model's device, as the JAX package keeps them in its pytree:
a CUDA graph captured over an update reads them where they live, where a
host number would be captured as a constant.

- ``Algorithm.forward(ts, obs, generator)``        <- Policy.forward
- ``Algorithm.init(device) -> TrainState``         <- nn.Module + optimizer ctor
- ``Algorithm.preprocess / update_step``           <- _preprocess_batch / _update_with_batch
- ``Algorithm.update``                             <- Algorithm._update (:586)
- ``Algorithm.map_action``                         <- Policy.map_action (:254): clip or tanh, then scaling
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch import nn

from tianshou_tpu_torch.algorithm.optim import AdamOptimizerFactory, OptimizerFactory
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.env.core import Box, Discrete, Space
from tianshou_tpu_torch.ops.returns import nstep_returns, value_mask

__all__ = ["ActOut", "Algorithm", "OffPolicyAlgorithm", "OnPolicyAlgorithm", "TrainState"]


@dataclasses.dataclass
class TrainState:
    """All mutable algorithm state. ``step`` counts gradient steps; it and
    every value of ``hparams`` are 0-d tensors on the model's device, written
    in place (the trainer's ``gradient_step`` is the host's mirror of ``step``)."""

    model: nn.Module                    # online network (on-policy: a ModuleDict of actor and critic)
    target: nn.Module | None            # lagged copy (None without a target net)
    optim: torch.optim.Optimizer
    hparams: dict[str, torch.Tensor]    # dynamic knobs the trainer anneals (eps, ...), 0-d float32
    step: torch.Tensor                  # 0-d int64
    #: algorithm-specific carried state, 0-d tensors written in place (the return statistics)
    extra: dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


class ActOut(NamedTuple):
    act: torch.Tensor   # raw policy output (pre map_action)
    state: Any          # recurrent state (None if stateless)
    info: Batch         # logits / q values as needed


class Algorithm:
    """Base for all algorithms. Static config lives on ``self``; everything
    that changes during training lives in :class:`TrainState`."""

    #: buffer fields to skip when sampling inside :meth:`update`, for
    #: algorithms whose preprocess/update_step never read them
    update_sample_drop_keys: tuple[str, ...] = ()

    def __init__(
        self,
        action_space: Space,
        gamma: float = 0.99,
        optim: OptimizerFactory | None = None,
        action_scaling: bool = False,
        action_bound_method: str | None = "clip",  # "clip" | "tanh" | None
    ) -> None:
        if action_bound_method not in ("clip", "tanh", None):
            raise ValueError(f"action_bound_method must be 'clip', 'tanh' or None, got {action_bound_method!r}")
        self.action_space = action_space
        self.gamma = gamma
        self.optim = optim if optim is not None else AdamOptimizerFactory(lr=1e-3)
        self.action_scaling = action_scaling
        self.action_bound_method = action_bound_method
        self.is_discrete = isinstance(action_space, Discrete)

    # ------------------------------------------------------------------
    def init(self, device: str | torch.device | None = None) -> TrainState:
        raise NotImplementedError

    def forward(self, ts: TrainState, obs: Any, generator: torch.Generator | None = None,
                state: Any = None, deterministic: bool = False) -> ActOut:
        raise NotImplementedError

    def exploration_noise(self, ts: TrainState, act: torch.Tensor, obs: Any,
                          generator: torch.Generator, training: bool = True) -> torch.Tensor:
        """Exploration hook (reference Policy.add_exploration_noise :354),
        called by collectors in both train and eval mode."""
        return act

    def init_policy_state(self, num_envs: int) -> Any:
        return None

    def map_action(self, act: torch.Tensor) -> torch.Tensor:
        """Raw policy output -> env action (reference Policy.map_action :254):
        a continuous action is clipped to [-1, 1] (or squashed by tanh), then
        with ``action_scaling`` mapped affinely onto the Box's bounds.
        Discrete actions pass unchanged."""
        if self.is_discrete:
            return act
        if self.action_bound_method == "clip":
            act = act.clamp(-1.0, 1.0)
        elif self.action_bound_method == "tanh":
            act = torch.tanh(act)
        if self.action_scaling and isinstance(self.action_space, Box):
            low, high = self.action_space.bounds(act.device)
            act = low + (high - low) * (act + 1.0) / 2.0
        return act

    def map_action_inverse(self, act: torch.Tensor) -> torch.Tensor:
        """The inverse of :meth:`map_action` for env actions (reference :289)."""
        if self.is_discrete:
            return act
        if self.action_scaling and isinstance(self.action_space, Box):
            low, high = self.action_space.bounds(act.device)
            act = 2.0 * (act - low) / (high - low) - 1.0
        if self.action_bound_method == "tanh":
            eps = 1e-6
            act = torch.atanh(act.clamp(-1 + eps, 1 - eps))
        return act

    # ------------------------------------------------------------------
    def preprocess(self, ts: TrainState, buffer, buf_state, batch: Batch,
                   indices: torch.Tensor, generator: torch.Generator) -> Batch:
        """Compute targets before the gradient step (n-step / GAE)."""
        return batch

    def update_step(self, ts: TrainState, batch: Batch,
                    generator: torch.Generator | None = None) -> tuple[TrainState, Batch]:
        """One gradient step, in place; returns (ts, loss stats Batch).
        ``generator`` draws what the step samples (noisy-net noise)."""
        raise NotImplementedError

    def postprocess(self, ts: TrainState, buffer, buf_state, batch: Batch,
                    indices: torch.Tensor, stats: Batch):
        """Write back per-sample info (PER priorities). Returns buf_state."""
        return buf_state

    def update(self, ts: TrainState, buffer, buf_state, generator: torch.Generator,
               batch_size: int) -> tuple[TrainState, Any, Batch]:
        """sample -> preprocess -> update_step -> postprocess (reference
        Algorithm._update, algorithm_base.py:586)."""
        batch, indices = buffer.sample(buf_state, generator, batch_size,
                                       drop_keys=self.update_sample_drop_keys)
        batch = self.preprocess(ts, buffer, buf_state, batch, indices, generator)
        ts, stats = self.update_step(ts, batch, generator)
        buf_state = self.postprocess(ts, buffer, buf_state, batch, indices, stats)
        return ts, buf_state, stats

    # ------------------------------------------------------------------
    def _nstep_terminal(self, buffer, buf_state, batch: Batch, indices: torch.Tensor):
        """n-step reward chain plus the terminal row's (obs_next, terminated).

        For n_step == 1 the terminal row is the sampled row, so the gathered
        batch is reused. For n_step > 1 only the two consumed fields are
        gathered at the terminal index.
        """
        base_state = buf_state.base if hasattr(buf_state, "base") else buf_state  # prioritized replay
        rews, ends, term_idx = buffer.n_step_gather(base_state, indices, self.n_step)
        if self.n_step == 1 and "obs_next" in batch:
            return rews, ends, batch.obs_next, batch.terminated
        terminal = buffer.get(buf_state, term_idx, keys=("obs_next", "terminated"))
        return rews, ends, terminal.obs_next, terminal.terminated


class OnPolicyAlgorithm(Algorithm):
    """Updates from whole fresh rollouts (reference :828)."""


class OffPolicyAlgorithm(Algorithm):
    """Updates from replayed minibatches (reference :868). Subclasses that
    define ``_target_q(ts, obs_next)`` get n-step bootstrapped targets from
    :meth:`preprocess` (reference ``compute_nstep_return``, :721)."""

    n_step: int = 1

    def _target_q(self, ts: TrainState, obs_next: Any) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def preprocess(self, ts, buffer, buf_state, batch: Batch, indices: torch.Tensor,
                   generator: torch.Generator) -> Batch:
        rews, ends, obs_next_t, terminated_t = self._nstep_terminal(buffer, buf_state, batch, indices)
        tq = self._target_q(ts, obs_next_t)
        mask = value_mask(terminated_t)
        tq = tq * mask.reshape(mask.shape + (1,) * (tq.dim() - 1))
        batch.returns = nstep_returns(rews, ends, tq, self.gamma)
        return batch
