"""Hindsight experience replay, arXiv:1707.01495 (port of
``tianshou_tpu/data/buffer/her.py``; reference ``HERReplayBuffer``,
data/buffer/her.py:11).

The reference rewrites whole episodes in the buffer and restores them after
sampling (``rewrite_transitions:100``, ``_restore_cache:48``). As in the JAX
package, relabelling here is a function of the sampled batch ('future'
strategy): from each sampled index, a uniform draw among the steps that
follow it in its episode (itself included, at most ``horizon``), whose
achieved goal becomes the desired goal, and the reward recomputed, with
probability ``1 - 1/future_k``. The buffer is never written.

The JAX package walks the ``next`` chain ``horizon - 1`` times to count the
steps left. A ring's ``next`` moves to the following slot until an episode
end or the newest row, so here the count is one ``[B, horizon - 1]`` gather
of the ``done`` flags and the newest-row test, and the future index is the
sampled slot plus the drawn offset: the same indices, with no dependent walk.

The two uniform draws per sample (the offset and the relabel coin) come from
the update's generator (in a CUDA graph, the one it registered) or from
:class:`tianshou_tpu_torch.algorithm.base.Draws` (``her_offset``,
``her_relabel``), which tests fill with JAX's draws. Observations are
goal-structured ``Batch``\\ es with ``observation``, ``achieved_goal`` and
``desired_goal``.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from tianshou_tpu_torch.algorithm.base import Draws, uniform
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import BufferState, ReplayBuffer

__all__ = ["HERReplayBuffer", "HERVectorReplayBuffer"]


class HERReplayBuffer(ReplayBuffer):
    relabels_on_sample = True

    def __init__(self, size: int, compute_reward_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 horizon: int, future_k: float = 8.0, num_envs: int = 1, **kwargs) -> None:
        super().__init__(size, num_envs=num_envs, **kwargs)
        self.compute_reward_fn = compute_reward_fn
        self.horizon = horizon
        self.future_p = 1.0 - 1.0 / future_k

    def sample(self, state: BufferState, generator: torch.Generator | Draws | torch.Tensor, batch_size: int,
               drop_keys: tuple[str, ...] = ()) -> tuple[Batch, torch.Tensor]:
        """A relabelled batch and its indices. ``drop_keys`` is accepted for the
        base signature; relabelling reads ``obs_next``, so the algorithm
        passes none. The batch carries the plan (``her_new_goal``,
        ``her_relabel``) for the n-step chain, which ``preprocess`` pops."""
        rows = generator.indices if isinstance(generator, Draws) else generator
        idx = self._indices(state, rows, batch_size)
        batch = self.get(state, idx, drop_keys=drop_keys)
        new_goal, relabel = self.relabel_plan(state, idx, generator)
        batch = self.apply_relabel(batch, new_goal, relabel)
        batch.her_new_goal = new_goal
        batch.her_relabel = relabel
        return batch, idx

    def relabel_plan(self, state: BufferState, idx: torch.Tensor,
                     generator: torch.Generator | Draws) -> tuple[torch.Tensor, torch.Tensor]:
        """Per sampled index: ``(new goal [B, ...goal], relabel [B] bool)``.
        One decision covers the index's whole forward chain, as the
        reference's episode-wide rewrite does (her.py:100)."""
        B, H, C = idx.shape[0], self.horizon, self.capacity
        dev = idx.device
        u_off = uniform(generator, "her_offset", (B,), dev)
        u_mask = uniform(generator, "her_relabel", (B,), dev)
        env, slot = self._split(idx)
        # step j of the chain moves past slot + j unless that slot ends an episode or is the env's newest row
        steps = (slot[:, None] + torch.arange(H - 1, device=dev)) % C  # [B, H-1]
        stops = state.data.done[env[:, None], steps] | (steps == state.last_idx[env][:, None])
        n_future = 1 + torch.cumprod((~stops).to(torch.int64), dim=1).sum(1)  # [B] >= 1
        offset = torch.floor(u_off * n_future).to(torch.int64)
        future_idx = env * C + (slot + offset.clamp(max=H - 1)) % C
        return self._achieved_next(state, future_idx), u_mask < self.future_p

    def _achieved_next(self, state: BufferState, idx: torch.Tensor) -> torch.Tensor:
        """``achieved_goal`` of ``obs_next`` at ``idx`` (the next index's
        ``obs`` where ``obs_next`` is not stored)."""
        if "obs_next" in state.data:
            env, slot = self._split(idx)
            return state.data.obs_next.achieved_goal[env, slot]
        env, slot = self._split(self.next(state, idx))
        return state.data.obs.achieved_goal[env, slot]

    @staticmethod
    def _splice(goal_new: torch.Tensor, goal_old: torch.Tensor, relabel: torch.Tensor) -> torch.Tensor:
        return torch.where(relabel.reshape(relabel.shape + (1,) * (goal_old.dim() - relabel.dim())), goal_new, goal_old)

    def apply_relabel(self, batch: Batch, new_goal: torch.Tensor, relabel: torch.Tensor) -> Batch:
        """The relabel plan spliced into a gathered transition batch (a copy)."""
        batch = batch.copy()
        batch.obs.desired_goal = self._splice(new_goal, batch.obs.desired_goal, relabel)
        batch.obs_next.desired_goal = self._splice(new_goal, batch.obs_next.desired_goal, relabel)
        new_rew = self.compute_reward_fn(batch.obs_next.achieved_goal, batch.obs_next.desired_goal)
        batch.rew = torch.where(relabel, new_rew, batch.rew)
        return batch

    def n_step_gather_relabeled(self, state: BufferState, flat_idx: torch.Tensor, n: int, new_goal: torch.Tensor,
                                relabel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``n_step_gather`` with every chain step's reward recomputed under the
        sampled index's plan (the reference rewrites the episode from the
        sampled step on, her.py:100, so its n-step gather reads relabelled
        rewards). Steps past the episode's end keep their reward:
        ``nstep_returns`` stops at ``ends``."""
        rews, ends = [], []
        idx = flat_idx
        for i in range(n):
            env, slot = self._split(idx)
            rel_rew = self.compute_reward_fn(self._achieved_next(state, idx), new_goal)
            rews.append(torch.where(relabel, rel_rew, state.data.rew[env, slot]))
            ends.append(state.data.done[env, slot])
            if i < n - 1:
                idx = self.next(state, idx)
        return torch.stack(rews), torch.stack(ends).to(torch.float32), idx


def HERVectorReplayBuffer(total_size: int, buffer_num: int, **kwargs) -> HERReplayBuffer:
    """The reference's signature (vecbuf.py:69)."""
    return HERReplayBuffer(total_size, num_envs=buffer_num, **kwargs)
