"""Prioritized experience replay (arXiv:1511.05952) on device (port of
``tianshou_tpu/data/buffer/prio.py``; reference ``PrioritizedReplayBuffer``,
data/buffer/prio.py:12, and ``PrioritizedReplayBufferManager``, manager.py:239).

Max-priority init on add, stratified prefix-sum sampling through the sum
tree (:mod:`tianshou_tpu_torch.ops.segtree`, whose descent is the
hand-written CUDA kernel on the card), importance weights normalized by the
minimum priority. Like the base buffer, every method updates the state in
place and returns the same object; ``max_prio`` and ``min_prio`` are 0-d
device tensors, written with ``copy_``, so no method reads anything back to
the host and every tensor of a :class:`PrioState` keeps its storage (what a
CUDA graph captured over it needs). ``beta`` is read when a program is built
(captured as a constant), as the JAX package reads it at trace time.
"""

from __future__ import annotations

import dataclasses

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import AddInfo, BufferState, ReplayBuffer
from tianshou_tpu_torch.ops.segtree import SegmentTree

__all__ = ["PrioState", "PrioritizedReplayBuffer", "PrioritizedVectorReplayBuffer"]


@dataclasses.dataclass
class PrioState:
    base: BufferState
    tree: torch.Tensor      # sum tree over total_size leaves (priority^alpha)
    max_prio: torch.Tensor  # 0-d float32
    min_prio: torch.Tensor  # 0-d float32


class PrioritizedReplayBuffer(ReplayBuffer):
    #: maps the flat indices an add wrote to the tree's leaves: ``None`` where the tree covers just this ring; a
    #: rank's part of a ring split over ranks (``parallel/mesh.py:shard_buffer``) keeps the whole tree and maps its
    #: writes to every rank's written leaves, so that every rank writes the same tree
    leaf_map = None

    def __init__(
        self,
        size: int,
        alpha: float = 0.6,
        beta: float = 0.4,
        num_envs: int = 1,
        weight_norm: bool = True,
        eps: float = 1e-5,
        **kwargs,
    ) -> None:
        super().__init__(size, num_envs=num_envs, **kwargs)
        self.alpha = alpha
        self.beta = beta
        self.weight_norm = weight_norm
        self.eps = eps
        self.segtree = SegmentTree(self.total_size)

    # ------------------------------------------------------------------
    def init(self, example: Batch, device: str | torch.device | None = None) -> PrioState:  # type: ignore[override]
        base = super().init(example, device)
        dev = base.cursor.device
        return PrioState(
            base=base,
            tree=self.segtree.init(dev),
            max_prio=torch.ones((), dtype=torch.float32, device=dev),
            min_prio=torch.ones((), dtype=torch.float32, device=dev),
        )

    # ------------------------------------------------------------------
    def add(self, state: PrioState, transitions: Batch,
            mask: torch.Tensor | None = None) -> tuple[PrioState, AddInfo]:  # type: ignore[override]
        _, info = ReplayBuffer.add(self, state.base, transitions, mask)
        # new samples get max priority (reference prio.py:46 init_weight);
        # masked-out envs carry -1 indices, which the segtree drops
        leaves = info.indices if self.leaf_map is None else self.leaf_map(info.indices)
        prio = (state.max_prio**self.alpha).expand(leaves.shape)
        self.segtree.update(state.tree, leaves, prio)
        return state, info

    # ------------------------------------------------------------------
    def indices_from_uniform(self, state: PrioState, u01: torch.Tensor) -> torch.Tensor:
        """Stratified prefix-sum sampling from ``[B]`` uniforms in [0, 1):
        sample b is drawn from the b-th of B equal shares of the total
        priority mass."""
        n = u01.shape[0]
        strata = torch.arange(n, dtype=torch.float32, device=u01.device)
        u = (u01.to(torch.float32) + strata) / n
        return self.segtree.get_prefix_sum_idx(state.tree, u * self.segtree.total(state.tree))

    def sample_indices(self, state: PrioState, generator: torch.Generator, batch_size: int) -> torch.Tensor:  # type: ignore[override]
        u01 = torch.rand(batch_size, dtype=torch.float32, device=state.tree.device, generator=generator)
        return self.indices_from_uniform(state, u01)

    def get_weight(self, state: PrioState, flat_idx: torch.Tensor) -> torch.Tensor:
        """Importance-sampling weight (reference prio.py:69-80)."""
        leaf = state.tree[flat_idx + self.segtree.bound]
        weight = (leaf / torch.clamp(state.min_prio, min=1e-12)) ** (-self.beta)
        if self.weight_norm:
            weight = weight / torch.clamp(weight.max(), min=1e-12)
        return weight

    def sample(self, state: PrioState, generator: torch.Generator | torch.Tensor, batch_size: int,
               drop_keys: tuple[str, ...] = ()) -> tuple[Batch, torch.Tensor]:  # type: ignore[override]
        idx = self._indices(state, generator, batch_size)
        batch = self.get(state, idx, drop_keys=drop_keys)
        batch.weight = self.get_weight(state, idx)
        return batch, idx

    def get(self, state, flat_idx, stack_num=None, keys=None, drop_keys=()):  # type: ignore[override]
        base = state.base if isinstance(state, PrioState) else state
        return ReplayBuffer.get(self, base, flat_idx, stack_num, keys=keys, drop_keys=drop_keys)

    # ------------------------------------------------------------------
    def update_weight(self, state: PrioState, flat_idx: torch.Tensor, td_error: torch.Tensor) -> PrioState:
        """Write back new priorities after a gradient step (prio.py:81)."""
        prio = td_error.detach().abs().to(torch.float32) + self.eps
        self.segtree.update(state.tree, flat_idx, prio**self.alpha)
        state.max_prio.copy_(torch.maximum(state.max_prio, prio.max()))
        state.min_prio.copy_(torch.minimum(state.min_prio, prio.min()))
        return state

    def set_beta(self, beta: float) -> None:
        self.beta = beta


def PrioritizedVectorReplayBuffer(
    total_size: int, buffer_num: int, alpha: float = 0.6, beta: float = 0.4, **kwargs
) -> PrioritizedReplayBuffer:
    """Signature parity with reference vecbuf.py:40."""
    return PrioritizedReplayBuffer(total_size, alpha=alpha, beta=beta, num_envs=buffer_num, **kwargs)
