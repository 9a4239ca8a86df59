"""Sum segment tree on device (port of ``tianshou_tpu/ops/segtree.py``;
reference ``data/utils/segtree.py:5-134``).

Layout: an implicit binary heap in one float32 tensor of length ``2 * bound``
(``bound`` = next power of two >= size); node 1 is the root, leaves live at
``[bound, 2 * bound)``. Node 0 is unused and stays 0.0.

:meth:`SegmentTree.update` writes the tree in place (as the port's replay
rings are written in place) and returns it. It reads nothing back to the
host; the last of duplicate indices wins and out-of-range indices are
dropped. Parents are recomputed as ``tree[2p] + tree[2p+1]`` level by level,
so a tree built from the same leaf values is bit-identical to the JAX one.

Both the update and :meth:`SegmentTree.get_prefix_sum_idx` (the descent) are
in :mod:`tianshou_tpu_torch.ops.kernels.sumtree`: the hand-written CUDA
kernels for a tree on the card, their plain versions for a tree on the CPU.
"""

from __future__ import annotations

import torch

from tianshou_tpu_torch.ops.kernels import sumtree
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["SegmentTree"]


def _next_pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class SegmentTree:
    """Static-config handle; all state lives in the tensor returned by init()."""

    def __init__(self, size: int) -> None:
        if size <= 0:
            raise ValueError(f"size must be positive, got {size}")
        self.size = size
        self.bound = _next_pow2(size)
        self.depth = self.bound.bit_length() - 1  # log2(bound)

    def init(self, device: str | torch.device | None = None) -> torch.Tensor:
        return torch.zeros(2 * self.bound, dtype=torch.float32, device=resolve_device(device))

    # ------------------------------------------------------------------
    def update(self, tree: torch.Tensor, index: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """Set leaves at ``index`` to ``value`` and repair ancestors, in place.

        index: int tensor [k]; value: float tensor [k]. Last write wins on
        duplicate indices. Indices outside [0, size) are dropped, so callers
        can pass -1 sentinels for masked-out updates.
        """
        index = index.reshape(-1).to(torch.int64)
        value = value.reshape(-1).to(torch.float32)
        return sumtree.update(tree, index, value, self.bound, self.depth, self.size)

    # ------------------------------------------------------------------
    def reduce(self, tree: torch.Tensor, start: int | torch.Tensor = 0,
               end: int | torch.Tensor | None = None) -> torch.Tensor:
        """Sum over ``[start, end)`` (reference ``_reduce`` segtree.py:104-116)."""
        if end is None:
            end = self.size
        lo = torch.as_tensor(start, dtype=torch.int64, device=tree.device) + (self.bound - 1)
        hi = torch.as_tensor(end, dtype=torch.int64, device=tree.device) + self.bound
        result = torch.zeros((), dtype=torch.float32, device=tree.device)
        last = 2 * self.bound - 1
        for _ in range(self.depth + 1):
            # a node is read only where its condition holds; clamp the other reads into the tree
            result = result + torch.where((lo % 2 == 0) & (lo + 1 < hi), tree[torch.clamp(lo + 1, max=last)], 0.0)
            result = result + torch.where((hi % 2 == 1) & (hi - 1 > lo), tree[torch.clamp(hi - 1, 0, last)], 0.0)
            lo, hi = lo // 2, hi // 2
        return result

    def total(self, tree: torch.Tensor) -> torch.Tensor:
        return tree[1]

    # ------------------------------------------------------------------
    def get_prefix_sum_idx(self, tree: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
        """Largest i with prefix_sum(i) <= value, as int64 (reference
        ``_get_prefix_sum_idx`` segtree.py:119-134). ``value`` is a float
        tensor of any shape; the result has its shape."""
        value = value.to(torch.float32)
        flat = sumtree.prefix_sum_idx(tree, value.reshape(-1).contiguous(), self.bound, self.depth, self.size)
        return flat.reshape(value.shape)
