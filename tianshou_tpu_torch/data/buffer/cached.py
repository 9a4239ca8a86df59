"""CachedReplayBuffer: per-env episode caches feeding one main buffer (port of
``tianshou_tpu/data/buffer/cached.py``; reference data/buffer/cached.py:7).

Transitions gather in per-env caches (one ring of ``max_episode_len`` slots
per env) and a whole episode moves into the main ring when it finishes, so
an unfinished episode is never sampled. The JAX package moves episodes with
one masked scatter per env in a ``fori_loop``; here the same per-env loop
writes each env's ``max_episode_len`` destination rows with one indexed
write per stored key, rows that move taking the cache's values and the rest
keeping their own, in place and with no host read. Episodes that finish on
the same add land in env order, one after the other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.buffer.base import AddInfo, BufferState, ReplayBuffer

__all__ = ["CachedReplayBuffer", "CachedState"]


class CachedState(NamedTuple):
    main: BufferState
    cache: BufferState


class CachedReplayBuffer:
    def __init__(self, main_size: int, num_envs: int, max_episode_len: int, **kwargs) -> None:
        self.main = ReplayBuffer(main_size, num_envs=1, **kwargs)
        self.cache = ReplayBuffer(max_episode_len * num_envs, num_envs=num_envs, **kwargs)
        self.num_envs = num_envs
        self.max_episode_len = self.cache.capacity
        if self.max_episode_len > self.main.capacity:
            raise ValueError(f"max_episode_len {max_episode_len} exceeds the main ring's {self.main.capacity} slots")

    def init(self, example: Batch, device: str | torch.device | None = None) -> CachedState:
        return CachedState(self.main.init(example, device), self.cache.init(example, device))

    def add(self, state: CachedState, transitions: Batch,
            mask: torch.Tensor | None = None) -> tuple[CachedState, AddInfo]:
        """Insert one transition per env into the caches; every episode that
        finished moves to the main ring and its cache restarts. In place."""
        cache, info = self.cache.add(state.cache, transitions, mask)
        main = state.main
        L, C = self.max_episode_len, self.main.capacity
        offsets = torch.arange(L, device=main.cursor.device)
        for e in range(self.num_envs):
            done = info.done[e]
            # the episode fills slots [0, ep_len): one of exactly L steps wraps the cursor back to 0 on its last
            # add, so take the saturated size then
            cur = cache.cursor[e]
            ep_len = torch.where((cur == 0) & (cache.size[e] > 0), cache.size[e], cur)
            mc = main.cursor[0]
            moves = (offsets < ep_len) & done
            dst = (mc + offsets) % C  # L <= C distinct rows

            def write(store: torch.Tensor, src: torch.Tensor) -> None:
                m = moves.reshape((L,) + (1,) * (src.dim() - 2))
                store[0, dst] = torch.where(m, src[e, :L], store[0, dst])

            for k, store in main.data.items():
                if isinstance(store, Batch):
                    for sk, sub in store.items():
                        write(sub, cache.data[k][sk])
                else:
                    write(store, cache.data[k])
            n = torch.where(done, ep_len, 0)
            main.last_idx.copy_(torch.where(done, (mc + ep_len.clamp(min=1) - 1) % C, main.last_idx))
            main.size.copy_((main.size + n).clamp(max=C))
            main.cursor.copy_((main.cursor + n) % C)
        cache.cursor.copy_(torch.where(info.done, 0, cache.cursor))
        cache.size.copy_(torch.where(info.done, 0, cache.size))
        return state, info

    # sampling draws from the main ring only (finished episodes)
    def sample(self, state: CachedState, generator, batch_size: int, drop_keys: tuple[str, ...] = ()):
        return self.main.sample(state.main, generator, batch_size, drop_keys=drop_keys)

    def sample_indices(self, state: CachedState, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        return self.main.sample_indices(state.main, generator, batch_size)

    def get(self, state: CachedState, idx: torch.Tensor, stack_num: int | None = None,
            keys: tuple[str, ...] | None = None, drop_keys: tuple[str, ...] = ()) -> Batch:
        return self.main.get(state.main, idx, stack_num, keys=keys, drop_keys=drop_keys)

    def num_stored(self, state: CachedState) -> torch.Tensor:
        return state.main.size.sum()
