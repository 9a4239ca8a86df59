"""Device-resident replay buffer (port of ``tianshou_tpu/data/buffer/base.py``).

One structure for the reference's ``ReplayBuffer`` (data/buffer/buffer_base.py:25)
and ``ReplayBufferManager`` (data/buffer/manager.py:13): a :class:`BufferState`
of ``[num_envs, capacity, ...]`` ring tensors with per-env cursors. Flat index
convention: ``idx = env * capacity + slot``.

Unlike the JAX package, :meth:`ReplayBuffer.add` and :meth:`ReplayBuffer.add_rollout`
write into the state's tensors in place (the rings are large) and return the
same state object. Every tensor of a :class:`BufferState` keeps its storage
for its whole life (the cursors too are written with ``copy_``), so that a
CUDA graph captured over the state reads and writes the live tensors.

The frame-stack re-gather of :meth:`ReplayBuffer._stacked` runs through the
hand-written row-gather kernel (:func:`tianshou_tpu_torch.ops.kernels.gather.gather_rows`)
on the ``[E*C, row_bytes]`` byte view of the ring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.types import TRANSITION_EXAMPLE_KEYS, validate_keys
from tianshou_tpu_torch.ops.kernels.gather import gather_rows
from tianshou_tpu_torch.utils.device import resolve_device

__all__ = ["AddInfo", "BufferState", "ReplayBuffer", "VectorReplayBuffer"]


@dataclasses.dataclass
class BufferState:
    data: Batch              # [E, C, ...] ring storage per reserved key
    cursor: torch.Tensor     # [E] next write slot
    size: torch.Tensor       # [E] valid entries per env ring
    last_idx: torch.Tensor   # [E] slot of the most recent write (for next())


class AddInfo(NamedTuple):
    """Returned by add(): flat indices written and episode bookkeeping."""

    indices: torch.Tensor     # [E] flat indices written (or -1 where masked out)
    done: torch.Tensor        # [E] episode finished at this step
    ep_returns: torch.Tensor  # [E] zeros (the collector keeps episode returns)
    ep_lens: torch.Tensor     # [E] zeros


def _leaf_map(fn, v):
    return v.map(fn) if isinstance(v, Batch) else fn(v)


class ReplayBuffer:
    """Static configuration; the state lives in :class:`BufferState`.

    Reserved keys match the reference (buffer_base.py:41): obs, act, rew,
    terminated, truncated, done, obs_next.
    """

    def __init__(
        self,
        size: int,
        num_envs: int = 1,
        stack_num: int = 1,
        ignore_obs_next: bool = False,
        save_only_last_obs: bool = False,
        sample_avail: bool = False,
    ) -> None:
        if size <= 0 or num_envs <= 0:
            raise ValueError(f"size and num_envs must be positive, got {size} and {num_envs}")
        self.capacity = int(math.ceil(size / num_envs))
        self.num_envs = num_envs
        self.total_size = self.capacity * num_envs
        self.stack_num = stack_num
        self.ignore_obs_next = ignore_obs_next
        # frame-stacked envs: store only the newest frame, re-stack at sample
        # time via stack_num (reference buffer_base.py save_only_last_obs)
        self.save_only_last_obs = save_only_last_obs
        self.sample_avail = sample_avail

    # ------------------------------------------------------------------
    def init(self, example: Batch, device: str | torch.device | None = None) -> BufferState:
        """Allocate zeroed storage from one example transition (no env axis)."""
        validate_keys(example, TRANSITION_EXAMPLE_KEYS)
        dev = resolve_device(device)
        E, C = self.num_envs, self.capacity

        def alloc(x: torch.Tensor) -> torch.Tensor:
            return torch.zeros((E, C) + tuple(x.shape), dtype=x.dtype, device=dev)

        data = example.map(alloc)
        if self.ignore_obs_next and "obs_next" in data:
            del data["obs_next"]
        if "done" not in data:
            data.done = torch.zeros((E, C), dtype=torch.bool, device=dev)
        zeros = lambda: torch.zeros(E, dtype=torch.int64, device=dev)  # noqa: E731
        return BufferState(data=data, cursor=zeros(), size=zeros(), last_idx=zeros())

    # ------------------------------------------------------------------
    def add(
        self,
        state: BufferState,
        transitions: Batch,
        mask: torch.Tensor | None = None,
    ) -> tuple[BufferState, AddInfo]:
        """Insert one transition per env (leading axis E) and advance the
        rings, in place. ``mask`` (optional [E] bool) suppresses writes for
        inactive envs (the reference's ``buffer_ids`` subset adds,
        manager.py:131)."""
        E, C = self.num_envs, self.capacity
        cur = state.cursor
        dev = cur.device
        done = transitions.terminated.to(torch.bool) | transitions.truncated.to(torch.bool)
        transitions = transitions.copy()
        transitions.done = done
        if self.save_only_last_obs:
            # obs arrives frame-stacked [E, L, ...]; keep the newest frame
            transitions.obs = _leaf_map(lambda a: a[:, -1], transitions.obs)
            if "obs_next" in transitions:
                transitions.obs_next = _leaf_map(lambda a: a[:, -1], transitions.obs_next)
        if self.ignore_obs_next and "obs_next" in transitions:
            del transitions["obs_next"]

        env_ids = torch.arange(E, device=dev)

        def write(store: torch.Tensor, val: torch.Tensor) -> None:
            val = val.to(store.dtype)
            if mask is not None:
                m = mask.reshape((E,) + (1,) * (val.dim() - 1))
                val = torch.where(m, val, store[env_ids, cur])
            store[env_ids, cur] = val

        for k, store in state.data.items():
            if isinstance(store, Batch):
                for sk, sub in store.items():
                    write(sub, transitions[k][sk])
            else:
                write(store, transitions[k])
        # cur is state.cursor: everything that reads it comes before the cursor's write
        if mask is None:
            flat = env_ids * C + cur
            state.last_idx.copy_(cur)
            state.size.copy_(torch.clamp(state.size + 1, max=C))
            state.cursor.copy_((cur + 1) % C)
            written = done
        else:
            m = mask.to(torch.int64)
            flat = torch.where(mask, env_ids * C + cur, -1)
            state.last_idx.copy_(torch.where(mask, cur, state.last_idx))
            state.size.copy_(torch.clamp(state.size + m, max=C))
            state.cursor.copy_((cur + m) % C)
            written = done & mask
        info = AddInfo(
            indices=flat,
            done=written,
            ep_returns=torch.zeros(E, dtype=torch.float32, device=dev),
            ep_lens=torch.zeros(E, dtype=torch.int64, device=dev),
        )
        return state, info

    def add_rollout(self, state: BufferState, rollout: Batch) -> BufferState:
        """Insert a time-major rollout ``[T, E, ...]`` step by step, in place."""
        for t in range(len(rollout)):
            state, _ = self.add(state, rollout[t])
        return state

    # ------------------------------------------------------------------
    # episode-aware index arithmetic (reference buffer_base.py:319-334,
    # manager.py:311-363 numba kernels)
    # ------------------------------------------------------------------
    def _split(self, flat_idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return flat_idx // self.capacity, flat_idx % self.capacity

    def _oldest_slot(self, state: BufferState, env: torch.Tensor) -> torch.Tensor:
        full = state.size[env] >= self.capacity
        return torch.where(full, state.cursor[env] % self.capacity, 0)

    def prev(self, state: BufferState, flat_idx: torch.Tensor) -> torch.Tensor:
        """Index of the previous transition, stopping at episode/buffer start."""
        env, slot = self._split(flat_idx)
        C = self.capacity
        prev_abs = (slot - 1) % C
        at_oldest = slot == self._oldest_slot(state, env)
        prev_abs = torch.where(at_oldest, slot, prev_abs)
        end_prev = state.data.done[env, prev_abs]
        out_slot = torch.where(end_prev, slot, prev_abs)
        return env * C + out_slot

    def next(self, state: BufferState, flat_idx: torch.Tensor) -> torch.Tensor:
        """Index of the next transition, stopping at episode end / newest entry."""
        env, slot = self._split(flat_idx)
        C = self.capacity
        is_end = state.data.done[env, slot]
        is_last = slot == state.last_idx[env]
        nxt = torch.where(is_end | is_last, slot, (slot + 1) % C)
        return env * C + nxt

    # ------------------------------------------------------------------
    def _avail_mask(self, state: BufferState) -> torch.Tensor:
        """[E*C] mask of indices whose full ``stack_num`` history exists
        (reference sample_avail, buffer_base.py:515-545): walking prev must
        not clamp (episode start / buffer edge) before the stack completes."""
        E, C = self.num_envs, self.capacity
        dev = state.size.device
        idx = torch.arange(E * C, device=dev)
        slot = (idx % C).reshape(E, C)
        stored = slot < torch.clamp(state.size[:, None], min=0)
        full = state.size[:, None] >= C
        ok = torch.where(full, True, stored).reshape(E * C)
        cur = idx
        for _ in range(self.stack_num - 1):
            prv = self.prev(state, cur)
            ok = ok & (prv != cur)
            cur = prv
        return ok

    def sample_indices(self, state: BufferState, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Uniform flat indices over all valid entries (ragged per-env sizes),
        drawn with ``generator`` without a host sync.

        Mirrors weighted cross-sub-buffer sampling (manager.py:200). With
        ``sample_avail`` and ``stack_num>1``, only indices with a complete
        frame-stack history are drawn, through ``torch.multinomial`` (off the
        main path), which a CUDA graph captures (each replay draws what the
        eager calls draw: ``tests/test_torch_cuda.py``); :meth:`_avail_mask`
        reads nothing back to the host.
        """
        dev = state.size.device
        if self.sample_avail and self.stack_num > 1:
            ok = self._avail_mask(state)
            return torch.multinomial(ok.to(torch.float32), batch_size, replacement=True, generator=generator)
        cum = torch.cumsum(state.size, 0)
        total = torch.clamp(cum[-1], min=1)
        u01 = torch.rand(batch_size, dtype=torch.float64, device=dev, generator=generator)
        u = torch.minimum((u01 * total).to(torch.int64), total - 1)
        # an empty buffer would give env == num_envs; clamp like the JAX
        # package does inside jit (callers must not sample an empty buffer)
        env = torch.clamp(torch.searchsorted(cum, u, right=True), max=self.num_envs - 1)
        offset_in_env = u - torch.where(env > 0, cum[torch.clamp(env - 1, min=0)], 0)
        oldest = self._oldest_slot(state, env)
        slot = (oldest + offset_in_env) % self.capacity
        return env * self.capacity + slot

    # ------------------------------------------------------------------
    def get(
        self,
        state: BufferState,
        flat_idx: torch.Tensor,
        stack_num: int | None = None,
        keys: tuple[str, ...] | None = None,
        drop_keys: tuple[str, ...] = (),
    ) -> Batch:
        """Gather transitions at ``flat_idx``; frame-stack obs if configured.

        Frame stacking mirrors reference ``get`` (buffer_base.py:557-598): the
        last ``stack_num`` observations along a new axis after the batch
        axis, clamped at episode starts (the earliest frame repeats).
        ``keys`` (whitelist) / ``drop_keys`` (blacklist) restrict which fields
        are gathered, so that a caller pays only for what it reads.
        """
        stack = self.stack_num if stack_num is None else stack_num
        want = set(state.data.keys() if keys is None else keys) - set(drop_keys)
        want_obs_next = "obs_next" in want or (keys is None and "obs_next" not in drop_keys)
        env, slot = self._split(flat_idx)
        batch = Batch()
        for k, v in state.data.items():
            if k not in want or (stack > 1 and k in ("obs", "obs_next")):
                continue
            batch[k] = _leaf_map(lambda a: a[env, slot], v)
        if stack > 1:
            if "obs" in want:
                batch.obs = self._stacked(state, flat_idx, "obs", stack)
            if "obs_next" in state.data and want_obs_next:
                batch.obs_next = self._stacked(state, flat_idx, "obs_next", stack)
        if "obs_next" not in state.data and want_obs_next:
            # reconstruct obs_next = obs at the next index (reference
            # ignore_obs_next path, buffer_base.py:557-598, which frame-stacks
            # obs at next(index) so obs and obs_next have matching shapes)
            nxt = self.next(state, flat_idx)
            if stack > 1:
                batch.obs_next = self._stacked(state, nxt, "obs", stack)
            else:
                nenv, nslot = self._split(nxt)
                batch.obs_next = _leaf_map(lambda a: a[nenv, nslot], state.data.obs)
        return batch

    def _stacked(self, state: BufferState, flat_idx: torch.Tensor, key: str, stack: int) -> torch.Tensor | Batch:
        """Frame-stack gather as ONE ``[B*stack]``-row gather kernel launch
        per leaf.

        The prev chain is ``[B]`` integer index math, laid out sample-major
        (``[B, stack]``, oldest frame first) so that the gathered rows need
        only a reshape. Flat indices address rows of the ``[E*C, row_bytes]``
        byte view of the ring directly.
        """
        idxs = [flat_idx]
        for _ in range(stack - 1):
            idxs.append(self.prev(state, idxs[-1]))
        idxs.reverse()  # oldest first, matching the reference's stack order
        chain = torch.stack(idxs, dim=1)  # [B, stack]
        B, S = chain.shape
        rows = chain.reshape(-1)

        def g(a: torch.Tensor) -> torch.Tensor:
            row_bytes = a.reshape(a.shape[0] * a.shape[1], -1).view(torch.uint8)
            out = gather_rows(row_bytes, rows)
            return out.view(a.dtype).reshape((B, S) + tuple(a.shape[2:]))

        return _leaf_map(g, state.data[key])

    def sample(
        self,
        state: BufferState,
        generator: torch.Generator | torch.Tensor,
        batch_size: int,
        drop_keys: tuple[str, ...] = (),
    ) -> tuple[Batch, torch.Tensor]:
        """A batch and its flat indices, drawn with ``generator``; a tensor of
        flat indices in the generator's place is taken as the draw."""
        idx = self._indices(state, generator, batch_size)
        return self.get(state, idx, drop_keys=drop_keys), idx

    def _indices(self, state, generator: torch.Generator | torch.Tensor, batch_size: int) -> torch.Tensor:
        if isinstance(generator, torch.Tensor):
            return generator
        return self.sample_indices(state, generator, batch_size)

    # ------------------------------------------------------------------
    def n_step_gather(
        self, state: BufferState, flat_idx: torch.Tensor, n: int
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The n-step chain from each index: ``(rewards [n, B],
        episode_end [n, B] float32, terminal_idx [B])`` with
        ``terminal_idx = next^{n-1}(idx)``, feeding
        :func:`tianshou_tpu_torch.ops.returns.nstep_returns`.

        This follows the JAX package bit for bit, also where it departs from
        upstream tianshou: at the newest row of an episode that has not
        finished, ``next`` stays put but ``episode_end`` is only ``done``, so
        the chain repeats that row's reward and the bootstrap is discounted by
        ``gamma**n``. Upstream's ``compute_nstep_return`` marks the unfinished
        row as an end (``end_flag[buffer.unfinished_index()] = True``).
        ``tests/test_torch_buffer.py`` pins the case."""
        idxs = [flat_idx]
        for _ in range(n - 1):
            idxs.append(self.next(state, idxs[-1]))
        chain = torch.stack(idxs)  # [n, B]
        env, slot = self._split(chain.reshape(-1))
        rews = state.data.rew[env, slot].reshape(chain.shape)
        ends = state.data.done[env, slot].reshape(chain.shape).to(torch.float32)
        return rews, ends, idxs[-1]

    # ------------------------------------------------------------------
    # host-level episode and merge utilities (reference buffer_base.py:171, :336)
    # ------------------------------------------------------------------
    def get_buffer_indices(self, state: BufferState, start: int, stop: int) -> np.ndarray:
        """Flat indices of the transitions from ``start`` (inclusive) to
        ``stop`` (exclusive) within one env ring, oldest first. The span may
        wrap the ring's edge, as the reference's cross-edge episode fetch does
        (buffer_base.py:171-250). Host-level: reads the ring's size back and
        raises on a span across rings, out of range, empty, longer than the
        stored entries or touching unwritten slots."""
        C = self.capacity
        env_s, slot_s = divmod(int(start), C)
        env_e, slot_e = divmod(int(stop), C)
        if env_s != env_e:
            raise ValueError(f"start={start} and stop={stop} lie in different env rings ({env_s} vs {env_e}); "
                             "episodes never span envs")
        if not 0 <= env_s < self.num_envs:
            raise ValueError(f"env {env_s} out of range [0, {self.num_envs})")
        length = (slot_e - slot_s) % C
        if length == 0 and start != stop:
            length = C  # a whole-ring episode
        if length == 0:
            raise ValueError(f"empty span: start == stop == {start}")
        size = int(state.size[env_s])
        if length > size:
            raise ValueError(f"span of length {length} exceeds the {size} stored entries of env ring {env_s}")
        slots = (slot_s + np.arange(length)) % C
        if size < C and (slots >= size).any():
            raise ValueError(f"span {start}:{stop} touches unwritten slots of env ring {env_s}")
        return env_s * C + slots

    def chronological_indices(self, state: BufferState, env: int) -> np.ndarray:
        """Flat indices of env ring ``env``, oldest to newest (host-level)."""
        size = int(state.size[env])
        oldest = int(state.cursor[env]) % self.capacity if size >= self.capacity else 0
        return env * self.capacity + (oldest + np.arange(size)) % self.capacity

    def update(self, state: BufferState, src: ReplayBuffer, src_state: BufferState) -> BufferState:
        """Every stored transition of ``src`` (oldest to newest, env by env)
        added to this buffer one at a time, in place (reference
        ``ReplayBuffer.update``, buffer_base.py:336). Only a single-ring
        destination merges, as the reference's ``ReplayBufferManager.update``
        raises. Host-level: not for a captured program."""
        if self.num_envs != 1:
            raise NotImplementedError("update() merges into a single-ring ReplayBuffer only "
                                      "(reference ReplayBufferManager.update raises likewise)")
        for env in range(src.num_envs):
            flat = src.chronological_indices(src_state, env)
            if len(flat) == 0:
                continue
            rows = src.get(src_state, torch.as_tensor(flat, device=src_state.size.device), stack_num=1)
            for i in range(len(flat)):
                state, _ = self.add(state, rows[i:i + 1])
        return state

    def num_stored(self, state: BufferState) -> torch.Tensor:
        """The number of stored transitions over all rings, a 0-d device tensor."""
        return state.size.sum()


def VectorReplayBuffer(total_size: int, buffer_num: int, **kwargs) -> ReplayBuffer:
    """The reference's ``VectorReplayBuffer`` signature (data/buffer/vecbuf.py:15):
    total capacity split across ``buffer_num`` per-env rings."""
    return ReplayBuffer(total_size, num_envs=buffer_num, **kwargs)
