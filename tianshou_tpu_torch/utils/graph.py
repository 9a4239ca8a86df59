"""CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package never runs its update burst, its collect chunk or its fused
megastep eagerly: each is one compiled program. Here such a program is a
Python function of no arguments over static tensors (state that every call
updates in place, as the port's buffers and train states are), wrapped in a
:class:`Graphed` and captured once into a CUDA graph that later calls replay.

- **Warm-up is real work.** The first call runs the function eagerly on
  the pool's side stream: it fills cuDNN's and cuBLAS's lazy state, Adam's
  moments and every cache a first call builds, and it counts as work done.
  The second call captures the function (which executes nothing) and
  replays the graph, so every call does the function's work
  exactly once: the number of updates, the step counters and the sequence of
  random draws are those of the eager loop.
- **Generators.** Each graph registers the explicit ``torch.Generator``\\ s
  the function draws from, so that a replay reads their Philox offset when it
  starts and advances it by what the captured draws take, as eager calls
  would: every replay draws fresh numbers, the same ones the eager loop
  draws.
- **One memory pool** (:class:`GraphPool`) per owner, shared by its graphs,
  which never run at the same time. A graph's outputs are its static
  tensors: the next replay of a graph of the same pool may overwrite them,
  so a caller that keeps them clones them.
- **Launch counters.** A kernel wrapper counts its launch when it runs
  (:mod:`tianshou_tpu_torch.ops.kernels.counters`); during capture nothing
  launches, so the capture's increments are taken back out and added again
  on every replay.
- **Step graphs** (:class:`StepGraphs`): a loop too long for one graph
  runs eagerly, and each of its steps replays a graph of one step.
- On the CPU a call runs the function eagerly. On the card a capture that
  fails raises; nothing falls back to the eager function.
"""

from __future__ import annotations

import gc
import time
from collections.abc import Callable, Sequence
from typing import Any

import torch

from tianshou_tpu_torch.ops.kernels import counters
from tianshou_tpu_torch.utils.tree import tree_map

__all__ = ["GraphPool", "Graphed", "StepGraphs", "graphed_step"]


class GraphPool:
    """The memory pool, the side stream and the graphs of one owner (a trainer)."""

    def __init__(self, device: str | torch.device) -> None:
        self.device = torch.device(device)
        self.graphs: list[Graphed] = []
        self.handle = self.stream = None
        if self.device.type == "cuda":
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)

    def memory_bytes(self) -> int:
        """Device memory that the pool's segments hold (0 on the CPU)."""
        if self.handle is None:
            return 0
        pool = tuple(self.handle)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class Graphed:
    """``fn()`` captured into a CUDA graph after one eager call.

    ``generators`` are the explicit generators ``fn`` draws from. Calling
    returns ``fn``'s output: a fresh one from an eager call, the graph's
    static output from a replay. ``capture_s`` is the time the capture took
    (tracing and instantiation), ``launches`` the kernel launches of one
    replay by kernel, ``replays`` the number of replays so far.
    """

    def __init__(self, fn: Callable[[], Any], pool: GraphPool, generators: Sequence[torch.Generator] = (),
                 name: str = "graph") -> None:
        self.fn, self.pool, self.generators, self.name = fn, pool, tuple(generators), name
        self.graph: torch.cuda.CUDAGraph | None = None
        self.out: Any = None
        self.calls = self.replays = 0
        self.capture_s: float | None = None
        self.launches: dict[str, int] = {}
        pool.graphs.append(self)

    def __call__(self) -> Any:
        if self.pool.device.type != "cuda":
            return self.fn()
        self.calls += 1
        if self.graph is None and self.calls == 1:
            return self._eager()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        counters.add_all(self.launches)
        self.replays += 1
        return self.out

    def _eager(self) -> Any:
        side, current = self.pool.stream, torch.cuda.current_stream(self.pool.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn()
        current.wait_stream(side)
        return out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        before = counters.snapshot()
        t0 = time.perf_counter()
        # a program's closure refers to its owner, so dead graphs wait for the cycle collector; one
        # that ran during a capture would free a graph then, which invalidates the capture
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool.handle, stream=self.pool.stream):
                out = self.fn()
        except Exception as exc:
            raise RuntimeError(f"capturing {self.name} into a CUDA graph failed: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
            after = counters.snapshot()
            counters.restore(before)
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
        self.graph, self.out = graph, out


#: the open :class:`StepGraphs` blocks, innermost last
_ACTIVE: list[StepGraphs] = []


class StepGraphs:
    """The steps of an eager loop, each a replay of a graph of one step.

    An on-policy update over a long rollout (``mujoco_ppo_hl.py``: 20,480
    minibatch steps of about 190 kernels each) is too long for one graph: its
    capture would take as much host time as the eager run, and the graph
    would hold millions of nodes. Inside ``with StepGraphs(device, generators):``
    the loop runs eagerly and each :func:`graphed_step` call replays a graph
    of its step: ``fn(slot)`` over a static index slot, refilled before every
    call, run eagerly at the first call and captured at the second (a
    :class:`Graphed`). A step is held per ``owner`` while the objects it
    closes over (``key``, compared by identity) stay the same; another key
    captures anew. The step's output is cloned, since the next replay
    overwrites it. Each step graph has a memory pool of its own: the caching
    allocator takes no capture into a pool whose graphs have all been freed,
    and a step's graph is freed when its key changes and when the block ends.
    ``captures`` and ``replays`` count the block's graphs.
    """

    def __init__(self, device: str | torch.device, generators: Sequence[torch.Generator] = ()) -> None:
        self.device, self.generators = torch.device(device), tuple(generators)
        self._held: dict[int, tuple[tuple, torch.Tensor, Graphed]] = {}
        self.captures = self.replays = 0

    def __enter__(self) -> StepGraphs:
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        _ACTIVE.remove(self)
        for _, _, program in self._held.values():
            self._drop(program)
        self._held.clear()

    def _drop(self, program: Graphed) -> None:
        program.pool.graphs.remove(program)  # no cycle keeps the graph alive after this
        self.captures += program.graph is not None
        self.replays += program.replays

    def step(self, owner: Any, key: tuple, fn: Callable[[torch.Tensor], Any], idx: torch.Tensor) -> Any:
        """``fn(idx)``, replayed from ``owner``'s graph where ``key`` is unchanged."""
        full = (owner, *key)
        held = self._held.get(id(owner))
        if held is None or len(held[0]) != len(full) or any(a is not b for a, b in zip(held[0], full)):
            if held is not None:
                self._drop(held[2])
            slot = idx.clone()
            program = Graphed(lambda: fn(slot), GraphPool(self.device), self.generators,
                              name=f"{type(owner).__name__} step")
            held = self._held[id(owner)] = (full, slot, program)
        _, slot, program = held
        slot.copy_(idx)
        return tree_map(torch.clone, program())


def graphed_step(owner: Any, key: tuple, fn: Callable[[torch.Tensor], Any], idx: torch.Tensor) -> Any:
    """``fn(idx)``: inside a :class:`StepGraphs` block its replayed graph
    (see :meth:`StepGraphs.step`), elsewhere run as it is."""
    return _ACTIVE[-1].step(owner, key, fn, idx) if _ACTIVE else fn(idx)
