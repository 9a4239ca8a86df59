"""Off-policy trainer (port of ``tianshou_tpu/trainer/trainer.py``; reference
``tianshou/trainer.py``: ``TrainerParams`` :81, ``OffPolicyTrainer`` :1043).

The epoch and update cadence are the JAX package's: after an optional
random prefill, each chunk collects ``collection_step_num_env_steps`` steps
from every env and then takes ``round(update_per_step * T * E)`` gradient
steps; the host reads back only the per-chunk episode and loss statistics.

The JAX package jits the collect chunk and the update burst, and with
``fused_megastep`` both as one program. Here they are the programs
:meth:`OffPolicyTrainer.collect_chunk`, :meth:`OffPolicyTrainer.update_burst`
and :meth:`OffPolicyTrainer.megastep`, each a CUDA graph on the card
(:class:`tianshou_tpu_torch.utils.graph.Graphed`): a program's first call
runs eagerly as its warm-up and counts as work done, its second captures and
replays it, every later call replays it. A program is built once per trainer
and per state it closes over (train state, buffer state, collect state,
generator), so a second :meth:`OffPolicyTrainer.run` on the same states
replays what the first captured; all graphs of a trainer share one memory
pool. On the CPU the same code runs eagerly. The random prefill stays eager.
Test episodes and loggers are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch import config
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.collector import DeviceCollector
from tianshou_tpu_torch.utils.graph import Graphed, GraphPool
from tianshou_tpu_torch.utils.statistics import MovAvg

__all__ = ["OffPolicyTrainer", "OffPolicyTrainerParams", "TrainResult", "TrainerParams"]


@dataclasses.dataclass
class TrainerParams:
    """Common knobs (reference trainer.py:81)."""

    max_epochs: int = 10
    epoch_num_steps: int = 10000          # env steps per epoch (total across envs)
    train_fn: Callable[[int, int], dict] | None = None   # -> hparam overrides
    verbose: bool = True


@dataclasses.dataclass
class OffPolicyTrainerParams(TrainerParams):
    batch_size: int = 64
    collection_step_num_env_steps: int = 10   # steps per env per collect chunk
    update_per_step: float = 1.0              # grad steps per collected env step
    start_steps: int = 0                      # uniform-random prefill before learning
    # collect and the update burst as ONE program per chunk (one CUDA graph on
    # the card); the burst follows the collect, so the actor's params stay
    # chunk-stale as in the sequential loop (tianshou_tpu trainer.py:76)
    fused_megastep: bool = False


@dataclasses.dataclass
class TrainResult:
    """Summary, mirroring reference InfoStats (data/stats.py:83)."""

    env_step: int
    gradient_step: int
    epochs: int
    train_time: float
    timing: dict
    train_state: Any = None
    buf_state: Any = None
    #: MovAvg-smoothed scalar update statistics (reference trainer.py:731-754)
    update_stats: dict = dataclasses.field(default_factory=dict)
    #: stats of every update of the last chunk, stacked on a leading axis
    last_chunk_stats: Batch | None = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class OffPolicyTrainer:
    """Collect chunk -> burst of gradient steps, repeated (reference :1043)."""

    def __init__(self, algo, train_collector: DeviceCollector, test_collector: DeviceCollector | None,
                 buffer, params: OffPolicyTrainerParams) -> None:
        if test_collector is not None:
            raise NotImplementedError("test episodes are not ported yet; pass test_collector=None")
        self.algo = algo
        self.train_collector = train_collector
        self.buffer = buffer
        self.params = params
        self.env_step = 0
        self.gradient_step = 0   # the host's mirror of the train state's step counter
        self._mov: dict[str, MovAvg] = {}
        #: the memory pool and the graphs of this trainer's programs (made at the first program)
        self.graph_pool: GraphPool | None = None
        self._programs: dict[tuple, tuple[tuple, Graphed]] = {}
        self._cstate = None

    def _apply_hparams(self, ts, overrides: dict | None):
        """Write ``train_fn``'s overrides into the hparams' device scalars in
        place, where the captured programs read them."""
        for k, v in (overrides or {}).items():
            if k in ts.hparams:
                ts.hparams[k].fill_(float(v))
            else:
                ts.hparams[k] = torch.full((), float(v), dtype=torch.float32, device=ts.step.device)
        return ts

    # ------------------------------------------------------------------
    # programs
    # ------------------------------------------------------------------
    def _program(self, key: tuple, states: tuple, generator: torch.Generator, fn: Callable[[], Any]) -> Graphed:
        """The program ``key`` over ``states`` (the objects ``fn`` closes
        over, compared by identity), built from ``fn`` once."""
        held = self._programs.get(key)
        if held is None or any(a is not b for a, b in zip(held[0], states)):
            if self.graph_pool is None:
                self.graph_pool = GraphPool(self.train_collector.venv.device)
            elif held is not None:
                self.graph_pool.graphs.remove(held[1])
            held = (states, Graphed(fn, self.graph_pool, (generator,), name=" ".join(map(str, key))))
            self._programs[key] = held
        return held[1]

    def _updates(self, ts, buf_state, generator: torch.Generator, n_updates: int) -> Batch:
        stats = [self.algo.update(ts, self.buffer, buf_state, generator, self.params.batch_size)[2]
                 for _ in range(n_updates)]
        return Batch({k: torch.stack([s[k] for s in stats]) for k in stats[0].keys()})

    def update_burst(self, ts, buf_state, generator: torch.Generator, n_updates: int) -> Batch:
        """``n_updates`` gradient steps in place as one program (the JAX
        package's ``_build_update_many``, a scan); returns their stats stacked
        on a leading axis. The stats are the program's static output: the next
        call overwrites them. (One update per graph, replayed ``n_updates``
        times, took 1.5% longer per chunk on an H100: PERF.md.)"""
        return self._program(("update_burst", n_updates, self.params.batch_size), (ts, buf_state, generator),
                             generator, lambda: self._updates(ts, buf_state, generator, n_updates))()

    def collect_chunk(self, ts, cstate, buf_state, generator: torch.Generator, n_steps: int) -> Batch:
        """One collect chunk of ``n_steps`` steps per env, ``cstate`` and
        ``buf_state`` written in place (the JAX package's jitted ``collect``);
        returns the ``[T, E]`` per-step output, the program's static output."""
        keep = config.ENABLE_VALIDATION
        return self._program(
            ("collect_chunk", n_steps, keep), (ts, cstate, buf_state, generator), generator,
            lambda: self.train_collector.collect(ts, cstate, buf_state, generator, n_steps, keep_rollout=keep)[2],
        )()

    def megastep(self, ts, cstate, buf_state, generator: torch.Generator, n_steps: int,
                 n_updates: int) -> tuple[Batch, Batch]:
        """A collect chunk and then the update burst as ONE program (the JAX
        package's ``_build_megastep``); returns ``(collect output, stats)``."""
        keep = config.ENABLE_VALIDATION

        def fn() -> tuple[Batch, Batch]:
            out = self.train_collector.collect(ts, cstate, buf_state, generator, n_steps, keep_rollout=keep)[2]
            return out, self._updates(ts, buf_state, generator, n_updates)

        return self._program(("megastep", n_steps, keep, n_updates, self.params.batch_size),
                             (ts, cstate, buf_state, generator), generator, fn)()

    # ------------------------------------------------------------------
    def _log_update(self, stats: Batch) -> None:
        for k, v in stats.items():
            if v.dim() == 1 and v.is_floating_point():
                self._mov.setdefault(k, MovAvg()).add(v.cpu().numpy())

    def run(self, ts, buf_state, generator: torch.Generator) -> TrainResult:
        """Train in place; ``generator`` lives on the envs' device."""
        p = self.params
        coll = self.train_collector
        dev = coll.venv.device
        t0 = time.perf_counter()
        prefill_time = collect_time = update_time = 0.0
        # the collect programs close over one collect state: a new run resets it in place
        cstate = self._cstate = coll.reset(generator, into=self._cstate)
        E = coll.venv.num_envs
        T = p.collection_step_num_env_steps

        # prefill with uniform random actions (reference start_timesteps)
        if p.start_steps > 0:
            tc = time.perf_counter()
            for _ in range(int(np.ceil(p.start_steps / (T * E)))):
                coll.collect(ts, cstate, buf_state, generator, T, random=True)
                self.env_step += T * E
            _sync(dev)
            prefill_time = time.perf_counter() - tc

        n_updates = max(1, round(p.update_per_step * T * E))
        last_stats = None
        epoch = 0
        for epoch in range(1, p.max_epochs + 1):
            steps_this_epoch = 0
            while steps_this_epoch < p.epoch_num_steps:
                if p.train_fn is not None:
                    ts = self._apply_hparams(ts, p.train_fn(epoch, self.env_step))
                tc = time.perf_counter()
                if p.fused_megastep:
                    out, last_stats = self.megastep(ts, cstate, buf_state, generator, T, n_updates)
                else:
                    out = self.collect_chunk(ts, cstate, buf_state, generator, T)
                _sync(dev)
                collect_time += time.perf_counter() - tc
                if config.ENABLE_VALIDATION:
                    _validate_collect(out)
                self.env_step += T * E
                steps_this_epoch += T * E
                if not p.fused_megastep:
                    tu = time.perf_counter()
                    last_stats = self.update_burst(ts, buf_state, generator, n_updates)
                    _sync(dev)
                    update_time += time.perf_counter() - tu
                self.gradient_step += n_updates
                self._log_update(last_stats)
            if p.verbose:
                smoothed = ", ".join(f"{k} {m.get():.4g}" for k, m in self._mov.items())
                print(f"Epoch {epoch}: env_step {self.env_step}, gradient_step {self.gradient_step}, {smoothed}")
        return TrainResult(
            env_step=self.env_step,
            gradient_step=self.gradient_step,
            epochs=epoch,
            train_time=time.perf_counter() - t0,
            timing={"prefill": prefill_time, "collect": collect_time, "update": update_time},
            train_state=ts,
            buf_state=buf_state,
            update_stats={k: m.get() for k, m in self._mov.items()},
            # a copy: the stats are a program's static output, which the next replay overwrites
            last_chunk_stats=None if last_stats is None else last_stats.map(torch.clone),
        )


def _validate_collect(out: Batch) -> None:
    """NaN screen of collected data, gated by ENABLE_VALIDATION (reference
    collector.py:515-525, trainer.py:953)."""
    bad = []

    def visit(b: Batch, prefix: str) -> None:
        for k, v in b.items():
            if isinstance(v, Batch):
                visit(v, f"{prefix}{k}/")
            elif v.is_floating_point() and bool(torch.isnan(v).any()):
                bad.append(f"{prefix}{k}")

    visit(out, "")
    if bad:
        raise ValueError(f"NaN detected in collected data at keys {bad} (ENABLE_VALIDATION integrity check)")
