"""Trainers (port of ``tianshou_tpu/trainer/trainer.py``; reference
``tianshou/trainer.py``: ``TrainerParams`` :81, ``OfflineTrainer`` :780,
``OffPolicyTrainer`` :1043, ``OnPolicyTrainer`` :1098).

The epoch and update cadence are the JAX package's. Off-policy: after an
optional prefill (uniform random actions, or the policy's with
``start_random=False``), each chunk collects ``collection_step_num_env_steps``
steps from every env and then takes ``round(update_per_step * T * E)``
gradient steps. On-policy: each chunk collects a rollout of T steps per env
(``keep_rollout=True``, no replay buffer) and ``update_rollout`` takes
``update_step_num_repetitions`` passes of shuffled minibatches over it.
Offline: each epoch takes ``update_step_num_gradient_steps_per_epoch``
gradient steps from a fixed buffer and collects nothing. The
host reads back only the per-chunk episode and loss statistics. At the end
of each epoch a test phase collects ``test_step_num_episodes`` episodes with
the test collector (``training=False``), under the train envs' pooled
observation statistics where the envs normalize observations (``NormObs``),
tracks the best score and calls ``save_best_fn``, ``stop_fn``, the logger
and ``save_checkpoint_fn``; with ``test_in_train`` a chunk whose training
episodes meet ``stop_fn`` triggers a test and may stop early. ``test_fn``'s
overrides hold for the test phase only. The loggers
(:mod:`tianshou_tpu_torch.utils.logger`) and the determinism trace
(:mod:`tianshou_tpu_torch.utils.determinism`, lines ``collector``,
``trainer/collect`` and ``trainer/update``) are the JAX package's. What the
two trainers share (the test phase, hyper-parameters, logging, counters and
programs) is :class:`_TrainerBase`, as in the JAX package.

The JAX package jits the collect chunk, the update burst (on-policy: the
rollout update), the test chunk and with ``fused_megastep`` collect and
burst as one program; the offline trainer jits the epoch's updates as one
scan. Here they are the trainers' programs
(:meth:`_TrainerBase.collect_chunk`, :meth:`OffPolicyTrainer.update_burst`,
:meth:`OnPolicyTrainer.update_rollout`, :meth:`_TrainerBase.test_chunk` and
:meth:`OffPolicyTrainer.megastep`), each a CUDA graph on the card
(:class:`tianshou_tpu_torch.utils.graph.Graphed`): a program's first call
runs eagerly as its warm-up and counts as work done, its second captures and
replays it, every later call replays it. A program is built once per trainer
and per state it closes over (train state, buffer state, collect state, the
test collector's episode state, the rollout it updates from, generator), so
a second ``run`` on the same states replays what the first captured; the
on-policy update reads the collect graph's static rollout, so it is built
again once, when the collect chunk's capture replaces its eager output. A
rollout update of more than :attr:`OnPolicyTrainer.STEP_GRAPHS_ABOVE`
gradient steps runs eagerly instead, each minibatch step a replayed graph of
one step (:class:`~tianshou_tpu_torch.utils.graph.StepGraphs`), from the
first rollout on. All
other graphs of a trainer share one memory pool, and train and test programs
never run at the same time. A replay does only device work, so whatever the JAX
package does on the host after a jitted call (trace lines,
``on_episode_done_hook``, logger writes) runs here after the replay. On the
CPU the same code runs eagerly. The random prefill stays eager. An offline
epoch runs as bursts of ``OfflineTrainer.BURST`` updates, one
graph replayed, and one burst of the remainder, so that no graph holds the
reference's 10,000 updates of an epoch and the count is the JAX trainer's.

The host trainers (:class:`HostOffPolicyTrainer`, :class:`HostOnPolicyTrainer`,
``tianshou_tpu/trainer/trainer.py:614-846``) train over host envs through a
:class:`tianshou_tpu_torch.data.host_collector.HostCollector`: the collect
is host code that moves each step's observations to the device, and the
update burst and the rollout update are the same programs as above.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from tianshou_tpu_torch import config
from tianshou_tpu_torch.data.batch import Batch
from tianshou_tpu_torch.data.collector import CollectStats, DeviceCollector, EpisodeState
from tianshou_tpu_torch.env.wrappers import extract_pooled_rms
from tianshou_tpu_torch.utils.determinism import TraceLogger, trace_param_hash
from tianshou_tpu_torch.utils.graph import Graphed, GraphPool, StepGraphs
from tianshou_tpu_torch.utils.print import DataclassPPrintMixin
from tianshou_tpu_torch.utils.progress import progress_bar
from tianshou_tpu_torch.utils.statistics import MovAvg
from tianshou_tpu_torch.utils.tree import tree_map

__all__ = ["HostOffPolicyTrainer", "HostOnPolicyTrainer", "OfflineTrainer", "OfflineTrainerParams", "OffPolicyTrainer",
           "OffPolicyTrainerParams", "OnPolicyTrainer", "OnPolicyTrainerParams", "TrainResult", "TrainerParams"]


@dataclasses.dataclass
class TrainerParams(DataclassPPrintMixin):
    """Common knobs (reference trainer.py:81)."""

    max_epochs: int = 10
    epoch_num_steps: int = 10000          # env steps per epoch (total across envs)
    test_step_num_episodes: int = 10
    stop_fn: Callable[[float], bool] | None = None
    compute_score_fn: Callable[[CollectStats], float] | None = None
    #: called with the live train state when the test score improves; the next update writes its tensors in place
    save_best_fn: Callable[[Any], None] | None = None
    save_checkpoint_fn: Callable[[int, int, int, Any], None] | None = None
    train_fn: Callable[[int, int], dict] | None = None   # -> hparam overrides
    test_fn: Callable[[int, int], dict] | None = None    # -> hparam overrides for the test phase only
    logger: Any = None
    verbose: bool = True
    show_progress: bool = False
    test_in_train: bool = False
    resume_from_log: bool = False   # restore epoch/step counters (trainer.py:448)
    seed: int = 0                   # the host trainers' first env reset (HostOffPolicyTrainer, HostOnPolicyTrainer)


@dataclasses.dataclass
class OffPolicyTrainerParams(TrainerParams):
    batch_size: int = 64
    collection_step_num_env_steps: int = 10   # steps per env per collect chunk
    update_per_step: float = 1.0              # grad steps per collected env step
    start_steps: int = 0                      # prefill before learning
    start_random: bool = True                 # prefill with uniform random actions, else the policy's
    # collect and the update burst as ONE program per chunk (one CUDA graph on
    # the card); the burst follows the collect, so the actor's params stay
    # chunk-stale as in the sequential loop (tianshou_tpu trainer.py:76)
    fused_megastep: bool = False
    # host path only: launch the chunk's gradient steps from the collector's
    # step hook, so that the device runs them while the host steps the envs;
    # the chunk acts on a copy of its start's parameters, as the sequential
    # loop does (tianshou_tpu trainer.py:84)
    overlap_updates: bool = False


@dataclasses.dataclass
class OnPolicyTrainerParams(TrainerParams):
    batch_size: int = 64
    collection_step_num_env_steps: int = 128  # rollout length per env
    update_step_num_repetitions: int = 1      # passes over each rollout


@dataclasses.dataclass
class OfflineTrainerParams(TrainerParams):
    batch_size: int = 64
    update_step_num_gradient_steps_per_epoch: int = 500


@dataclasses.dataclass
class TrainResult(DataclassPPrintMixin):
    """Summary, mirroring reference InfoStats (data/stats.py:83)."""

    best_score: float
    best_reward: float
    env_step: int
    gradient_step: int
    epochs: int
    train_time: float
    #: seconds of the collect, update and test phases (off-policy: and the random prefill)
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


def _flat_scalars(stats: Batch, prefix: str = "") -> dict[str, np.ndarray]:
    """A (possibly nested) stats Batch as numeric numpy arrays by flat key."""
    out: dict[str, np.ndarray] = {}
    for k, v in stats.items():
        name = f"{prefix}{k}"
        if isinstance(v, Batch):
            out.update(_flat_scalars(v, f"{name}/"))
        elif v.numel() and v.dtype != torch.bool:
            out[name] = v.detach().cpu().numpy()
    return out


def _stack_stats(stats: list[Batch]) -> Batch:
    """The stats of consecutive updates stacked on a leading axis; a nested
    Batch (a multi-agent update's per-agent stats) key by key."""
    return Batch({k: _stack_stats([s[k] for s in stats]) if isinstance(v, Batch) else torch.stack([s[k] for s in stats])
                  for k, v in stats[0].items()})


class _TrainerBase:
    """What both trainers share (the JAX package's ``_TrainerBase``): the
    counters, the hyper-parameter writes, the programs and their graph pool,
    the test phase with its observation-statistics handoff, the best score,
    and the logger writes. ``test_collector=None`` runs no test phase: no
    best score, no stop."""

    def __init__(self, algo, train_collector: DeviceCollector | None, test_collector: DeviceCollector | None,
                 params: TrainerParams) -> None:
        self.algo = algo
        self.train_collector = train_collector
        self.test_collector = test_collector
        self.params = params
        self.env_step = 0
        self.gradient_step = 0   # the host's mirror of the train state's step counter
        self.start_epoch = 0
        self.best_reward = -np.inf
        self.best_score = -np.inf
        self._mov: dict[str, MovAvg] = {}
        #: the memory pool and the graphs of this trainer's programs (made at the first program)
        self.graph_pool: GraphPool | None = None
        self._programs: dict[tuple, tuple[tuple, Graphed]] = {}
        self._cstate = None
        self._ts = None
        self._epoch = 0
        if params.resume_from_log and params.logger is not None:
            self.start_epoch, self.env_step, self.gradient_step = params.logger.restore_data()

    def _apply_hparams(self, ts, overrides: dict | None):
        """Write overrides into the hparams' device scalars in place, where the
        captured programs read them."""
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
                self.graph_pool = GraphPool(generator.device)
            elif held is not None:
                self.graph_pool.graphs.remove(held[1])
            held = (states, Graphed(fn, self.graph_pool, (generator,), name=" ".join(map(str, key))))
            self._programs[key] = held
        return held[1]

    def collect_chunk(self, ts, cstate, buf_state, generator: torch.Generator, n_steps: int,
                      keep_rollout: bool | None = None) -> Batch:
        """One collect chunk of ``n_steps`` steps per env, ``cstate`` and
        ``buf_state`` written in place (the device work of the JAX package's
        ``collect``); returns the ``[T, E]`` per-step output, the program's
        static output, with the transitions under ``rollout`` when
        ``keep_rollout`` (default: ``config.ENABLE_VALIDATION``). Its host
        side, ``train_collector.report``, is the caller's."""
        keep = config.ENABLE_VALIDATION if keep_rollout is None else keep_rollout
        return self._program(
            ("collect_chunk", n_steps, keep), (ts, cstate, buf_state, generator), generator,
            lambda: self.train_collector.rollout(ts, cstate, buf_state, generator, n_steps, keep_rollout=keep),
        )()

    def test_chunk(self, ts, state: EpisodeState, generator: torch.Generator, chunk_steps: int,
                   training: bool = False) -> Batch:
        """One chunk of the test collector's ``collect_episodes`` as a program
        (the JAX package's jitted chunk): ``state`` (the collect state, the
        active mask and the episode counts) written in place; returns the
        ``[T, E]`` output, the program's static output."""
        return self._program(
            ("test_chunk", chunk_steps, training), (ts, state, generator), generator,
            lambda: self.test_collector.episode_chunk(ts, state, generator, chunk_steps, training),
        )()

    # ------------------------------------------------------------------
    # host side: test phase, scores, logging
    # ------------------------------------------------------------------
    def _test(self, ts, generator: torch.Generator) -> CollectStats:
        """``test_step_num_episodes`` episodes with ``training=False``, under
        the train envs' pooled observation statistics where their envs
        normalize observations (``tianshou_tpu/trainer/trainer.py:208-221``).
        ``test_fn``'s overrides hold for this phase only: the JAX package
        applies them to a copy of the train state; here they are written in
        place and the values they replaced are written back afterwards (a key
        that only ``test_fn`` sets keeps its value)."""
        p = self.params
        rms = None
        if self._cstate is not None:
            rms = extract_pooled_rms(self.train_collector.venv.env, self._cstate.env_state)
        with self._test_hparams(ts):
            return self.test_collector.collect_episodes(ts, generator, p.test_step_num_episodes, training=False,
                                                        rms=rms, chunk_fn=self.test_chunk)

    @contextlib.contextmanager
    def _test_hparams(self, ts):
        """``test_fn``'s overrides written into the train state for the
        block, the values they replaced written back after it."""
        p = self.params
        saved = {}
        if p.test_fn is not None:
            overrides = p.test_fn(self._epoch, self.env_step) or {}
            saved = {k: ts.hparams[k].clone() for k in overrides if k in ts.hparams}
            self._apply_hparams(ts, overrides)
        try:
            yield
        finally:
            for k, v in saved.items():
                ts.hparams[k].copy_(v)

    def _score(self, stats: CollectStats) -> float:
        if self.params.compute_score_fn is not None:
            return self.params.compute_score_fn(stats)
        return float(stats.returns.mean()) if len(stats.returns) else -np.inf

    def _log_test(self, stats: CollectStats, epoch: int) -> bool:
        """Track the best score; returns True if the stop condition is met."""
        rew = float(stats.returns.mean()) if len(stats.returns) else -np.inf
        score = self._score(stats)
        if score > self.best_score:
            self.best_score = score
            self.best_reward = rew
            if self.params.save_best_fn is not None:
                self.params.save_best_fn(self._ts)
        if self.params.logger is not None:
            self.params.logger.log_test_data(
                {"test/reward": rew, "test/reward_std": float(stats.returns.std()) if len(stats.returns) else 0.0,
                 "test/length": float(stats.lens.mean()) if len(stats.lens) else 0.0,
                 "test/n_episodes": stats.n_collected_episodes},
                self.env_step,
            )
        if self.params.verbose:
            print(f"Epoch {epoch}: test_reward {rew:.2f} (best {self.best_reward:.2f}), env_step {self.env_step}")
        return self.params.stop_fn is not None and self.params.stop_fn(rew)

    def _log_update(self, stats: Batch) -> None:
        """MovAvg-smoothed update statistics, to the logger at the update
        scope (reference trainer.py:731-754 via log_update_data)."""
        TraceLogger.log("trainer/update",
                        lambda: f"gradient_step={self.gradient_step} params={trace_param_hash(self._ts)}")
        data = {f"update/{k}": self._mov.setdefault(k, MovAvg()).add(arr) for k, arr in _flat_scalars(stats).items()}
        if self.params.logger is not None and data:
            self.params.logger.log_update_data(data, self.gradient_step)

    def _log_info(self, epoch: int, t0: float, timing: dict) -> None:
        """Epoch InfoStats/TimingStats (reference trainer.py:531-572,
        data/stats.py:65-121) at the info scope."""
        if self.params.logger is None:
            return
        data = {
            "info/env_step": self.env_step,
            "info/gradient_step": self.gradient_step,
            "info/best_reward": self.best_reward,
            "info/best_score": self.best_score,
            "timing/total_time": time.perf_counter() - t0,
        }
        for k, v in timing.items():
            data[f"timing/{k}_time"] = v
        if timing.get("collect", 0.0) + timing.get("update", 0.0) > 0:
            data["timing/update_speed"] = self.gradient_step / max(timing.get("update", 0.0), 1e-9)
        self.params.logger.log_info_data(data, epoch)

    def _save_counters(self, epoch: int) -> None:
        if self.params.logger is not None:
            self.params.logger.save_data(epoch, self.env_step, self.gradient_step)

    def _after_collect(self, out: Batch, n_steps: int, epoch: int, pbar, test: Callable[[], CollectStats]) -> bool:
        """The host side of a training chunk's collect (the collector's
        report, the NaN screen, the counters, the trace line, the train
        reward write) and ``test_in_train``: returns True when a test that
        the chunk's training episodes called for meets the stop condition
        (reference trainer.py:978)."""
        p = self.params
        coll = self.train_collector
        E = coll.venv.num_envs
        if config.ENABLE_VALIDATION:
            _validate_collect(out)
        self.env_step += n_steps * E
        TraceLogger.log("trainer/collect", lambda: f"env_step={self.env_step} episodes={int(out.done.sum())}")
        pbar.update(n_steps * E)
        stats = None
        if p.logger is not None or p.test_in_train:
            stats = coll.stats_from(out)
        if p.logger is not None and stats.n_collected_episodes:
            p.logger.log_train_data(
                {"train/reward": float(stats.returns.mean()), "train/length": float(stats.lens.mean())},
                self.env_step,
            )
        return bool(p.test_in_train and p.stop_fn is not None and self.test_collector is not None
                    and stats.n_collected_episodes > 0 and p.stop_fn(float(stats.returns.mean()))
                    and self._log_test(test(), epoch))

    def _end_epoch(self, epoch: int, t0: float, timing: dict, ts, test: Callable[[], CollectStats]) -> bool:
        """The epoch's test phase, info and counter writes and checkpoint;
        returns True when the test meets the stop condition."""
        p = self.params
        if p.verbose:
            smoothed = ", ".join(f"{k} {m.get():.4g}" for k, m in self._mov.items())
            print(f"Epoch {epoch}: env_step {self.env_step}, gradient_step {self.gradient_step}, {smoothed}")
        stop = False
        if self.test_collector is not None:
            stop = self._log_test(test(), epoch)
        self._log_info(epoch, t0, {k: timing[k] for k in ("collect", "update", "test")})
        self._save_counters(epoch)
        if p.save_checkpoint_fn is not None:
            p.save_checkpoint_fn(epoch, self.env_step, self.gradient_step, ts)
        return stop

    def _result(self, epoch: int, t0: float, timing: dict, ts, buf_state, last_stats: Batch | None) -> TrainResult:
        return TrainResult(
            best_score=self.best_score,
            best_reward=self.best_reward,
            env_step=self.env_step,
            gradient_step=self.gradient_step,
            epochs=epoch,
            train_time=time.perf_counter() - t0,
            timing=dict(timing),
            train_state=ts,
            buf_state=buf_state,
            update_stats={k: m.get() for k, m in self._mov.items()},
            last_chunk_stats=last_stats,
        )


class _ReplayUpdates:
    """The update burst of the trainers that sample a replay buffer
    (``self.buffer``): the off-policy and the offline trainer."""

    def _updates(self, ts, buf_state, generator: torch.Generator, n_updates: int) -> Batch:
        return _stack_stats([self.algo.update(ts, self.buffer, buf_state, generator, self.params.batch_size)[2]
                             for _ in range(n_updates)])

    def update_burst(self, ts, buf_state, generator: torch.Generator, n_updates: int) -> Batch:
        """``n_updates`` gradient steps in place as one program (the JAX
        package's ``_build_update_many``, a scan); returns their stats stacked
        on a leading axis. The stats are the program's static output: the next
        call overwrites them. (One update per graph, replayed ``n_updates``
        times, took 1.5% longer per chunk on an H100: PERF.md.)"""
        return self._program(("update_burst", n_updates, self.params.batch_size), (ts, buf_state, generator),
                             generator, lambda: self._updates(ts, buf_state, generator, n_updates))()


class OffPolicyTrainer(_ReplayUpdates, _TrainerBase):
    """Collect chunk -> burst of gradient steps, repeated; a test phase at the
    end of each epoch (reference :1043)."""

    def __init__(self, algo, train_collector: DeviceCollector, test_collector: DeviceCollector | None,
                 buffer, params: OffPolicyTrainerParams) -> None:
        super().__init__(algo, train_collector, test_collector, params)
        self.buffer = buffer

    # ------------------------------------------------------------------
    # programs
    # ------------------------------------------------------------------

    def megastep(self, ts, cstate, buf_state, generator: torch.Generator, n_steps: int,
                 n_updates: int) -> tuple[Batch, Batch]:
        """A collect chunk and then the update burst as ONE program (the JAX
        package's ``_build_megastep``); returns ``(collect output, stats)``."""
        keep = config.ENABLE_VALIDATION

        def fn() -> tuple[Batch, Batch]:
            out = self.train_collector.rollout(ts, cstate, buf_state, generator, n_steps, keep_rollout=keep)
            return out, self._updates(ts, buf_state, generator, n_updates)

        return self._program(("megastep", n_steps, keep, n_updates, self.params.batch_size),
                             (ts, cstate, buf_state, generator), generator, fn)()

    # ------------------------------------------------------------------
    def run(self, ts, buf_state, generator: torch.Generator) -> TrainResult:
        """Train in place; ``generator`` lives on the envs' device."""
        p = self.params
        coll = self.train_collector
        dev = coll.venv.device
        t0 = time.perf_counter()
        timing = dict.fromkeys(("prefill", "collect", "update", "test"), 0.0)
        # the collect programs close over one collect state: a new run resets it in place
        cstate = self._cstate = coll.reset(generator, into=self._cstate)
        E = coll.venv.num_envs
        T = p.collection_step_num_env_steps
        self._ts = ts

        # prefill (reference start_timesteps / RandomActionPolicy, experiment.py:444, collector.py:724)
        if p.start_steps > 0:
            tc = time.perf_counter()
            for _ in range(int(np.ceil(p.start_steps / (T * E)))):
                coll.collect(ts, cstate, buf_state, generator, T, random=p.start_random)
                self.env_step += T * E
            _sync(dev)
            timing["prefill"] = time.perf_counter() - tc

        def test() -> CollectStats:
            tt = time.perf_counter()
            stats = self._test(ts, generator)
            timing["test"] += time.perf_counter() - tt
            return stats

        n_updates = max(1, round(p.update_per_step * T * E))
        last_stats = None
        epoch = self.start_epoch
        for epoch in range(self.start_epoch + 1, p.max_epochs + 1):
            self._epoch = epoch
            steps_this_epoch = 0
            pbar = progress_bar(p.epoch_num_steps, f"epoch {epoch}", p.show_progress)
            while steps_this_epoch < p.epoch_num_steps:
                if p.train_fn is not None:
                    self._apply_hparams(ts, p.train_fn(epoch, self.env_step))
                tc = time.perf_counter()
                if p.fused_megastep:
                    out, burst = self.megastep(ts, cstate, buf_state, generator, T, n_updates)
                else:
                    out = self.collect_chunk(ts, cstate, buf_state, generator, T)
                _sync(dev)
                timing["collect"] += time.perf_counter() - tc
                if not p.fused_megastep:  # the JAX megastep steps the envs itself, without collect's report
                    coll.report(out, T, training=True)
                steps_this_epoch += T * E
                if self._after_collect(out, T, epoch, pbar, test):
                    pbar.close()
                    return self._result(epoch, t0, timing, ts, buf_state, last_stats)
                if not p.fused_megastep:
                    tu = time.perf_counter()
                    burst = self.update_burst(ts, buf_state, generator, n_updates)
                    _sync(dev)
                    timing["update"] += time.perf_counter() - tu
                self.gradient_step += n_updates
                # a copy: the burst's stats are a graph's output, which the next replay of a program
                # captured before it may overwrite
                last_stats = burst.map(torch.clone)
                self._log_update(last_stats)
            pbar.close()
            if self._end_epoch(epoch, t0, timing, ts, test):
                break
        return self._result(epoch, t0, timing, ts, buf_state, last_stats)


class OnPolicyTrainer(_TrainerBase):
    """Rollout -> ``update_step_num_repetitions`` passes of shuffled
    minibatches over it, repeated; a test phase at the end of each epoch
    (reference :1098). The rollout never touches a replay buffer: the
    collect chunk keeps it (``keep_rollout=True``) and
    :meth:`update_rollout` reads it where the chunk wrote it."""

    #: the most gradient steps a rollout's update takes as one program; above it the update runs eagerly and each
    #: minibatch step replays a graph of one step (:class:`StepGraphs`): a graph of the whole update would hold
    #: kernels x steps nodes (``mujoco_ppo_hl.py``: about 190 x 20,480) and take the eager run's host time again to
    #: capture
    STEP_GRAPHS_ABOVE = 1_000
    #: the last step-graph update's :class:`StepGraphs`, whose graphs are gone, for its counts
    step_graphs: StepGraphs | None = None

    def update_rollout(self, ts, rollout: Batch, generator: torch.Generator) -> Batch:
        """``algo.update_rollout`` over ``rollout`` in place as one program
        (the JAX package's jitted ``update_rollout``), or, above
        :attr:`STEP_GRAPHS_ABOVE` gradient steps, eagerly with step graphs;
        returns the averaged stats, the program's static output."""
        p = self.params
        repeat, batch_size = p.update_step_num_repetitions, p.batch_size
        if self.algo.rollout_grad_steps(rollout.rew.shape[0] * rollout.rew.shape[1], repeat,
                                        batch_size) > self.STEP_GRAPHS_ABOVE:
            self.step_graphs = StepGraphs(generator.device, (generator,))
            with self.step_graphs:
                return self.algo.update_rollout(ts, rollout, generator, repeat, batch_size)[1]
        return self._program(
            ("update_rollout", repeat, batch_size), (ts, rollout, generator), generator,
            lambda: self.algo.update_rollout(ts, rollout, generator, repeat, batch_size)[1],
        )()

    def run(self, ts, generator: torch.Generator) -> TrainResult:
        """Train in place; ``generator`` lives on the envs' device."""
        p = self.params
        coll = self.train_collector
        dev = coll.venv.device
        t0 = time.perf_counter()
        timing = dict.fromkeys(("collect", "update", "test"), 0.0)
        cstate = self._cstate = coll.reset(generator, into=self._cstate)
        E = coll.venv.num_envs
        T = p.collection_step_num_env_steps
        n_grad = self.algo.rollout_grad_steps(T * E, p.update_step_num_repetitions, p.batch_size)
        self._ts = ts

        def test() -> CollectStats:
            tt = time.perf_counter()
            stats = self._test(ts, generator)
            timing["test"] += time.perf_counter() - tt
            return stats

        last_stats = None
        epoch = self.start_epoch
        for epoch in range(self.start_epoch + 1, p.max_epochs + 1):
            self._epoch = epoch
            steps_this_epoch = 0
            pbar = progress_bar(p.epoch_num_steps, f"epoch {epoch}", p.show_progress)
            while steps_this_epoch < p.epoch_num_steps:
                if p.train_fn is not None:
                    self._apply_hparams(ts, p.train_fn(epoch, self.env_step))
                tc = time.perf_counter()
                out = self.collect_chunk(ts, cstate, None, generator, T, keep_rollout=True)
                _sync(dev)
                timing["collect"] += time.perf_counter() - tc
                coll.report(out, T, training=True)
                steps_this_epoch += T * E
                if self._after_collect(out, T, epoch, pbar, test):
                    pbar.close()
                    return self._result(epoch, t0, timing, ts, None, last_stats)
                tu = time.perf_counter()
                stats = self.update_rollout(ts, out.rollout, generator)
                _sync(dev)
                timing["update"] += time.perf_counter() - tu
                self.gradient_step += n_grad
                last_stats = stats.map(torch.clone)  # a graph's output: the next replay overwrites it
                self._log_update(last_stats)
            pbar.close()
            if self._end_epoch(epoch, t0, timing, ts, test):
                break
        return self._result(epoch, t0, timing, ts, None, last_stats)


class OfflineTrainer(_ReplayUpdates, _TrainerBase):
    """Fixed-dataset training (reference :780; ``tianshou_tpu/trainer/trainer.py:556``):
    each epoch takes ``update_step_num_gradient_steps_per_epoch`` gradient
    steps from ``buffer``, as bursts of :attr:`BURST` updates (one CUDA graph
    on the card, replayed) and one burst of the remainder,
    then runs the test phase, ``stop_fn``, the logger's writes and
    ``save_checkpoint_fn``. Nothing is collected: the result's ``env_step`` is
    0 and its ``timing`` empty, as the JAX trainer's."""

    #: the updates of one replayed CUDA graph: a graph of a whole 10,000-update epoch (the reference's Atari
    #: scripts) would hold millions of nodes, and a capture's cost grows with it (PERF.md says why 100)
    BURST = 100

    def __init__(self, algo, buffer, test_collector: DeviceCollector | None, params: OfflineTrainerParams) -> None:
        super().__init__(algo, None, test_collector, params)
        self.buffer = buffer

    def bursts(self) -> list[int]:
        """The update bursts of one epoch, in order."""
        n, k = self.params.update_step_num_gradient_steps_per_epoch, self.BURST
        return [k] * (n // k) + ([n % k] if n % k else [])

    def run(self, ts, buf_state, generator: torch.Generator) -> TrainResult:
        """Train in place; ``generator`` lives on the buffer's device."""
        p = self.params
        dev = generator.device
        t0 = time.perf_counter()
        self._ts = ts
        last_stats = None
        epoch = self.start_epoch
        for epoch in range(self.start_epoch + 1, p.max_epochs + 1):
            self._epoch = epoch
            # copies: a burst's stats are a graph's output, which its next replay overwrites
            bursts = [self.update_burst(ts, buf_state, generator, n).map(torch.clone) for n in self.bursts()]
            _sync(dev)
            self.gradient_step += p.update_step_num_gradient_steps_per_epoch
            last_stats = Batch({k: torch.cat([b[k] for b in bursts]) for k in bursts[0].keys()})
            self._log_update(last_stats)
            stop = False
            if self.test_collector is not None:
                stop = self._log_test(self._test(ts, generator), epoch)
            self._log_info(epoch, t0, {})
            self._save_counters(epoch)
            if p.save_checkpoint_fn is not None:
                p.save_checkpoint_fn(epoch, self.env_step, self.gradient_step, ts)
            if stop:
                break
        result = self._result(epoch, t0, {}, ts, buf_state, last_stats)
        result.env_step = 0
        return result


class _HostTrainerMixin:
    """What the two host trainers share: the first env reset from
    ``params.seed``, the test phase through the host test collector
    (``n_episode`` from a reset, ``test_fn``'s overrides for the phase only),
    and the host side of a training collect."""

    def _test(self, ts, generator: torch.Generator) -> CollectStats:
        with self._test_hparams(ts):
            return self.test_collector.collect(ts, generator, n_episode=self.params.test_step_num_episodes,
                                               training=False, reset_before_collect=True)

    def _start(self, ts) -> None:
        if self.train_collector._obs is None:
            self.train_collector.reset(seed=self.params.seed)
        self._ts = ts

    def _after_host_collect(self, stats: CollectStats, pbar) -> None:
        self.env_step += stats.n_collected_steps
        pbar.update(stats.n_collected_steps)
        if self.params.logger is not None and stats.n_collected_episodes:
            self.params.logger.log_train_data(
                {"train/reward": float(stats.returns.mean()), "train/length": float(stats.lens.mean())},
                self.env_step)


class HostOffPolicyTrainer(_HostTrainerMixin, OffPolicyTrainer):
    """Off-policy training over host envs (the JAX package's
    ``HostOffPolicyTrainer``, ``tianshou_tpu/trainer/trainer.py:720-846``):
    the epoch, test and stop semantics of :class:`OffPolicyTrainer`, with
    collection through a :class:`tianshou_tpu_torch.data.host_collector.HostCollector`
    (or a pipelined or async one) that writes the device buffer, and the
    update burst on the device (a CUDA graph on the card). Each chunk
    collects ``collection_step_num_env_steps * len(venv)`` env steps, then
    takes ``round(update_per_step * that)`` gradient steps.

    ``overlap_updates``: the chunk's gradient steps are launched one at a
    time from the collector's step hook (one graph of one update, replayed),
    so that the device runs them while the host steps the envs; the rest run
    after the collect, so a chunk takes as many steps as in the sequential
    loop. The updates change the parameters in place, so the chunk acts on a
    copy of its start's parameters, as the JAX chunk's forwards read the
    chunk-start train state."""

    def __init__(self, algo, train_collector, test_collector, buffer, params: OffPolicyTrainerParams) -> None:
        super().__init__(algo, train_collector, test_collector, buffer, params)
        self._act_model = None

    def _acting_state(self, ts):
        """The train state with its model replaced by a copy of the current
        parameters (the copy is made once and written in place after)."""
        if self._act_model is None:
            self._act_model = copy.deepcopy(ts.model).requires_grad_(False)
        with torch.no_grad():
            for dst, src in zip(self._act_model.state_dict().values(), ts.model.state_dict().values()):
                dst.copy_(src)
        return dataclasses.replace(ts, model=self._act_model)

    def _overlapped_chunk(self, ts, generator: torch.Generator, n_steps: int, n_updates: int):
        """One chunk with its updates launched from the step hook; returns
        (collect stats, the last update's stats)."""
        p, tc = self.params, self.train_collector
        st = {"pend": 0.0, "n": 0, "stats": None}

        def one() -> None:
            st["stats"] = self.update_burst(ts, tc.buf_state, generator, 1)
            st["n"] += 1

        def hook(n_env_steps: int) -> None:
            st["pend"] += p.update_per_step * n_env_steps
            while st["pend"] >= 1.0 and st["n"] < n_updates:
                st["pend"] -= 1.0
                one()

        tc.step_hook = hook
        try:
            stats = tc.collect(self._acting_state(ts), generator, n_step=n_steps)
        finally:
            tc.step_hook = None
        while st["n"] < n_updates:  # the rounding remainder: the sequential loop's count per chunk
            one()
        return stats, st["stats"]

    def run(self, ts, buf_state, generator: torch.Generator) -> TrainResult:
        """Train in place; ``generator`` lives on the collector's device."""
        p, tc = self.params, self.train_collector
        dev = tc.device
        t0 = time.perf_counter()
        timing = dict.fromkeys(("prefill", "collect", "update", "test"), 0.0)
        tc.buf_state = buf_state
        self._start(ts)
        T = p.collection_step_num_env_steps * len(tc.venv)
        if p.start_steps > 0:
            tp = time.perf_counter()
            tc.collect(ts, generator, n_step=p.start_steps, random=p.start_random)
            self.env_step += p.start_steps
            _sync(dev)
            timing["prefill"] = time.perf_counter() - tp

        def test() -> CollectStats:
            tt = time.perf_counter()
            stats = self._test(ts, generator)
            timing["test"] += time.perf_counter() - tt
            return stats

        n_updates = max(1, round(p.update_per_step * T))
        last_stats = None
        epoch = self.start_epoch
        for epoch in range(self.start_epoch + 1, p.max_epochs + 1):
            self._epoch = epoch
            steps_this_epoch = 0
            pbar = progress_bar(p.epoch_num_steps, f"epoch {epoch}", p.show_progress)
            while steps_this_epoch < p.epoch_num_steps:
                if p.train_fn is not None:
                    self._apply_hparams(ts, p.train_fn(epoch, self.env_step))
                tc0 = time.perf_counter()
                if p.overlap_updates:
                    stats, burst = self._overlapped_chunk(ts, generator, T, n_updates)
                    timing["collect"] += time.perf_counter() - tc0
                    tu = time.perf_counter()
                    _sync(dev)  # what the env steps did not hide
                    timing["update"] += time.perf_counter() - tu
                else:
                    stats = tc.collect(ts, generator, n_step=T)
                    _sync(dev)
                    timing["collect"] += time.perf_counter() - tc0
                if config.ENABLE_VALIDATION:
                    _validate_collect(Batch(obs=tc._obs_dev))
                steps_this_epoch += stats.n_collected_steps
                self._after_host_collect(stats, pbar)
                if not p.overlap_updates:
                    tu = time.perf_counter()
                    burst = self.update_burst(ts, tc.buf_state, generator, n_updates)
                    _sync(dev)
                    timing["update"] += time.perf_counter() - tu
                self.gradient_step += n_updates
                last_stats = burst.map(torch.clone)  # a graph's output: the next replay overwrites it
                self._log_update(last_stats)
            pbar.close()
            if self._end_epoch(epoch, t0, timing, ts, test):
                break
        return self._result(epoch, t0, timing, ts, tc.buf_state, last_stats)


class HostOnPolicyTrainer(_HostTrainerMixin, OnPolicyTrainer):
    """On-policy training over host envs (the JAX package's
    ``HostOnPolicyTrainer``, ``tianshou_tpu/trainer/trainer.py:614-718``):
    rollouts from :meth:`HostCollector.collect_rollout`, moved to the device
    step by step, then ``update_rollout`` on the device (a CUDA graph on the
    card, over a rollout the trainer keeps and each chunk's rollout is
    copied into)."""

    def __init__(self, algo, train_collector, test_collector, params: OnPolicyTrainerParams) -> None:
        super().__init__(algo, train_collector, test_collector, params)
        self._rollout: Batch | None = None

    def _static_rollout(self, rollout: Batch) -> Batch:
        if self._rollout is None:
            self._rollout = rollout
        else:
            tree_map(torch.Tensor.copy_, self._rollout, rollout)
        return self._rollout

    def run(self, ts, generator: torch.Generator) -> TrainResult:
        """Train in place; ``generator`` lives on the collector's device."""
        p, tc = self.params, self.train_collector
        dev = tc.device
        t0 = time.perf_counter()
        timing = dict.fromkeys(("collect", "update", "test"), 0.0)
        self._start(ts)
        T = p.collection_step_num_env_steps
        n_grad = self.algo.rollout_grad_steps(T * len(tc.venv), p.update_step_num_repetitions, p.batch_size)

        def test() -> CollectStats:
            tt = time.perf_counter()
            stats = self._test(ts, generator)
            timing["test"] += time.perf_counter() - tt
            return stats

        last_stats = None
        epoch = self.start_epoch
        for epoch in range(self.start_epoch + 1, p.max_epochs + 1):
            self._epoch = epoch
            steps_this_epoch = 0
            pbar = progress_bar(p.epoch_num_steps, f"epoch {epoch}", p.show_progress)
            while steps_this_epoch < p.epoch_num_steps:
                if p.train_fn is not None:
                    self._apply_hparams(ts, p.train_fn(epoch, self.env_step))
                tc0 = time.perf_counter()
                rollout, stats = tc.collect_rollout(ts, generator, T)
                _sync(dev)
                timing["collect"] += time.perf_counter() - tc0
                if config.ENABLE_VALIDATION:
                    _validate_collect(rollout)
                steps_this_epoch += stats.n_collected_steps
                self._after_host_collect(stats, pbar)
                tu = time.perf_counter()
                upd = self.update_rollout(ts, self._static_rollout(rollout), generator)
                _sync(dev)
                timing["update"] += time.perf_counter() - tu
                self.gradient_step += n_grad
                last_stats = upd.map(torch.clone)
                self._log_update(last_stats)
            pbar.close()
            if self._end_epoch(epoch, t0, timing, ts, test):
                break
        return self._result(epoch, t0, timing, ts, None, last_stats)


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
