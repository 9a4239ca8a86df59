"""Off-policy trainer (port of ``tianshou_tpu/trainer/trainer.py``; reference
``tianshou/trainer.py``: ``TrainerParams`` :81, ``OffPolicyTrainer`` :1043).

The epoch and update cadence are the JAX package's: after an optional
random prefill, each chunk collects ``collection_step_num_env_steps`` steps
from every env and then takes ``round(update_per_step * T * E)`` gradient
steps. PyTorch runs eagerly, so collect and update run one after the other
on the device; the host reads back only the per-chunk episode and loss
statistics. Test episodes, loggers and the fused collect+update program of
the JAX package are not ported yet.
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
        self.gradient_step = 0
        self._mov: dict[str, MovAvg] = {}

    def _apply_hparams(self, ts, overrides: dict | None):
        if overrides:
            ts.hparams.update({k: float(v) for k, v in overrides.items()})
        return ts

    def _update_chunk(self, ts, buf_state, generator: torch.Generator, n_updates: int):
        stats = []
        for _ in range(n_updates):
            ts, buf_state, s = self.algo.update(ts, self.buffer, buf_state, generator,
                                                self.params.batch_size)
            stats.append(s)
        stacked = Batch({k: torch.stack([s[k] for s in stats]) for k in stats[0].keys()})
        for k, v in stacked.items():
            if v.dim() == 1 and v.is_floating_point():
                self._mov.setdefault(k, MovAvg()).add(v.cpu().numpy())
        return ts, buf_state, stacked

    def run(self, ts, buf_state, generator: torch.Generator) -> TrainResult:
        """Train in place; ``generator`` lives on the envs' device."""
        p = self.params
        coll = self.train_collector
        dev = coll.venv.device
        t0 = time.perf_counter()
        prefill_time = collect_time = update_time = 0.0
        cstate = coll.reset(generator)
        E = coll.venv.num_envs
        T = p.collection_step_num_env_steps

        # prefill with uniform random actions (reference start_timesteps)
        if p.start_steps > 0:
            tc = time.perf_counter()
            for _ in range(int(np.ceil(p.start_steps / (T * E)))):
                cstate, buf_state, _ = coll.collect(ts, cstate, buf_state, generator, T, random=True)
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
                cstate, buf_state, out = coll.collect(ts, cstate, buf_state, generator, T,
                                                      keep_rollout=config.ENABLE_VALIDATION)
                _sync(dev)
                collect_time += time.perf_counter() - tc
                if config.ENABLE_VALIDATION:
                    _validate_collect(out)
                self.env_step += T * E
                steps_this_epoch += T * E
                tu = time.perf_counter()
                ts, buf_state, last_stats = self._update_chunk(ts, buf_state, generator, n_updates)
                _sync(dev)
                update_time += time.perf_counter() - tu
                self.gradient_step += n_updates
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
            last_chunk_stats=last_stats,
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
