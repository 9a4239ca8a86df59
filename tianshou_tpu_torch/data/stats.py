"""Training statistics dataclasses (a copy of ``tianshou_tpu/data/stats.py``;
reference tianshou/data/stats.py): ``SequenceSummaryStats:18``,
``TimingStats:65``, ``InfoStats:83``, ``EpochStats:108``."""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["SequenceSummaryStats", "TimingStats", "InfoStats", "EpochStats"]


@dataclasses.dataclass
class SequenceSummaryStats:
    mean: float = 0.0
    std: float = 0.0
    max: float = 0.0
    min: float = 0.0

    @classmethod
    def from_sequence(cls, seq) -> SequenceSummaryStats:
        arr = np.asarray(seq, dtype=np.float64).ravel()
        if arr.size == 0:
            return cls()
        return cls(float(arr.mean()), float(arr.std()), float(arr.max()), float(arr.min()))


@dataclasses.dataclass
class TimingStats:
    total_time: float = 0.0
    train_time: float = 0.0
    train_time_collect: float = 0.0
    train_time_update: float = 0.0
    test_time: float = 0.0
    update_speed: float = 0.0


@dataclasses.dataclass
class InfoStats:
    gradient_step: int = 0
    env_step: int = 0
    epochs: int = 0
    best_score: float = 0.0
    best_reward: float = 0.0
    timing: TimingStats = dataclasses.field(default_factory=TimingStats)


@dataclasses.dataclass
class EpochStats:
    epoch: int = 0
    train_stat: Any = None
    test_stat: Any = None
    info_stat: InfoStats | None = None
