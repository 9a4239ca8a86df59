"""Statistics helpers (reference tianshou/utils/statistics.py).

``MovAvg`` (:7): the NaN/inf-banning moving average the trainer uses to
smooth update losses. A copy of ``tianshou_tpu/utils/statistics.py:MovAvg``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MovAvg"]


class MovAvg:
    def __init__(self, size: int = 100) -> None:
        self.size = size
        self.cache: list[float] = []

    def add(self, value) -> float:
        arr = np.asarray(value, dtype=np.float64).ravel()
        for v in arr:
            if not (np.isnan(v) or np.isinf(v)):
                self.cache.append(float(v))
        if self.size > 0 and len(self.cache) > self.size:
            self.cache = self.cache[-self.size:]
        return self.get()

    def get(self) -> float:
        return float(np.mean(self.cache)) if self.cache else 0.0

    def mean(self) -> float:
        return self.get()

    def std(self) -> float:
        return float(np.std(self.cache)) if self.cache else 0.0
