"""Statistics helpers (reference tianshou/utils/statistics.py).

``MovAvg`` (:7): the NaN/inf-banning moving average the trainer uses to
smooth update losses. A copy of ``tianshou_tpu/utils/statistics.py:MovAvg``,
with the filter of one added array written as one numpy operation.
``RunningMeanStd`` (:69): the parallel Welford update with clipping that
the host path's ``VectorEnvNormObs`` normalizes observations with (host
numpy, float64); the device path's normalizer is ``env/wrappers.py:NormObs``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["MovAvg", "RunningMeanStd"]


class MovAvg:
    def __init__(self, size: int = 100) -> None:
        self.size = size
        self.cache: list[float] = []

    def add(self, value) -> float:
        arr = np.asarray(value, dtype=np.float64).ravel()
        self.cache.extend(arr[np.isfinite(arr)].tolist())  # NaN and inf are left out
        if self.size > 0 and len(self.cache) > self.size:
            self.cache = self.cache[-self.size:]
        return self.get()

    def get(self) -> float:
        return float(np.mean(self.cache)) if self.cache else 0.0

    def mean(self) -> float:
        return self.get()

    def std(self) -> float:
        return float(np.std(self.cache)) if self.cache else 0.0


class RunningMeanStd:
    """Mean and variance over every array added, merged batch by batch
    (Chan et al.'s parallel update, reference statistics.py:69);
    :meth:`norm` standardizes and clips to ``[-clip_max, clip_max]``."""

    def __init__(self, mean=0.0, std=1.0, clip_max: float | None = 10.0, epsilon: float = 1e-8) -> None:
        self.mean = np.asarray(mean, np.float64)
        self.var = np.asarray(std, np.float64) ** 2
        self.clip_max = clip_max
        self.count = 0.0
        self.eps = epsilon

    def norm(self, arr):
        arr = (np.asarray(arr) - self.mean) / np.sqrt(self.var + self.eps)
        if self.clip_max:
            arr = np.clip(arr, -self.clip_max, self.clip_max)
        return arr

    def update(self, arr) -> None:
        arr = np.asarray(arr)
        batch_mean, batch_var = np.mean(arr, axis=0), np.var(arr, axis=0)
        batch_count = arr.shape[0]
        delta = batch_mean - self.mean
        total = self.count + batch_count
        new_mean = self.mean + delta * batch_count / total
        m2 = self.var * self.count + batch_var * batch_count + delta**2 * self.count * batch_count / total
        self.mean, self.var, self.count = new_mean, m2 / total, total
