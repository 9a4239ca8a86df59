"""Logger base (a copy of ``tianshou_tpu/utils/logger/base.py``; reference
tianshou/utils/logger/logger_base.py).

``BaseLogger`` (:23) with the four data scopes (training/test/update/info,
``DataScope:16``) and per-scope write intervals (:34-53); ``LazyLogger``
(:165) is the no-op default. ``save_data``/``restore_data`` carry the
checkpoint counters for resume (trainer.py:448 resume_from_log).
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from collections.abc import Callable

__all__ = ["DataScope", "BaseLogger", "CurveLogger", "LazyLogger"]


class DataScope(enum.Enum):
    TRAIN = "train"
    TEST = "test"
    UPDATE = "update"
    INFO = "info"


class BaseLogger(ABC):
    def __init__(
        self,
        train_interval: int = 1000,
        test_interval: int = 1,
        update_interval: int = 1000,
        info_interval: int = 1,
    ) -> None:
        self.train_interval = train_interval
        self.test_interval = test_interval
        self.update_interval = update_interval
        self.info_interval = info_interval
        self.last_log_train_step = -1
        self.last_log_test_step = -1
        self.last_log_update_step = -1
        self.last_log_info_step = -1

    @abstractmethod
    def write(self, step_type: str, step: int, data: dict) -> None: ...

    def log_train_data(self, log_data: dict, step: int) -> None:
        if step - self.last_log_train_step >= self.train_interval:
            self.write("train/env_step", step, log_data)
            self.last_log_train_step = step

    def log_test_data(self, log_data: dict, step: int) -> None:
        if step - self.last_log_test_step >= self.test_interval:
            self.write("test/env_step", step, log_data)
            self.last_log_test_step = step

    def log_update_data(self, log_data: dict, step: int) -> None:
        if step - self.last_log_update_step >= self.update_interval:
            self.write("update/gradient_step", step, log_data)
            self.last_log_update_step = step

    def log_info_data(self, log_data: dict, step: int) -> None:
        if step - self.last_log_info_step >= self.info_interval:
            self.write("info/epoch", step, log_data)
            self.last_log_info_step = step

    def save_data(
        self,
        epoch: int,
        env_step: int,
        gradient_step: int,
        save_checkpoint_fn: Callable | None = None,
    ) -> None:
        """Persist counters (+ checkpoint via callback)."""

    def restore_data(self) -> tuple[int, int, int]:
        """Return (epoch, env_step, gradient_step) from the log dir."""
        return 0, 0, 0


class LazyLogger(BaseLogger):
    """No-op logger (reference logger_base.py:165)."""

    def __init__(self) -> None:
        super().__init__()

    def write(self, step_type: str, step: int, data: dict) -> None:
        pass


class CurveLogger(BaseLogger):
    """In-memory test-return curve recorder.

    Keeps the ``(env_step, test reward)`` pairs of every test write, so that a
    run's learning curve is at hand without a TensorBoard directory.
    """

    def __init__(self) -> None:
        super().__init__(test_interval=1)
        self.curve: list[tuple[int, float]] = []

    def write(self, step_type: str, step: int, data: dict) -> None:
        if step_type == "test/env_step" and "test/reward" in data:
            self.curve.append((int(step), float(data["test/reward"])))
