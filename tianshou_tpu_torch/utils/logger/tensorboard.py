"""TensorBoard logger (port of ``tianshou_tpu/utils/logger/tensorboard.py``;
reference tianshou/utils/logger/tensorboard.py:17) on PyTorch's own
``torch.utils.tensorboard``, which needs only the ``tensorboard`` package and
writes the event files that the JAX package's tensorboardX writer writes, with
the checkpoint counters in a JSON sidecar so that ``restore_data`` does not
parse event files. The writer (and tensorboard, for ``restore_logged_data``) is
imported when it is needed, never when this module is imported."""

from __future__ import annotations

import json
import os
from collections.abc import Callable

from tianshou_tpu_torch.utils.logger.base import BaseLogger

__all__ = ["TensorboardLogger"]


class TensorboardLogger(BaseLogger):
    def __init__(
        self,
        writer=None,
        log_dir: str | None = None,
        train_interval: int = 1000,
        test_interval: int = 1,
        update_interval: int = 1000,
        info_interval: int = 1,
    ) -> None:
        super().__init__(train_interval, test_interval, update_interval, info_interval)
        if writer is None:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(log_dir)
        self.writer = writer
        self.log_dir = log_dir or writer.log_dir
        self._meta_path = os.path.join(self.log_dir, "checkpoint_meta.json")

    def write(self, step_type: str, step: int, data: dict) -> None:
        for k, v in data.items():
            self.writer.add_scalar(k, float(v), global_step=step)
        self.writer.flush()

    def save_data(self, epoch: int, env_step: int, gradient_step: int,
                  save_checkpoint_fn: Callable | None = None) -> None:
        with open(self._meta_path, "w") as f:
            json.dump({"epoch": epoch, "env_step": env_step, "gradient_step": gradient_step}, f)

    def restore_data(self) -> tuple[int, int, int]:
        if not os.path.exists(self._meta_path):
            return 0, 0, 0
        with open(self._meta_path) as f:
            m = json.load(f)
        self.last_log_train_step = m["env_step"]
        self.last_log_update_step = m["gradient_step"]
        return m["epoch"], m["env_step"], m["gradient_step"]

    def restore_logged_data(self) -> dict:
        """Read back scalars from event files (for rliable evaluation)."""
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(self.log_dir)
        acc.Reload()
        out: dict = {}
        for tag in acc.Tags().get("scalars", []):
            out[tag] = [(e.step, e.value) for e in acc.Scalars(tag)]
        return out
